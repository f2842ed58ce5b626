"""CoCa, the contrastive captioner (counterpart of
``clip_embeds_tpu/models/coca.py``; open_clip's ``coca_model.py``).

* vision: the ViT trunk (``models/layers.py Transformer``, attention on
  the 'auto' route, so the flash kernels for bf16 on the card) ->
  :class:`AttentionalPooler` (learned queries over the tower's rows) ->
  ``ln_post`` -> the first query, projected, is the latent; the other
  queries are the image tokens the decoder reads;
* text: the CLS token appended at the END, the causal mask plus the CLS
  row's pad mask (open_clip's ``build_cls_mask``), on plain attention as
  JAX has it; the latent is the CLS row through ``ln_final`` and the
  projection, the other rows feed the decoder un-normed;
* decoder: per layer a causal self-attention block, then a
  :class:`CrossAttentionBlock` over the image tokens; ``ln_final`` and a
  projection to the vocabulary. Plain attention, as JAX's.

Module and parameter names are open_clip's (``visual.conv1``,
``visual.attn_pool.attn.q_proj_weight``, ``text.cls_emb``,
``text_decoder.cross_attn.{i}.attn.in_proj_weight``, ...), so an open_clip
CoCa state dict loads with ``load_state_dict``. The pooler keeps open_clip's
separate q/k/v weights (``nn.MultiheadAttention`` with ``kdim`` != the
query width, the case of every registry config; JAX's converter reads
those keys). ``compute_dtype`` (default: the parameters' dtype) is the
dtype the towers compute in, so fp32 master weights train in bf16, as
``models/clip.py CLIP``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TextConfig, VisionConfig
from ..ops.attention import reference_attention
from .clip import l2_normalize
from .layers import MLP, LayerNorm, ResidualAttentionBlock, Transformer
from .vit import patch_weight, patchify


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    context_length: int = 76
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0


@dataclasses.dataclass(frozen=True)
class CoCaConfig:
    embed_dim: int = 512
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=32, width=768, layers=12
        )
    )
    text: TextConfig = dataclasses.field(
        default_factory=lambda: TextConfig(context_length=76)
    )
    multimodal: MultimodalConfig = dataclasses.field(
        default_factory=MultimodalConfig
    )
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592
    pad_id: int = 0


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, n, W] -> [B, heads, n, W / heads]."""
    b, n, w = t.shape
    return t.view(b, n, heads, w // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[B, heads, n, hd] -> [B, n, heads * hd]."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


class PoolerAttention(nn.Module):
    """``nn.MultiheadAttention(d_model, n_head, kdim=vdim=context_dim)``'s
    parameters (q/k/v weights apart, one packed bias) on plain attention."""

    def __init__(self, d_model: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj_weight = nn.Parameter(torch.empty(d_model, d_model))
        self.k_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.v_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor
                ) -> torch.Tensor:
        dt = kv_in.dtype
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        q = F.linear(q_in, self.q_proj_weight.to(dt), bq)
        k = F.linear(kv_in, self.k_proj_weight.to(dt), bk)
        v = F.linear(kv_in, self.v_proj_weight.to(dt), bv)
        q = _heads(q.expand(kv_in.shape[0], -1, -1), self.heads)
        out = reference_attention(q, _heads(k, self.heads),
                                  _heads(v, self.heads))
        return F.linear(_merge(out), self.out_proj.weight.to(dt),
                        self.out_proj.bias.to(dt))


class AttentionalPooler(nn.Module):
    """Learned-query cross attention (open_clip transformer.py:190-210):
    ``n_queries`` queries of width ``d_model`` over the tower's rows."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8,
                 n_queries: int = 256):
        super().__init__()
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.attn = PoolerAttention(d_model, context_dim, n_head)
        self.ln_q = LayerNorm(d_model)
        self.ln_k = LayerNorm(context_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln_k(x)
        q = self.ln_q(self.query.to(x.dtype))
        return self.attn(q[None], x)


class CoCaVisionTower(nn.Module):
    def __init__(self, cfg: CoCaConfig,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        v = cfg.vision
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.conv1 = nn.Conv2d(3, v.width, kernel_size=v.patch_size,
                               stride=v.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(v.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(v.num_patches + 1, v.width))
        self.ln_pre = LayerNorm(v.width)
        self.transformer = Transformer(v.width, v.layers, v.heads,
                                       v.mlp_ratio, cfg.quick_gelu)
        self.attn_pool = AttentionalPooler(
            cfg.embed_dim, v.width, cfg.attn_pooler_heads,
            cfg.attn_pooler_queries)
        self.ln_post = LayerNorm(cfg.embed_dim)
        self.proj = nn.Parameter(torch.empty(cfg.embed_dim, cfg.embed_dim))

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S, S, 3] -> (latent [B, E], image tokens [B, Q - 1, E])."""
        dt = self.compute_dtype or self.class_embedding.dtype
        x = patchify(images.to(dt), self.cfg.vision.patch_size)
        x = torch.matmul(x, patch_weight(self.conv1.weight).to(dt).t())
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(self.attn_pool(x))
        return x[:, 0] @ self.proj.to(dt), x[:, 1:]


def text_attention_mask(text_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """bool [B, 1, L+1, L+1]: causal, and the appended CLS row (the last)
    also blind to pad keys; the first key stays visible to it (open_clip's
    ``build_cls_mask``)."""
    b, n = text_ids.shape[0], text_ids.shape[1] + 1
    causal = torch.ones(n, n, dtype=torch.bool,
                        device=text_ids.device).tril()
    cls_row = torch.cat([torch.ones(b, 1, dtype=torch.bool,
                                    device=text_ids.device),
                         text_ids != pad_id], dim=1)
    mask = causal.expand(b, n, n).clone()
    mask[:, -1] &= cls_row
    return mask[:, None]


class CoCaTextTower(nn.Module):
    def __init__(self, cfg: CoCaConfig,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        t = cfg.text
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(t.context_length + 1, t.width))
        self.cls_emb = nn.Parameter(torch.empty(t.width))
        self.transformer = Transformer(t.width, t.layers, t.heads,
                                       t.mlp_ratio, cfg.quick_gelu)
        self.ln_final = LayerNorm(t.width)
        self.text_projection = nn.Parameter(
            torch.empty(t.width, cfg.embed_dim))

    def forward(self, text_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """int [B, L] -> (latent [B, E], token embeddings [B, L, W],
        un-normed)."""
        dt = self.compute_dtype or self.text_projection.dtype
        b, n = text_ids.shape
        x = self.token_embedding(text_ids).to(dt)
        x = torch.cat([x, self.cls_emb.to(dt).expand(b, 1, -1)], dim=1)
        x = x + self.positional_embedding[: n + 1].to(dt)
        mask = text_attention_mask(text_ids, self.cfg.pad_id)
        for block in self.transformer.resblocks:
            x = block(x, mask=mask, impl="reference")
        pooled = self.ln_final(x[:, -1])
        return pooled @ self.text_projection.to(dt), x[:, :-1]


class CrossAttention(nn.Module):
    """The packed ``in_proj`` of ``nn.MultiheadAttention`` with q taken
    from the text stream and k/v from the image tokens."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        dt = x.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        q = _heads(F.linear(x, wq, bq), self.heads)
        k = _heads(F.linear(context, wk, bk), self.heads)
        v = _heads(F.linear(context, wv, bv), self.heads)
        out = _merge(reference_attention(q, k, v))
        return F.linear(out, self.out_proj.weight.to(dt),
                        self.out_proj.bias.to(dt))


class CrossAttentionBlock(nn.Module):
    """Pre-LN residual block with cross attention (open_clip's
    ``ResidualAttentionBlock(is_cross_attention=True)``: ``ln_1`` on the
    queries, ``ln_1_kv`` on the keys and values)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.ln_1_kv = LayerNorm(width)
        self.attn = CrossAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_ratio, quick_gelu)

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), self.ln_1_kv(context.to(x.dtype)))
        return x + self.mlp(self.ln_2(x))


class MultimodalDecoder(nn.Module):
    """Interleaved causal self-attention and image cross-attention blocks
    -> vocabulary logits."""

    def __init__(self, cfg: CoCaConfig):
        super().__init__()
        m = cfg.multimodal
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(m.width, m.heads, m.mlp_ratio,
                                   cfg.quick_gelu) for _ in range(m.layers))
        self.cross_attn = nn.ModuleList(
            CrossAttentionBlock(m.width, m.heads, m.mlp_ratio,
                                cfg.quick_gelu) for _ in range(m.layers))
        self.ln_final = LayerNorm(m.width)
        self.text_projection = nn.Parameter(
            torch.empty(m.width, cfg.text.vocab_size))

    def forward(self, image_embs: torch.Tensor, text_embs: torch.Tensor
                ) -> torch.Tensor:
        x = text_embs
        for block, cross in zip(self.resblocks, self.cross_attn):
            x = block(x, causal=True, impl="reference")
            x = cross(x, image_embs)
        return self.ln_final(x) @ self.text_projection.to(x.dtype)


class CoCa(nn.Module):
    def __init__(self, cfg: CoCaConfig,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.visual = CoCaVisionTower(cfg, compute_dtype)
        self.text = CoCaTextTower(cfg, compute_dtype)
        self.text_decoder = MultimodalDecoder(cfg)
        self.logit_scale = nn.Parameter(
            torch.tensor(float(cfg.init_logit_scale)))

    def encode_image(self, images: torch.Tensor, normalize: bool = True
                     ) -> torch.Tensor:
        latent, _ = self.visual(images)
        return l2_normalize(latent) if normalize else latent

    def encode_text(self, text_ids: torch.Tensor, normalize: bool = True
                    ) -> torch.Tensor:
        latent, _ = self.text(text_ids)
        return l2_normalize(latent) if normalize else latent

    def image_tokens(self, images: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latent, image tokens): the image encoded once for generation."""
        return self.visual(images)

    def caption_logits(self, image_embs: torch.Tensor,
                       text_ids: torch.Tensor) -> torch.Tensor:
        """Decoder logits [B, L, vocab] over a fixed text buffer (causal:
        the slots past the current length change nothing before them)."""
        _, token_embs = self.text(text_ids)
        return self.text_decoder(image_embs, token_embs)

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor,
                output_labels: bool = True) -> Dict[str, torch.Tensor]:
        """The contrastive latents and the teacher-forced caption logits
        (open_clip coca_model.py:251-286): the decoder reads the text's
        first L - 1 token embeddings, the labels are ``text_ids[:, 1:]``."""
        image_latent, image_embs = self.visual(images)
        text_latent, token_embs = self.text(text_ids)
        if output_labels:
            token_embs = token_embs[:, :-1]
        out = {
            "image_features": l2_normalize(image_latent),
            "text_features": l2_normalize(text_latent),
            "logits": self.text_decoder(image_embs, token_embs),
            "logit_scale": self.logit_scale.exp(),
        }
        if output_labels:
            out["labels"] = text_ids[:, 1:]
        return out
