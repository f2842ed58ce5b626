"""BLIP-2 Q-Former retrieval stack, the ITM and ITC heads (counterpart of
``clip_embeds_tpu/models/blip2.py``).

* vision tower: the EVA-style ViT of ``Blip2VisionModel``: a biased
  patchify, no pre-LN, pre-LN blocks at LayerNorm eps 1e-6 (the port's
  composable :class:`~.layers.Transformer`, whose attention takes the
  flash kernel in bf16 on the card: EVA-g is 16 heads of 88), and a
  post-LN;
* Q-Former: post-LN BERT layers over [query tokens; text tokens] with
  image cross-attention on the query slice every
  ``cross_attention_frequency`` layers and separate FFN weights for the
  query slice. Its masked self-attention and cross-attention are plain
  PyTorch (fp32 logits scaled by hd^-0.5, ``where(mask, logits, -1e9)``),
  as in JAX;
* ITM: ``itm_head`` over the query outputs, averaged over the queries
  (2-way logits); ITC: the max over query embeddings of cosine(query, text
  CLS).

Module names are the flax ones (``vision_model.patch_embed``,
``class_embedding``, ``transformer.resblocks.{i}``, ``post_layernorm``;
``qformer.input_ln``, ``qformer.layer.{i}.attention.query`` for
``qformer/layer_{i}/attention/query``, ``ffn_query``, ``ffn``), so
``core/convert.py`` carries a flax tree across by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import VisionConfig
from .layers import LayerNorm, Transformer, exact_gelu
from .quant import linear
from .vit import patchify


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=14, width=1408, layers=39,
            head_width=88, mlp_ratio=6144 / 1408,
        )
    )
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    num_query_tokens: int = 32
    image_text_hidden_size: int = 256


class Blip2VisionTower(nn.Module):
    """[B, S, S, 3] -> the post-LN'd hidden states [B, 1+N, W]."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.width, cfg.patch_size
        self.patch_embed = linear(False, p * p * 3, w)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, w))
        self.transformer = Transformer(w, cfg.layers, cfg.heads,
                                       cfg.mlp_ratio, quick_gelu=False,
                                       ln_eps=1e-6)
        self.post_layernorm = LayerNorm(w, eps=1e-6)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self.class_embedding.dtype
        x = self.patch_embed(patchify(images.to(dtype), self.cfg.patch_size))
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        return self.post_layernorm(self.transformer(x))


class BertSelfAttention(nn.Module):
    """BERT attention (separate query/key/value) with the post-LN output
    block; ``kv_width`` is the width of the keys' source (the image
    tower's for cross-attention)."""

    def __init__(self, hidden_size: int, num_heads: int, ln_eps: float,
                 kv_width: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        kv_width = kv_width or hidden_size
        self.query = linear(False, hidden_size, hidden_size)
        self.key = linear(False, kv_width, hidden_size)
        self.value = linear(False, kv_width, hidden_size)
        self.out_dense = linear(False, hidden_size, hidden_size)
        self.out_ln = LayerNorm(hidden_size, eps=ln_eps)

    def forward(self, hidden: torch.Tensor,
                kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: bool, broadcastable to [B, H, Nq, Nk]."""
        kv = hidden if kv is None else kv
        b, nq, d = hidden.shape
        nk = kv.shape[1]
        hd = d // self.num_heads

        def split(t, n):
            return t.view(b, n, self.num_heads, hd).transpose(1, 2)

        q = split(self.query(hidden), nq)
        k = split(self.key(kv), nk)
        v = split(self.value(kv), nk)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (hd ** -0.5)
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e9)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, nq, d)
        return self.out_ln(self.out_dense(out) + hidden)


class BertFFN(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 ln_eps: float):
        super().__init__()
        self.intermediate = linear(False, hidden_size, intermediate_size)
        self.output = linear(False, intermediate_size, hidden_size)
        self.ln = LayerNorm(hidden_size, eps=ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.output(exact_gelu(self.intermediate(x))) + x)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(d, cfg.num_heads, eps)
        if has_cross_attention:
            self.crossattention = BertSelfAttention(
                d, cfg.num_heads, eps, cfg.encoder_hidden_size)
        self.ffn_query = BertFFN(d, cfg.intermediate_size, eps)
        self.ffn = BertFFN(d, cfg.intermediate_size, eps)

    def forward(self, hidden: torch.Tensor,
                image_embeds: Optional[torch.Tensor],
                self_mask: Optional[torch.Tensor],
                query_length: int) -> torch.Tensor:
        hidden = self.attention(hidden, mask=self_mask)
        if query_length <= 0:
            return self.ffn(hidden)
        query_part = hidden[:, :query_length]
        text_part = hidden[:, query_length:]
        if hasattr(self, "crossattention"):
            query_part = self.crossattention(query_part, kv=image_embeds)
        query_part = self.ffn_query(query_part)
        if text_part.shape[1] == 0:
            return query_part
        return torch.cat([query_part, self.ffn(text_part)], dim=1)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.input_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layer = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0)
            for i in range(cfg.num_layers))

    def forward(self, query_embeds: torch.Tensor,
                image_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                query_length: int = 0) -> torch.Tensor:
        """query_embeds [B, Q(+T), D] before the input LayerNorm;
        attention_mask bool [B, Q+T]."""
        x = self.input_ln(query_embeds)
        self_mask = (None if attention_mask is None
                     else attention_mask.bool()[:, None, None, :])
        for layer in self.layer:
            x = layer(x, image_embeds, self_mask, query_length)
        return x


class QueryEmbeddings(nn.Module):
    """The learned queries and the Q-Former's text embeddings, shared by
    :class:`Blip2ITM` and ``models/instructblip.py`` (flax names
    ``query_tokens``, ``word_embeddings``, ``position_embeddings``)."""

    def __init__(self, cfg: QFormerConfig, num_query_tokens: int):
        super().__init__()
        self.query_tokens = nn.Parameter(
            torch.zeros(num_query_tokens, cfg.hidden_size))
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)

    def queries(self, b: int) -> torch.Tensor:
        return self.query_tokens[None].expand(b, -1, -1)

    def text_embeds(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return (self.word_embeddings(input_ids)
                + self.position_embeddings(pos)[None])

    def with_text(self, image_embeds: torch.Tensor, input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor]):
        """([queries; text] [B, Q+T, D], its mask [B, Q+T])."""
        b, nq = image_embeds.shape[0], self.query_tokens.shape[0]
        hidden = torch.cat([self.queries(b), self.text_embeds(input_ids)],
                           dim=1)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.bool)
        ones = torch.ones(b, nq, dtype=torch.bool, device=input_ids.device)
        return hidden, torch.cat([ones, attention_mask.bool()], dim=1)


class Blip2ITM(QueryEmbeddings):
    """BLIP-2 image-text matching / contrastive retrieval model."""

    def __init__(self, cfg: Blip2Config):
        super().__init__(cfg.qformer, cfg.num_query_tokens)
        self.cfg = cfg
        q = cfg.qformer
        self.vision_model = Blip2VisionTower(cfg.vision)
        self.qformer = QFormer(q)
        self.vision_projection = linear(False, q.hidden_size,
                                        cfg.image_text_hidden_size)
        self.text_projection = linear(False, q.hidden_size,
                                      cfg.image_text_hidden_size)
        self.itm_head = linear(False, q.hidden_size, 2)

    def itm_logits(self, pixel_values: torch.Tensor,
                   input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """2-way match logits [B, 2] for aligned (image, text) rows."""
        image_embeds = self.vision_model(pixel_values)
        hidden, mask = self.with_text(image_embeds, input_ids,
                                      attention_mask)
        nq = self.cfg.num_query_tokens
        out = self.qformer(hidden, image_embeds, mask, query_length=nq)
        return self.itm_head(out[:, :nq]).mean(dim=1)

    def itc_embeds(self, pixel_values: Optional[torch.Tensor] = None,
                   input_ids: Optional[torch.Tensor] = None,
                   attention_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(image query embeds [B, Q, E], text CLS embeds [B, E]), each
        L2-normalised."""
        image_out = text_out = None
        if pixel_values is not None:
            image_embeds = self.vision_model(pixel_values)
            nq = self.cfg.num_query_tokens
            out = self.qformer(self.queries(image_embeds.shape[0]),
                               image_embeds, None, query_length=nq)
            proj = self.vision_projection(out)
            image_out = proj / proj.norm(dim=-1, keepdim=True)
        if input_ids is not None:
            mask = (torch.ones_like(input_ids, dtype=torch.bool)
                    if attention_mask is None else attention_mask.bool())
            out = self.qformer(self.text_embeds(input_ids), None, mask,
                               query_length=0)
            proj = self.text_projection(out[:, 0])
            text_out = proj / proj.norm(dim=-1, keepdim=True)
        return image_out, text_out

    def itc_logits(self, pixel_values: torch.Tensor,
                   input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """logits_per_image [B_img, B_txt]: the max over queries of the
        cosine."""
        image_out, text_out = self.itc_embeds(pixel_values, input_ids,
                                              attention_mask)
        return torch.einsum("bqe,te->bqt", image_out, text_out).amax(dim=1)
