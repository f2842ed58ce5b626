"""Encoder-LM text towers for CLIP, open_clip's HFTextEncoder role
(counterpart of ``clip_embeds_tpu/models/hf_text.py``).

* :class:`BertTextTower`: post-LN BERT / RoBERTa / XLM-R (the roberta-*
  configs).
* :class:`T5TextTower`: the T5 / mT5 encoder (the mt5-* configs), the
  port's ``models/t5.py`` stack.
* :class:`M2M100TextTower`: the NLLB (M2M100) encoder with its sinusoidal
  positions (the nllb-clip-* configs).

Each is a ``transformer`` (the HF encoder) and a ``proj``: a pooled token
(the masked mean, or the first token) through open_clip's projection (an
MLP ``proj.0`` / ``proj.2`` without biases, or one bias-free Linear). Module
names are open_clip's ``text.transformer.*`` (HF's own) and ``text.proj*``,
so an open_clip checkpoint's text tower loads with ``load_state_dict``;
the T5 tower maps HF's names to the port's T5 stack and back by two hooks.
Attention is plain: the towers take a key mask (JAX's gate keeps masked
attention off its kernel, and the port's keeps it off #4).

As in JAX, the BERT tower's positions are 0..n-1 and it has no token-type
embedding; HF's RoBERTa counts positions from padding_idx + 1 and adds
token type 0's row. The port computes JAX's function, and its load drops
the ``token_type_embeddings``, ``position_ids`` and ``pooler`` entries of
an HF checkpoint (ROADMAP.md queue 3 lists the difference).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .t5 import T5Config, T5Stack
from .timm_vit import merge_heads


def mean_pool(hidden: torch.Tensor, mask: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """Masked mean over tokens (open_clip MeanPooler)."""
    if mask is None:
        return hidden.mean(dim=1)
    m = mask.to(hidden.dtype)[..., None]
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)


def _pool(x: torch.Tensor, mask, pooler: str) -> torch.Tensor:
    return x[:, 0] if pooler == "first" else mean_pool(x, mask)


def _masked_attention(q, k, v, mask, fill: float, scale: float = 1.0
                      ) -> torch.Tensor:
    """fp32 logits times ``scale``; keys where ``mask`` ([B, Nk]) is False
    set to ``fill``; the probabilities cast to v's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask.bool()[:, None, None, :], fill)
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.view(b, n, heads, d // heads).transpose(1, 2)


class MLPProj(nn.Sequential):
    """hidden -> (hidden + embed) // 2 -> embed, GELU between, no biases
    (open_clip's proj 'mlp': ``proj.0`` and ``proj.2``)."""

    def __init__(self, hidden: int, embed_dim: int):
        mid = (hidden + embed_dim) // 2
        super().__init__(nn.Linear(hidden, mid, bias=False), nn.GELU(),
                         nn.Linear(mid, embed_dim, bias=False))


# -- BERT / RoBERTa ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BertTextConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5


class _DenseLN(nn.Module):
    def __init__(self, din: int, dout: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(din, dout)
        self.LayerNorm = nn.LayerNorm(dout, eps=eps)


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.dense = nn.Linear(din, dout)


class _BertSelf(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _BertAttention(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.self = _BertSelf(d)
        self.output = _DenseLN(d, d, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        s = self.self
        q, k, v = (_heads(m(x), self.heads) for m in (s.query, s.key,
                                                       s.value))
        o = merge_heads(_masked_attention(q, k, v, mask, -1e9,
                                          q.shape[-1] ** -0.5))
        return self.output.LayerNorm(self.output.dense(o) + x)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.attention = _BertAttention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _DenseLN(cfg.intermediate_size, cfg.hidden_size,
                               cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        x = self.attention(x, mask)
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(self.output.dense(h) + x)


class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _BertEncoder(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BertModel(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.embeddings = _BertEmbeddings(cfg)
        self.encoder = _BertEncoder(cfg)
        self._register_load_state_dict_pre_hook(_drop_bert_extras,
                                                with_module=True)

    def forward(self, ids: torch.Tensor, mask) -> torch.Tensor:
        e = self.embeddings
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = e.word_embeddings(ids) + e.position_embeddings(pos)[None]
        x = e.LayerNorm(x)
        for layer in self.encoder.layer:
            x = layer(x, mask)
        return x


def _drop_bert_extras(module, state_dict, prefix, *args) -> None:
    for key in [k for k in state_dict if k.startswith(prefix) and (
            k[len(prefix):] in ("embeddings.token_type_embeddings.weight",
                                "embeddings.position_ids")
            or k[len(prefix):].startswith("pooler."))]:
        del state_dict[key]


class BertTextTower(nn.Module):
    def __init__(self, cfg: BertTextConfig, embed_dim: int,
                 pooler: str = "mean"):
        super().__init__()
        self.cfg, self.pooler = cfg, pooler
        self.transformer = BertModel(cfg)
        self.proj = MLPProj(cfg.hidden_size, embed_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.transformer(input_ids, attention_mask)
        return self.proj(_pool(x, attention_mask, self.pooler))


# -- T5 / mT5 ----------------------------------------------------------------

# (HF key, the port's T5Stack key), as regular expressions both ways
_T5_NAMES: Sequence[Tuple[str, str]] = (
    (r"block\.(\d+)\.layer\.0\.layer_norm\.", r"block.\1.self_ln."),
    (r"block\.(\d+)\.layer\.0\.SelfAttention\.", r"block.\1.self_attn."),
    (r"block\.(\d+)\.layer\.1\.layer_norm\.", r"block.\1.ff_ln."),
    (r"block\.(\d+)\.layer\.1\.DenseReluDense\.", r"block.\1.ff."),
    (r"final_layer_norm\.", r"final_ln."),
)


class T5Encoder(nn.Module):
    """HF's T5 encoder stack as open_clip keeps it (``embed_tokens``,
    ``block.{i}.layer.{0,1}.*``, ``final_layer_norm``) over the port's
    :class:`~.t5.T5Stack`."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.stack = T5Stack(cfg, is_decoder=False)
        self._register_load_state_dict_pre_hook(
            lambda m, sd, prefix, *a: _t5_from_hf(sd, prefix),
            with_module=True)
        self._register_state_dict_hook(
            lambda m, sd, prefix, meta: _t5_to_hf(sd, prefix))

    def forward(self, ids: torch.Tensor, mask) -> torch.Tensor:
        return self.stack(self.embed_tokens(ids), mask)


def _t5_from_hf(state_dict, prefix: str) -> None:
    for key in [k for k in state_dict if k.startswith(prefix)]:
        rest = key[len(prefix):]
        if rest.startswith(("embed_tokens.", "stack.")):
            continue
        for theirs, ours in _T5_NAMES:
            new = re.sub("^" + theirs, ours, rest)
            if new != rest:
                state_dict[prefix + "stack." + new] = state_dict.pop(key)
                break


def _t5_to_hf(state_dict, prefix: str) -> None:
    back = [(ours.replace(r"\1", r"(\d+)").replace(".", r"\."),
             theirs.replace(r"(\d+)", r"\1").replace(r"\.", "."))
            for theirs, ours in _T5_NAMES]
    head = prefix + "stack."
    for key in [k for k in state_dict if k.startswith(head)]:
        rest = key[len(head):]
        for src, dst in back:
            new = re.sub("^" + src, dst, rest)
            if new != rest:
                state_dict[prefix + new] = state_dict.pop(key)
                break


class T5TextTower(nn.Module):
    def __init__(self, cfg: T5Config, embed_dim: int, pooler: str = "mean"):
        super().__init__()
        self.cfg, self.pooler = cfg, pooler
        self.transformer = T5Encoder(cfg)
        self.proj = MLPProj(cfg.d_model, embed_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.transformer(input_ids, attention_mask)
        return self.proj(_pool(x, attention_mask, self.pooler))


# -- M2M100 / NLLB -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class M2M100Config:
    """NLLB / M2M100 encoder shapes (HF facebook/nllb-200-* configs)."""

    vocab_size: int = 256206
    d_model: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5


def m2m100_sinusoids(num: int, dim: int) -> torch.Tensor:
    """fairseq's sinusoidal table (HF M2M100SinusoidalPositionalEmbedding:
    the sines then the cosines, not interleaved), fp32."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32)
                     * (-math.log(10000.0) / (half - 1)))
    ang = torch.arange(num, dtype=torch.float32)[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if dim % 2 == 1:
        emb = torch.cat([emb, torch.zeros(num, 1)], dim=1)
    return emb


class _M2MAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        q = _heads(self.q_proj(x), self.heads)
        q = q * (q.shape[-1] ** -0.5)
        k, v = _heads(self.k_proj(x), self.heads), \
            _heads(self.v_proj(x), self.heads)
        o = merge_heads(_masked_attention(q, k, v, mask, float("-inf")))
        return self.out_proj(o)


class M2M100Layer(nn.Module):
    def __init__(self, cfg: M2M100Config):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.self_attn = _M2MAttention(d, cfg.num_heads)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask)
        return x + self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))


class M2M100Encoder(nn.Module):
    def __init__(self, cfg: M2M100Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(M2M100Layer(cfg)
                                    for _ in range(cfg.num_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self._register_load_state_dict_pre_hook(
            lambda m, sd, prefix, *a: sd.pop(prefix + "embed_positions"
                                             ".weights", None),
            with_module=True)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        """Positions count the non-pad tokens from ``pad_token_id`` + 1 (a
        pad stays at ``pad_token_id``), as HF's
        create_position_ids_from_input_ids."""
        cfg = self.cfg
        dt = self.embed_tokens.weight.dtype
        x = self.embed_tokens(ids) * torch.tensor(cfg.d_model ** 0.5,
                                                  dtype=dt)
        m = mask.long()
        pos = torch.cumsum(m, dim=1) * m + cfg.pad_token_id
        table = m2m100_sinusoids(cfg.max_position_embeddings + 2,
                                 cfg.d_model).to(x.device, dt)
        x = x + table[pos]
        for layer in self.layers:
            x = layer(x, mask)
        return self.layer_norm(x)


class M2M100TextTower(nn.Module):
    """The NLLB encoder, the first token's state (open_clip cls_pooler)
    and a bias-free ``proj``."""

    def __init__(self, cfg: M2M100Config, embed_dim: int,
                 pooler: str = "first"):
        super().__init__()
        self.cfg, self.pooler = cfg, pooler
        self.transformer = M2M100Encoder(cfg)
        self.proj = nn.Linear(cfg.d_model, embed_dim, bias=False)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = input_ids != self.cfg.pad_token_id
        x = self.transformer(input_ids, attention_mask)
        return self.proj(_pool(x, attention_mask, self.pooler))
