"""Llama decoder for the LLaVA-1.5 stack (counterpart of
``clip_embeds_tpu/models/llama.py``).

RMSNorm, rotate-half RoPE, SwiGLU MLP, optional GQA, causal attention with
per-sample padding masks; teacher-forced forward only (VQAScore is
P(answer | image, question) from the cross-entropy). Module names are the
flax ones (``embed_tokens``, ``model.layers.{i}.self_attn.q_proj``, ...,
``model.norm``, ``lm_head``); projections are ``nn.Linear``-layout
[out, in] weights, or int8 :class:`~.quant.QuantLinear` with ``quant``.

Attention has two modes, as in JAX:

* causal over the whole sequence, through ``ops/attention.py
  dot_product_attention`` (an unmasked bf16 CUDA prefill takes the flash
  kernel; a padding mask keeps plain attention);
* a suffix pass over a cached prefix's per-layer K/V (``prefix_kv``):
  the prefix fully visible, causal within the suffix, optionally
  block-diagonal (``suffix_block``), on plain attention.

JAX sows the post-RoPE, pre-GQA-repeat K/V into the flax ``kv``
collection; the port has no collections, so ``trunk(..., sow_kv=True)``
returns them explicitly beside the hidden states. Not ported: the
``decode`` KV cache, M-RoPE (``mrope_cos_sin``), the LoRA side-path and
the ``scan_layers`` layout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .quant import Quant, linear

KV = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style q/k/v biases
    # Qwen2-VL multimodal RoPE sections; kept for config round trips, not
    # ported (ROADMAP.md queue 1 item 14)
    mrope_section: Optional[Tuple[int, ...]] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def llama_7b_config() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny_config() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_position_embeddings=128,
    )


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        x32 = x32 * torch.rsqrt(var + self.eps)
        return (self.weight.float() * x32).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, N] -> fp32 (cos, sin) [B, N, head_dim] (HF
    rotate-half layout)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * inv_freq  # [B, N, hd/2]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, D]; cos/sin [B, N, D], cast to x's dtype as JAX does."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[:, None].to(x.dtype)
            + rotated * sin[:, None].to(x.dtype))


def _repeat_kv(t: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: each K/V head repeated ``rep`` times in place, head-major
    (``jnp.repeat(t, rep, axis=1)``)."""
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=1)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, quant: Quant = False):
        super().__init__()
        self.cfg = cfg
        hd, d, bias = cfg.head_dim, cfg.hidden_size, cfg.attention_bias
        self.q_proj = linear(quant, d, cfg.num_heads * hd, bias)
        self.k_proj = linear(quant, d, cfg.kv_heads * hd, bias)
        self.v_proj = linear(quant, d, cfg.kv_heads * hd, bias)
        self.o_proj = linear(quant, cfg.num_heads * hd, d, False)

    def forward(self, x, cos, sin, kv_mask=None, prefix: Optional[KV] = None,
                sow_kv: bool = False, prefix_mask=None,
                suffix_block: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[KV]]:
        """Returns (out [B, n, d], the post-RoPE pre-repeat (k, v) in x's
        dtype when ``sow_kv``, else None)."""
        cfg = self.cfg
        b, n, _ = x.shape
        hd, rep = cfg.head_dim, cfg.num_heads // cfg.kv_heads
        q = self.q_proj(x).view(b, n, cfg.num_heads, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, n, cfg.kv_heads, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, n, cfg.kv_heads, hd).transpose(1, 2)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        sown = (k, v) if sow_kv else None

        if prefix is not None:
            # queries: the n suffix tokens; keys/values: the row's prefix
            # K/V (broadcast from batch 1 where it is shared) ++ the suffix's
            pk, pv = (t.expand(b, *t.shape[1:]) for t in prefix)
            p_len = pk.shape[2]
            k_all = _repeat_kv(torch.cat([pk, k], dim=2), rep)
            v_all = _repeat_kv(torch.cat([pv, v], dim=2), rep)
            # [B, 1, n, P+n]: the prefix fully visible, causal within the
            # suffix; block-diagonal causal with suffix_block (candidates
            # concatenated in one row all read the row's prefix K/V)
            i = torch.arange(n, device=x.device)[:, None]
            j = torch.arange(p_len + n, device=x.device)[None, :]
            js = j - p_len
            within = js <= i
            if suffix_block is not None:
                within = within & (js // suffix_block == i // suffix_block)
            mask = (j < p_len) | within
            ok_prefix = (torch.ones(b, p_len, dtype=torch.bool,
                                    device=x.device) if prefix_mask is None
                         else prefix_mask.bool().expand(b, p_len))
            ok_suffix = (torch.ones(b, n, dtype=torch.bool, device=x.device)
                         if kv_mask is None else kv_mask.bool())
            ok = torch.cat([ok_prefix, ok_suffix], dim=1)
            mask = mask[None, None] & ok[:, None, None, :]
            out = dot_product_attention(q, k_all, v_all, causal=False,
                                        mask=mask, impl="reference")
        else:
            mask = None if kv_mask is None else kv_mask[:, None, None, :]
            out = dot_product_attention(q, _repeat_kv(k, rep),
                                        _repeat_kv(v, rep), causal=True,
                                        mask=mask)
        out = out.transpose(1, 2).reshape(b, n, cfg.num_heads * hd)
        return self.o_proj(out), sown


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, quant: Quant = False):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = linear(quant, d, m, False)
        self.up_proj = linear(quant, d, m, False)
        self.down_proj = linear(quant, m, d, False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, quant: Quant = False):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, quant)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg, quant)

    def forward(self, x, cos, sin, kv_mask=None, prefix=None, sow_kv=False,
                prefix_mask=None, suffix_block=None):
        h, sown = self.self_attn(self.input_layernorm(x), cos, sin, kv_mask,
                                 prefix, sow_kv, prefix_mask, suffix_block)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), sown


class LlamaModel(nn.Module):
    """Decoder trunk over input embeddings (LLaVA splices image features
    before it)."""

    def __init__(self, cfg: LlamaConfig, quant: Quant = False):
        super().__init__()
        if cfg.mrope_section is not None:
            raise NotImplementedError(
                "M-RoPE (Qwen2-VL) is not ported yet: ROADMAP.md queue 1 "
                "item 14")
        self.cfg = cfg
        self.layers = nn.ModuleList(LlamaBlock(cfg, quant)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds, attention_mask=None, positions=None,
                prefix_kv: Optional[Sequence[KV]] = None,
                sow_kv: bool = False, prefix_mask=None,
                suffix_block: Optional[int] = None):
        """Hidden states [B, N, D]; with ``sow_kv`` also the per-layer
        post-RoPE, pre-repeat ((k, v), ...), each [B, kv_heads, N, hd]."""
        cfg = self.cfg
        b, n, _ = inputs_embeds.shape
        if positions is None:
            positions = torch.arange(n, device=inputs_embeds.device
                                     ).expand(b, n)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        x = inputs_embeds
        kv: List[KV] = []
        for i, layer in enumerate(self.layers):
            x, sown = layer(x, cos, sin, attention_mask,
                            None if prefix_kv is None else prefix_kv[i],
                            sow_kv, prefix_mask, suffix_block)
            if sow_kv:
                kv.append(sown)
        x = self.norm(x)
        return (x, tuple(kv)) if sow_kv else x


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, quant: Quant = False):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.model = LlamaModel(cfg, quant)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else linear(False, cfg.hidden_size, cfg.vocab_size,
                                    False))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def trunk(self, inputs_embeds, attention_mask=None, positions=None,
              prefix_kv=None, sow_kv=False, prefix_mask=None,
              suffix_block=None):
        return self.model(inputs_embeds, attention_mask, positions,
                          prefix_kv, sow_kv, prefix_mask, suffix_block)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.embed_tokens.weight.to(hidden.dtype).t()
        return self.lm_head(hidden)

    def forward(self, input_ids, attention_mask=None, positions=None):
        return self.logits(self.trunk(self.embed(input_ids), attention_mask,
                                      positions))
