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
  block-diagonal (``suffix_block``), on plain attention;
* the decode KV cache (JAX's ``decode=True``, its flax ``cache``
  collection), passed explicitly: ``trunk(..., cache=KVCache)`` writes the
  chunk's post-RoPE K/V at the cache's write index, in place, and returns
  ``(hidden, cache)`` with the index advanced. A chunk at index 0 without
  a padding mask (the prefill) attends over its own K/V on the causal
  route, so an unmasked bf16 prefill on the card takes the flash kernel;
  JAX runs plain attention over the whole cache there, whose keys past the
  chunk get exactly zero weight, so the function is the same. Any other
  chunk (a decode step) runs plain attention over the filled prefix of
  the cache with the causal-by-absolute-position mask and ``kv_mask``
  (over the cache's slots), as JAX does over all of them.

JAX sows the post-RoPE, pre-GQA-repeat K/V into the flax ``kv``
collection; the port has no collections, so ``trunk(..., sow_kv=True)``
returns them explicitly beside the hidden states. ``lora_rank`` /
``lora_alpha`` build the seven projections a layer with the unmaterialized
LoRA side-path (``models/quant.py``), and ``remat`` recomputes each block
in the backward (``torch.utils.checkpoint``, JAX's ``nn.remat`` per
block; training only). ``positions`` of shape [B, 3, N] (Qwen2-VL's
(t, h, w) ids) take multimodal RoPE (:func:`mrope_cos_sin`) on a model
with ``mrope_section`` and their row 0 on a 1-D RoPE model, as JAX's trunk
dispatches them. Not ported: the ``scan_layers`` layout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import dot_product_attention
from .quant import Quant, linear

KV = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class KVCache:
    """The decode cache of a trunk: per layer ``k[i]`` / ``v[i]`` [B,
    kv_heads, max_len, head_dim] in the model's dtype (JAX's ``cached_k``
    / ``cached_v``), and ``index``, the next slot to write (JAX's
    ``cache_index``; a host int here, so stepping it never waits for the
    device). The trunk writes the tensors in place."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: int = 0

    @classmethod
    def empty(cls, cfg: "LlamaConfig", batch_size: int, max_len: int,
              dtype: torch.dtype, device) -> "KVCache":
        shape = (batch_size, cfg.kv_heads, max_len, cfg.head_dim)
        zeros = [torch.zeros(shape, dtype=dtype, device=device)
                 for _ in range(2 * cfg.num_layers)]
        return cls(zeros[::2], zeros[1::2], 0)

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]


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
    # Qwen2-VL multimodal RoPE: per-axis (t, h, w) channel sections summing
    # to head_dim/2. None -> standard 1D RoPE
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


@functools.lru_cache(maxsize=16)
def mrope_axis_index(section: Tuple[int, ...], head_dim: int,
                     device: str = "cpu") -> torch.Tensor:
    """[head_dim] int64: the axis (0 t, 1 h, 2 w) each channel rotates by,
    ``list(section) * 2`` runs cycling t, h, w; built on the host, as JAX
    builds its one-hot, and kept on ``device`` (a copy from pageable host
    memory would wait for the device at every call). Read-only: callers
    share it."""
    sel = np.concatenate([np.full(s, i % 3) for i, s in
                          enumerate(list(section) * 2)])
    if sel.shape[0] != head_dim:
        raise ValueError(f"mrope_section {tuple(section)} covers "
                         f"{sel.shape[0]} channels, not head_dim {head_dim}")
    return torch.from_numpy(sel).to(device)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  section: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE: positions [B, 3, N] of (t, h, w) -> fp32 (cos, sin)
    [B, N, head_dim], each channel taking the rotation of one axis
    (:func:`mrope_axis_index`). A gather along the axis picks what JAX's
    contraction with its one-hot sums (one term, exactly), with no fp32
    product on the card."""
    index = mrope_axis_index(tuple(section), head_dim, str(positions.device))
    cos, sin = rope_cos_sin(positions, head_dim, theta)  # [B, 3, N, hd]
    b, _, n, _ = cos.shape
    index = index.expand(b, 1, n, head_dim)
    return cos.gather(1, index)[:, 0], sin.gather(1, index)[:, 0]


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
    def __init__(self, cfg: LlamaConfig, quant: Quant = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.cfg = cfg
        hd, d, bias = cfg.head_dim, cfg.hidden_size, cfg.attention_bias
        lo = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.q_proj = linear(quant, d, cfg.num_heads * hd, bias, **lo)
        self.k_proj = linear(quant, d, cfg.kv_heads * hd, bias, **lo)
        self.v_proj = linear(quant, d, cfg.kv_heads * hd, bias, **lo)
        self.o_proj = linear(quant, cfg.num_heads * hd, d, False, **lo)

    def forward(self, x, cos, sin, kv_mask=None, prefix: Optional[KV] = None,
                sow_kv: bool = False, prefix_mask=None,
                suffix_block: Optional[int] = None,
                cache: Optional[Tuple[KV, int]] = None
                ) -> Tuple[torch.Tensor, Optional[KV]]:
        """Returns (out [B, n, d], the post-RoPE pre-repeat (k, v) in x's
        dtype when ``sow_kv``, else None). ``cache``: this layer's
        ((cached_k, cached_v), write index); the chunk's K/V are written
        there in place."""
        cfg = self.cfg
        b, n, _ = x.shape
        hd, rep = cfg.head_dim, cfg.num_heads // cfg.kv_heads
        # the heads this rank holds: all of them, or its share under tensor
        # parallelism (parallel/sharding_rules.py shard_params)
        q = self.q_proj(x).view(b, n, -1, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, n, -1, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, n, -1, hd).transpose(1, 2)
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
        elif cache is not None:
            (ck, cv), idx = cache
            end = idx + n
            if end > ck.shape[2]:
                raise ValueError(f"the KV cache holds {ck.shape[2]} slots; "
                                 f"this chunk needs {end}")
            ck[:, :, idx:end] = k.to(ck.dtype)
            cv[:, :, idx:end] = v.to(cv.dtype)
            if idx == 0 and kv_mask is None:
                # the prefill: the keys past the chunk would get zero weight
                out = dot_product_attention(q, _repeat_kv(k, rep),
                                            _repeat_kv(v, rep), causal=True)
            else:
                # key j visible to query i (absolute position idx + i) iff
                # j <= idx + i, over the filled slots
                j = torch.arange(end, device=x.device)
                mask = (j[None, :] <= idx + torch.arange(
                    n, device=x.device)[:, None])[None, None]
                if kv_mask is not None:
                    mask = mask & kv_mask[:, None, None, :end].bool()
                out = dot_product_attention(
                    q, _repeat_kv(ck[:, :, :end], rep),
                    _repeat_kv(cv[:, :, :end], rep), causal=False,
                    mask=mask, impl="reference")
        else:
            mask = None if kv_mask is None else kv_mask[:, None, None, :]
            out = dot_product_attention(q, _repeat_kv(k, rep),
                                        _repeat_kv(v, rep), causal=True,
                                        mask=mask)
        out = out.transpose(1, 2).reshape(b, n, q.shape[1] * hd)
        return self.o_proj(out), sown


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, quant: Quant = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        lo = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.gate_proj = linear(quant, d, m, False, **lo)
        self.up_proj = linear(quant, d, m, False, **lo)
        self.down_proj = linear(quant, m, d, False, **lo)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, quant: Quant = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, quant, lora_rank, lora_alpha)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg, quant, lora_rank, lora_alpha)

    def forward(self, x, cos, sin, kv_mask=None, prefix=None, sow_kv=False,
                prefix_mask=None, suffix_block=None, cache=None):
        h, sown = self.self_attn(self.input_layernorm(x), cos, sin, kv_mask,
                                 prefix, sow_kv, prefix_mask, suffix_block,
                                 cache)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), sown


class LlamaModel(nn.Module):
    """Decoder trunk over input embeddings (LLaVA splices image features
    before it)."""

    def __init__(self, cfg: LlamaConfig, quant: Quant = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, quant, lora_rank, lora_alpha)
            for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds, attention_mask=None, positions=None,
                prefix_kv: Optional[Sequence[KV]] = None,
                sow_kv: bool = False, prefix_mask=None,
                suffix_block: Optional[int] = None,
                cache: Optional[KVCache] = None):
        """Hidden states [B, N, D]; with ``sow_kv`` also the per-layer
        post-RoPE, pre-repeat ((k, v), ...), each [B, kv_heads, N, hd];
        with ``cache`` also the cache, its index advanced by N (the
        ``attention_mask`` is then over the cache's slots, [B, max_len]).
        ``positions``: [B, N], or [B, 3, N] (t, h, w) ids."""
        cfg = self.cfg
        b, n, _ = inputs_embeds.shape
        if positions is None:
            positions = torch.arange(n, device=inputs_embeds.device
                                     ).expand(b, n)
        if cfg.mrope_section is not None and positions.dim() == 3:
            cos, sin = mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                     cfg.mrope_section)
        else:
            if positions.dim() == 3:  # M-RoPE ids on a 1-D RoPE model
                positions = positions[:, 0]
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        x = inputs_embeds
        kv: List[KV] = []
        remat = self.remat and torch.is_grad_enabled()
        if remat and (prefix_kv is not None or sow_kv or cache is not None):
            raise ValueError("remat is a training feature: no prefix_kv, "
                             "sow_kv or cache under it")
        if cache is not None and (prefix_kv is not None or sow_kv):
            raise ValueError("the decode cache takes no prefix_kv or sow_kv")
        for i, layer in enumerate(self.layers):
            if remat:
                x, sown = torch.utils.checkpoint.checkpoint(
                    layer, x, cos, sin, attention_mask, use_reentrant=False)
                continue
            x, sown = layer(x, cos, sin, attention_mask,
                            None if prefix_kv is None else prefix_kv[i],
                            sow_kv, prefix_mask, suffix_block,
                            None if cache is None else
                            ((cache.k[i], cache.v[i]), cache.index))
            if sow_kv:
                kv.append(sown)
        x = self.norm(x)
        if cache is not None:
            return x, dataclasses.replace(cache, index=cache.index + n)
        return (x, tuple(kv)) if sow_kv else x


class LlamaForCausalLM(nn.Module):
    """``lora_rank`` adapts the trunk's projections only (the reference's
    target set); the embeddings and ``lm_head`` stay frozen."""

    def __init__(self, cfg: LlamaConfig, quant: Quant = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.model = LlamaModel(cfg, quant, lora_rank, lora_alpha, remat)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else linear(False, cfg.hidden_size, cfg.vocab_size,
                                    False))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def trunk(self, inputs_embeds, attention_mask=None, positions=None,
              prefix_kv=None, sow_kv=False, prefix_mask=None,
              suffix_block=None, cache: Optional[KVCache] = None):
        return self.model(inputs_embeds, attention_mask, positions,
                          prefix_kv, sow_kv, prefix_mask, suffix_block, cache)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.embed_tokens.weight.to(hidden.dtype).t()
        return self.lm_head(hidden)

    def forward(self, input_ids, attention_mask=None, positions=None):
        return self.logits(self.trunk(self.embed(input_ids), attention_mask,
                                      positions))
