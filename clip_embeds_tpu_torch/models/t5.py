"""T5 encoder-decoder for the CLIP-FlanT5 and InstructBLIP VQAScore stacks
(counterpart of ``clip_embeds_tpu/models/t5.py``).

The HF T5 v1.1 / Flan-T5 architecture:

* ``T5LayerNorm``: RMS without mean subtraction and without bias; the
  inverse RMS is cast to the activation dtype before it multiplies;
* unscaled attention (no 1/sqrt(d): it is folded into the init) with a
  bucketed relative position bias, owned by the first self-attention layer
  of each stack and shared down it. The attention is plain PyTorch (fp32
  logits, ``where(mask, logits, -1e9)``, softmax, probabilities cast to
  v's dtype), as JAX computes it outside any kernel: the flash kernel
  takes no additive bias;
* the gated-GELU feed-forward (``wi_0``, ``wi_1``, ``wo``) or the ReLU one
  (``wi``, ``wo``), without biases;
* an untied ``lm_head`` (v1.1), or the tied embedding scaled by
  d_model^-0.5.

Module names are the flax ones (``shared``, ``encoder.block.{i}.self_attn.q``
for ``encoder/block_{i}/self_attn/q``, ``self_ln``, ``cross_ln``,
``cross_attn``, ``ff_ln``, ``ff``, ``final_ln``, ``lm_head``). With
``quant`` ('dynamic' / 'static') the encoder's and decoder's projections
are int8 :class:`~.quant.QuantLinear`; ``shared``, the norms, the relative
bias and ``lm_head`` stay floating point, as in JAX.

The relative-position bucket table is computed on the host in fp32 and
copied to the device once a shape (``bucket_table``), so a card's ``log``
cannot move a position across a bucket edge.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .quant import Quant, linear


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_decoder_layers: Optional[int] = None
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    tie_word_embeddings: bool = False
    feed_forward_proj: str = "gated-gelu"  # or 'relu'

    @property
    def decoder_layers(self) -> int:
        return self.num_decoder_layers or self.num_layers


def t5_tiny_config() -> T5Config:
    return T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_heads=4)


class T5LayerNorm(nn.Module):
    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return x * self.weight.to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5's bucket function on an int tensor of (key - query) offsets.
    fp32 throughout, every quotient by a tensor (a true division), as the
    JAX function computes it."""
    f32 = torch.float32
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(n.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    ratio = n.to(f32) / torch.tensor(float(max_exact), dtype=f32)
    scaled = (torch.log(ratio + torch.tensor(1e-6, dtype=f32))
              / torch.tensor(math.log(max_distance / max_exact), dtype=f32)
              * torch.tensor(float(num_buckets - max_exact), dtype=f32))
    val_if_large = (max_exact + scaled.to(torch.int32)).clamp_max(
        num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large.to(n.dtype))


@functools.lru_cache(maxsize=64)
def bucket_table(nq: int, nk: int, bidirectional: bool, num_buckets: int,
                 max_distance: int, device: str = "cpu") -> torch.Tensor:
    """[nq, nk] int64 buckets of key j against query i, computed on the
    host and kept on ``device`` (a copy from pageable host memory would
    wait for the device at every call). Read-only: callers share it."""
    ctx = (torch.arange(nk, dtype=torch.int64)[None, :]
           - torch.arange(nq, dtype=torch.int64)[:, None])
    return relative_position_bucket(ctx, bidirectional, num_buckets,
                                    max_distance).to(device)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False,
                 bidirectional: bool = True, quant: Quant = False):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        inner = cfg.num_heads * cfg.d_kv
        self.q = linear(quant, cfg.d_model, inner, False)
        self.k = linear(quant, cfg.d_model, inner, False)
        self.v = linear(quant, cfg.d_model, inner, False)
        self.o = linear(quant, inner, cfg.d_model, False)
        self.relative_attention_bias = (
            nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
            if has_relative_bias else None)

    def position_bias(self, nq: int, nk: int, device, dtype) -> torch.Tensor:
        """[1, H, nq, nk] in ``dtype`` (the compute dtype, as flax's
        ``Embed(dtype=...)`` returns it)."""
        cfg = self.cfg
        buckets = bucket_table(nq, nk, self.bidirectional,
                               cfg.relative_attention_num_buckets,
                               cfg.relative_attention_max_distance,
                               str(device))
        bias = self.relative_attention_bias(buckets)
        return bias.to(dtype).permute(2, 0, 1)[None]

    def forward(self, hidden: torch.Tensor,
                kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """hidden [B, Nq, D]; kv [B, Nk, D] for cross-attention; mask bool,
        broadcastable to [B, H, Nq, Nk]; position_bias [1, H, Nq, Nk].
        Returns (out [B, Nq, D], the position bias passed down)."""
        cfg = self.cfg
        kv = hidden if kv is None else kv
        b, nq, _ = hidden.shape
        nk = kv.shape[1]

        def split(t, n):
            return t.view(b, n, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q = split(self.q(hidden), nq)
        k = split(self.k(kv), nk)
        v = split(self.v(kv), nk)
        if position_bias is None and self.relative_attention_bias is not None:
            position_bias = self.position_bias(nq, nk, hidden.device,
                                               hidden.dtype)
        # unscaled; fp32 logits from the compute-dtype q and k
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if position_bias is not None:
            logits = logits + position_bias.float()
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e9)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        del logits
        out = torch.matmul(probs, v).transpose(1, 2).reshape(
            b, nq, cfg.num_heads * cfg.d_kv)
        return self.o(out), position_bias


class T5FeedForward(nn.Module):
    def __init__(self, cfg: T5Config, quant: Quant = False):
        super().__init__()
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = linear(quant, cfg.d_model, cfg.d_ff, False)
            self.wi_1 = linear(quant, cfg.d_model, cfg.d_ff, False)
        else:
            self.wi = linear(quant, cfg.d_model, cfg.d_ff, False)
        self.wo = linear(quant, cfg.d_ff, cfg.d_model, False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool = False,
                 has_relative_bias: bool = False, quant: Quant = False):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.self_ln = T5LayerNorm(cfg.d_model, eps)
        self.self_attn = T5Attention(cfg, has_relative_bias,
                                     bidirectional=not is_decoder,
                                     quant=quant)
        if is_decoder:
            self.cross_ln = T5LayerNorm(cfg.d_model, eps)
            self.cross_attn = T5Attention(cfg, False, quant=quant)
        self.ff_ln = T5LayerNorm(cfg.d_model, eps)
        self.ff = T5FeedForward(cfg, quant)

    def forward(self, x, self_mask, position_bias, encoder_out=None,
                cross_mask=None):
        h, position_bias = self.self_attn(self.self_ln(x), mask=self_mask,
                                          position_bias=position_bias)
        x = x + h
        if hasattr(self, "cross_attn") and encoder_out is not None:
            h, _ = self.cross_attn(self.cross_ln(x), kv=encoder_out,
                                   mask=cross_mask)
            x = x + h
        return x + self.ff(self.ff_ln(x)), position_bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool = False,
                 quant: Quant = False):
        super().__init__()
        self.is_decoder = is_decoder
        layers = cfg.decoder_layers if is_decoder else cfg.num_layers
        self.block = nn.ModuleList(
            T5Block(cfg, is_decoder, has_relative_bias=(i == 0), quant=quant)
            for i in range(layers))
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_out: Optional[torch.Tensor] = None,
                encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """embeds [B, N, D]; attention_mask / encoder_mask bool [B, N] /
        [B, Nk] (True where a token is kept)."""
        n = embeds.shape[1]
        self_mask = None
        if attention_mask is not None:
            self_mask = attention_mask.bool()[:, None, None, :]
        if self.is_decoder:
            causal = torch.ones(n, n, dtype=torch.bool,
                                device=embeds.device).tril()[None, None]
            self_mask = causal if self_mask is None else self_mask & causal
        cross_mask = (None if encoder_mask is None
                      else encoder_mask.bool()[:, None, None, :])
        x, position_bias = embeds, None
        for block in self.block:
            x, position_bias = block(x, self_mask, position_bias,
                                     encoder_out, cross_mask)
        return self.final_ln(x)


class T5ForConditionalGeneration(nn.Module):
    """``quant``: W8A8 encoder and decoder projections; ``lm_head`` stays
    floating point."""

    def __init__(self, cfg: T5Config, quant: Quant = False):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg, is_decoder=False, quant=quant)
        self.decoder = T5Stack(cfg, is_decoder=True, quant=quant)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else linear(False, cfg.d_model, cfg.vocab_size,
                                    False))

    def encode(self, input_ids: Optional[torch.Tensor] = None,
               inputs_embeds: Optional[torch.Tensor] = None,
               attention_mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.shared(input_ids)
        return self.encoder(inputs_embeds, attention_mask)

    def decode(self, decoder_input_ids: torch.Tensor,
               encoder_out: torch.Tensor,
               decoder_attention_mask: Optional[torch.Tensor] = None,
               encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, T, vocab] in the compute dtype."""
        x = self.shared(decoder_input_ids)
        x = self.decoder(x, decoder_attention_mask, encoder_out,
                         encoder_mask)
        if self.lm_head is None:
            x = x * (self.cfg.d_model ** -0.5)
            return x @ self.shared.weight.to(x.dtype).t()
        return self.lm_head(x)

    def forward(self, input_ids: Optional[torch.Tensor],
                decoder_input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                decoder_attention_mask: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        enc = self.encode(input_ids, inputs_embeds, attention_mask)
        return self.decode(decoder_input_ids, enc, decoder_attention_mask,
                           attention_mask)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int = 0,
                pad_id: int = 0) -> torch.Tensor:
    """HF T5._shift_right: prepend the start token, drop the last, and
    replace -100 with ``pad_id``."""
    start = torch.full_like(labels[:, :1], decoder_start_token_id)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id),
                       shifted)
