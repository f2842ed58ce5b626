"""Pre-LN transformer building blocks (counterpart of
``clip_embeds_tpu/models/layers.py``).

Module and parameter names follow open_clip
(``open_clip/transformer.py`` ResidualAttentionBlock), so an open_clip state
dict loads with ``load_state_dict``: ``attn.in_proj_weight`` is [3d, d]
(q, k, v stacked), linear weights are [out, in]. Activations are [B, N, d].
The projections are :class:`~.quant.CastLinear`, or with ``quant``
('dynamic' / 'static') int8 :class:`~.quant.QuantLinear` (the packed
``in_proj`` becomes one [3d, d] QuantLinear, as the JAX ``in_proj``);
attention goes through ``ops.attention.dot_product_attention`` (the flash
kernels for bf16 on the card, plain PyTorch otherwise).

Compute dtype: every block computes in the dtype of the residual stream it
is given. A projection casts its weight to it, a LayerNorm computes in fp32
and returns it, so fp32 master weights train in bf16 with the JAX rounding
points (flax's ``dtype`` over fp32 params). Explicit casts rather than
``torch.autocast``, whose LayerNorm outputs and residual stream stay fp32.
With parameters already in the stream's dtype (serving) every cast is a
no-op and the numbers are unchanged.

:class:`Transformer` picks the block (``block_impl``: 'composable', or the
fused-kernel training blocks 'fused-train' / 'fused-train-res') and the
rematerialisation (``remat``: False, True, 'dots' or 'attn').
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import dot_product_attention
from ..ops.fused_block_ad import BLOCK_PARAMS, make_fused_block_ad
from .quant import Quant, linear

Remat = Union[bool, str]  # False | True | 'dots' | 'attn'


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def get_act(quick: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    return quick_gelu if quick else exact_gelu


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that returns its input's dtype. With parameters of
    another dtype (fp32 masters under bf16 compute) it computes in fp32 and
    rounds once, as flax's ``LayerNorm(dtype=...)``; otherwise it is
    ``nn.LayerNorm`` unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: the kernel and bias
    are cast to it (flax's ``Conv(dtype=...)`` over fp32 params), a no-op
    where the dtypes agree."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def tower_dtype(tower: nn.Module,
                compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype a tower computes in: ``compute_dtype``, else its
    parameters' (serving: the model cast as a whole)."""
    return compute_dtype or next(tower.parameters()).dtype


def run_blocks(blocks: Iterable[nn.Module], x: torch.Tensor, remat: bool,
               *args) -> torch.Tensor:
    """``x`` through ``blocks`` in order, each called as ``block(x,
    *args)``. With ``remat``, while grad is enabled, each block runs under
    non-reentrant ``torch.utils.checkpoint``: JAX's ``nn.remat`` of the
    block, which keeps its input and recomputes the rest in the
    backward."""
    remat = remat and torch.is_grad_enabled()
    for block in blocks:
        x = (checkpoint(block, x, *args, use_reentrant=False) if remat
             else block(x, *args))
    return x


class MultiHeadAttention(nn.Module):
    """Packed-QKV multi-head attention (torch nn.MultiheadAttention names)."""

    def __init__(self, width: int, heads: int, quant: Quant = False):
        super().__init__()
        self.width, self.heads = width, heads
        if quant:
            self.in_proj = linear(quant, width, 3 * width)
        else:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = linear(quant, width, width)

    def forward(self, x: torch.Tensor, causal: bool = False,
                mask: Optional[torch.Tensor] = None,
                impl: str = "auto") -> torch.Tensor:
        """``mask`` (bool, broadcastable to [B, H, n, n], True where a key
        is kept) and ``impl`` go to ``dot_product_attention``."""
        b, n, _ = x.shape
        hd = self.width // self.heads
        if hasattr(self, "in_proj"):
            qkv = self.in_proj(x)
        else:
            qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                           self.in_proj_bias.to(x.dtype))
        # [B, n, 3, H, hd] -> three [B, H, n, hd] views of the packed buffer
        q, k, v = qkv.view(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, k, v, causal=causal, mask=mask,
                                    impl=impl)
        out = out.transpose(1, 2).reshape(b, n, self.width)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, width: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, quant: Quant = False):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.c_fc = linear(quant, width, hidden)
        self.c_proj = linear(quant, hidden, width)
        self.act = get_act(quick_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, quant: Quant = False,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=ln_eps)
        self.attn = MultiHeadAttention(width, heads, quant)
        self.ln_2 = LayerNorm(width, eps=ln_eps)
        self.mlp = MLP(width, mlp_ratio, quick_gelu, quant)

    def forward(self, x: torch.Tensor, causal: bool = False,
                mask: Optional[torch.Tensor] = None,
                impl: str = "auto") -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=causal, mask=mask, impl=impl)
        return x + self.mlp(self.ln_2(x))


class FusedTrainBlock(ResidualAttentionBlock):
    """ResidualAttentionBlock whose forward is the fused-block kernels and
    whose backward is ``ops/fused_block_ad.py`` (the JAX ``FusedTrainBlock``).
    Same parameters and names as the composable block, so state dicts are
    interchangeable; it saves only (x, params), the memory of full per-block
    remat. ``bwd_impl``: 'vjp' (recompute the composable block under
    autograd) or 'residual' (recompute through ``fused_block_residuals`` and
    apply the explicit backward formulas)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, bwd_impl: str = "vjp",
                 ln_eps: float = 1e-5):
        super().__init__(width, heads, mlp_ratio, quick_gelu, ln_eps=ln_eps)
        self.heads, self.bwd_impl = heads, bwd_impl
        self.act_name = "quick" if quick_gelu else "erf"
        self.ln_eps = ln_eps

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        fn = make_fused_block_ad(self.heads, self.act_name, self.ln_eps,
                                 causal, self.bwd_impl)
        params = dict(self.named_parameters())
        return fn.apply(x, *(params[k] for k in BLOCK_PARAMS))


def _dots_policy(ctx, op, *args, **kwargs):
    """'dots': keep the outputs of the 2-D matrix products (the projections;
    jax ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block: ResidualAttentionBlock, x: torch.Tensor,
                 causal: bool, remat: Remat) -> torch.Tensor:
    """One composable block under ``torch.utils.checkpoint`` (non-reentrant).

    True recomputes the whole block in the backward; 'dots' keeps the
    projections' outputs (selective checkpointing); 'attn' keeps the
    attention branch's output, as the JAX ``name_attn_out`` policy saves
    ``attn_out``: the attention branch and the MLP branch are checkpointed
    apart, so what stays resident is x and x + attn(ln_1(x)), and both
    branches recompute."""
    if remat == "attn":
        x = x + checkpoint(lambda h: block.attn(block.ln_1(h), causal=causal),
                           x, use_reentrant=False)
        return x + checkpoint(lambda h: block.mlp(block.ln_2(h)), x,
                              use_reentrant=False)
    if remat == "dots":
        return checkpoint(
            block, x, causal, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    return checkpoint(block, x, causal, use_reentrant=False)


class Transformer(nn.Module):
    """Stack of residual blocks. ``num_blocks`` runs only the first k blocks
    (the LLaVA hidden_states[-2] tap).

    ``block_impl``: 'composable' (:class:`ResidualAttentionBlock`),
    'fused-train' or 'fused-train-res' (:class:`FusedTrainBlock` with the
    'vjp' or 'residual' backward; it saves only (x, params), so ``remat``
    does not apply to it, as in JAX). ``remat`` (composable blocks, while
    grad is enabled): False, True (full), 'dots' or 'attn'. ``ln_eps``: the
    blocks' LayerNorm epsilon (1e-6 in the BLIP and EVA towers)."""

    def __init__(self, width: int, layers: int, heads: int,
                 mlp_ratio: float = 4.0, quick_gelu: bool = False,
                 quant: Quant = False, block_impl: str = "composable",
                 remat: Remat = False, ln_eps: float = 1e-5):
        super().__init__()
        if block_impl not in ("composable", "fused-train", "fused-train-res"):
            raise ValueError(f"block_impl {block_impl!r}")
        if remat not in (False, True, "dots", "attn"):
            raise ValueError(f"remat {remat!r}")
        if block_impl != "composable":
            if quant:
                raise ValueError("the fused training blocks are not quantised")
            bwd = "residual" if block_impl.endswith("-res") else "vjp"
            blocks = (FusedTrainBlock(width, heads, mlp_ratio, quick_gelu, bwd,
                                      ln_eps)
                      for _ in range(layers))
        else:
            blocks = (ResidualAttentionBlock(width, heads, mlp_ratio,
                                             quick_gelu, quant, ln_eps)
                      for _ in range(layers))
        self.resblocks = nn.ModuleList(blocks)
        self.block_impl = block_impl
        self.remat = remat if block_impl == "composable" else False

    def forward(self, x: torch.Tensor, causal: bool = False,
                num_blocks: Optional[int] = None) -> torch.Tensor:
        n = len(self.resblocks) if num_blocks is None else num_blocks
        remat = self.remat and torch.is_grad_enabled()
        for block in self.resblocks[:n]:
            if remat:
                x = _remat_block(block, x, causal, self.remat)
            else:
                x = block(x, causal=causal)
        return x
