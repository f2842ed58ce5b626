"""Differentiable fused block for training (counterpart of
``clip_embeds_tpu/ops/fused_block_ad.py``).

:func:`make_fused_block_ad` returns a ``torch.autograd.Function`` whose

  forward  is :func:`~.fused_block.fused_block` (the block's kernel chain on
           the card) and saves only (x, params), what full per-block remat
           keeps;
  backward is either 'vjp': ``torch.autograd.grad`` of :func:`block_reference`
           (the composable block, whose attention takes the flash kernels'
           forward and backward on the card), or 'residual': one
           :func:`~.fused_block.fused_block_residuals` recompute that hands
           the backward qkv, the attention output, the pre-activation MLP
           hidden and the post-attention residual, then the explicit formulas
           below; its attention gradient is the flash backward kernel, fed
           the log-sum-exp of the recompute's attention launch.

The JAX wrapper ties each block's recompute to the incoming cotangent with
``jax.lax.optimization_barrier``: XLA would otherwise hoist every block's
recompute to the start of the backward pass and keep all their
intermediates live at once. Eager PyTorch runs each backward when its
gradient arrives, so the recomputes already happen one block at a time and
no barrier is needed.

Parameters arrive in the block's own dtype (fp32 masters in training) and
are cast to x's dtype for the computation; gradients come back in the
parameters' dtype.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from .attention import dot_product_attention, flash_eligible
from .flash_attention import flash_attention_bwd
from .fused_block import (
    _apply_act,
    _fused_block_residuals,
    _ln,
    fused_block,
)

# the ResidualAttentionBlock parameter names, in the order the Function
# takes them after x
BLOCK_PARAMS = (
    "ln_1.weight", "ln_1.bias",
    "attn.in_proj_weight", "attn.in_proj_bias",
    "attn.out_proj.weight", "attn.out_proj.bias",
    "ln_2.weight", "ln_2.bias",
    "mlp.c_fc.weight", "mlp.c_fc.bias",
    "mlp.c_proj.weight", "mlp.c_proj.bias",
)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.linear(x, w.to(x.dtype), b.to(x.dtype))


def _split_heads(qkv: torch.Tensor, heads: int):
    """Packed [B, n, 3d] -> three [B, H, n, hd] views."""
    b, n, d3 = qkv.shape
    return qkv.view(b, n, 3, heads, d3 // (3 * heads)).permute(2, 0, 3, 1, 4)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = o.shape
    return o.transpose(1, 2).reshape(b, n, h * hd)


def block_reference(x: torch.Tensor, p: Dict[str, torch.Tensor], heads: int,
                    act: str, ln_eps: float = 1e-5,
                    causal: bool = False) -> torch.Tensor:
    """The composable pre-LN block as a function of (x, params) (the JAX
    ``block_reference``): LN -> packed qkv -> attention -> out-proj +
    residual -> LN -> MLP + residual, computed in x's dtype. ``p`` maps the
    :data:`BLOCK_PARAMS` names to tensors."""
    h = _ln(x, p["ln_1.weight"], p["ln_1.bias"], ln_eps)
    qkv = _dense(h, p["attn.in_proj_weight"], p["attn.in_proj_bias"])
    o = dot_product_attention(*_split_heads(qkv, heads), causal=causal)
    x = x + _dense(_merge_heads(o), p["attn.out_proj.weight"],
                   p["attn.out_proj.bias"])
    h = _ln(x, p["ln_2.weight"], p["ln_2.bias"], ln_eps)
    h = _apply_act(_dense(h, p["mlp.c_fc.weight"], p["mlp.c_fc.bias"]), act)
    return x + _dense(h, p["mlp.c_proj.weight"], p["mlp.c_proj.bias"])


def _block_args(x: torch.Tensor, p: Dict[str, torch.Tensor]):
    """The fused kernels' arguments in x's dtype."""
    dt = x.dtype
    return (x, *(p[k].to(dt) for k in (
        "attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
        "attn.out_proj.bias", "mlp.c_fc.weight", "mlp.c_fc.bias",
        "mlp.c_proj.weight", "mlp.c_proj.bias")),
        torch.stack([p["ln_1.weight"], p["ln_1.bias"]]).to(dt),
        torch.stack([p["ln_2.weight"], p["ln_2.bias"]]).to(dt))


def _bwd_vjp(x, p, g, heads, act, ln_eps, causal, needs):
    """Gradients of :func:`block_reference` at (x, p) against g."""
    with torch.enable_grad():
        xs = [x, *(p[k] for k in BLOCK_PARAMS)]
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip(xs, needs)]
        y = block_reference(leaves[0], dict(zip(BLOCK_PARAMS, leaves[1:])),
                            heads, act, ln_eps, causal)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(y, wanted, g))
    return [next(grads) if need else None for need in needs]


def _attention_grad(qkv, att, lse, d_att, heads: int, causal: bool):
    """d(attention)/d(qkv) at the recompute's qkv: the flash backward
    kernel where the recompute wrote a log-sum-exp (:func:`flash_eligible`:
    bf16 on the card, N >= 128), else autograd through the plain attention,
    as the JAX wrapper's ``attn_piece`` vjp routes."""
    q, k, v = _split_heads(qkv, heads)
    if lse is not None:
        b, n, d = att.shape
        view = lambda t: t.view(b, n, heads, d // heads).transpose(1, 2)
        grads = flash_attention_bwd(q, k, v, view(att), view(d_att), lse,
                                    causal)
        return torch.cat([_merge_heads(t) for t in grads], dim=-1)
    with torch.enable_grad():
        qkv_ = qkv.detach().requires_grad_()
        o = dot_product_attention(*_split_heads(qkv_, heads), causal=causal)
        (d_qkv,) = torch.autograd.grad(_merge_heads(o), qkv_, d_att)
    return d_qkv


def _bwd_residual(x, p, g, heads, act, ln_eps, causal):
    """The JAX ``bwd_residual`` formulas, fed by one fused_block_residuals
    recompute. Weights are [out, in] (the JAX kernels transposed)."""
    dt = x.dtype
    b, n, d = x.shape
    args = _block_args(x, p)
    # the log-sum-exp only where the attention gradient takes the kernel
    # (q has x's device, dtype, N and head dim)
    _, qkv, att, m1, x_mid, lse = _fused_block_residuals(
        args, heads, n, ln_eps=ln_eps, causal=causal, act=act,
        with_lse=flash_eligible(x.view(b, n, heads, d // heads)
                                .transpose(1, 2)))
    w_qkv, w_o, w_1, w_2 = args[1], args[3], args[5], args[7]

    with torch.enable_grad():
        # MLP half: y = x_mid + c_proj(act(m1)), m1 = c_fc(ln_2(x_mid))
        xm, s2, b2 = (t.detach().requires_grad_() for t in (
            x_mid, p["ln_2.weight"], p["ln_2.bias"]))
        h2 = _ln(xm, s2, b2, ln_eps)
        m1_ = m1.detach().requires_grad_()
        m1act = _apply_act(m1_.float(), act).to(dt)
        d_m1act = g @ w_2
        d_w2 = torch.einsum("bnd,bnm->dm", g, m1act.detach())
        d_b2 = g.sum((0, 1))
        (d_m1,) = torch.autograd.grad(m1act, m1_, d_m1act)
        d_w1 = torch.einsum("bnm,bnd->md", d_m1, h2.detach())
        d_b1 = d_m1.sum((0, 1))
        d_h2 = d_m1 @ w_1
        d_xmid_ln, d_ln2s, d_ln2b = torch.autograd.grad(h2, (xm, s2, b2),
                                                        d_h2)
        d_xmid = g + d_xmid_ln

        # attention half: x_mid = x + out_proj(att)
        d_att = d_xmid @ w_o
        d_wo = torch.einsum("bnd,bne->de", d_xmid, att)
        d_bo = d_xmid.sum((0, 1))
        d_qkv = _attention_grad(qkv, att, lse, d_att, heads, causal)

        x_, s1, b1 = (t.detach().requires_grad_() for t in (
            x, p["ln_1.weight"], p["ln_1.bias"]))
        h1 = _ln(x_, s1, b1, ln_eps)
        d_wqkv = torch.einsum("bne,bnd->ed", d_qkv, h1.detach())
        d_bqkv = d_qkv.sum((0, 1))
        d_h1 = d_qkv @ w_qkv
        d_x_ln, d_ln1s, d_ln1b = torch.autograd.grad(h1, (x_, s1, b1), d_h1)
    d_x = d_xmid + d_x_ln
    grads = dict(zip(BLOCK_PARAMS, (
        d_ln1s, d_ln1b, d_wqkv, d_bqkv, d_wo, d_bo, d_ln2s, d_ln2b,
        d_w1, d_b1, d_w2, d_b2)))
    # the gradients flow back through the parameters' casts to x's dtype
    return [d_x] + [grads[k].to(p[k].dtype) for k in BLOCK_PARAMS]


@functools.lru_cache(maxsize=None)
def make_fused_block_ad(heads: int, act_name: str, ln_eps: float,
                        causal: bool, bwd_impl: str = "vjp"):
    """The differentiable fused block for one static configuration: a
    ``torch.autograd.Function`` applied as ``fn.apply(x, *params)``, params
    in :data:`BLOCK_PARAMS` order; x [B, n, d] in the compute dtype."""
    if bwd_impl not in ("vjp", "residual"):
        raise ValueError(f"bwd_impl {bwd_impl!r}")

    class FusedBlockAD(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, *params):
            ctx.save_for_backward(x, *params)
            p = dict(zip(BLOCK_PARAMS, params))
            return fused_block(*_block_args(x, p), heads=heads,
                               kv_valid=x.shape[1], ln_eps=ln_eps,
                               causal=causal, act=act_name)

        @staticmethod
        def backward(ctx, g):
            x, *params = ctx.saved_tensors
            p = dict(zip(BLOCK_PARAMS, params))
            g = g.contiguous()
            if bwd_impl == "residual":
                grads = _bwd_residual(x, p, g, heads, act_name, ln_eps,
                                      causal)
                return tuple(gr if need else None for gr, need in
                             zip(grads, ctx.needs_input_grad))
            return tuple(_bwd_vjp(x, p, g, heads, act_name, ln_eps, causal,
                                  ctx.needs_input_grad))

    FusedBlockAD.__name__ = f"FusedBlockAD_{bwd_impl}"
    return FusedBlockAD
