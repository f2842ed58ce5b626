"""Fused attention on [B, H, N, D], differentiable: CUDA kernels on the card,
plain PyTorch on the CPU.

Replaces the Pallas TPU kernel ``clip_embeds_tpu/ops/flash_attention.py``
``flash_attention``: its forward (``_attn_kernel``) and its custom-VJP
backward (``_attn_bwd_kernel``). At ViT-L (N = 577, D = 64) both are bound
by the tensor cores (4 and 10 N^2 D FLOPs per head on 4 and 8 N D bf16
values of IO), so both are written for Hopper's: tiles arrive by TMA in a
ring of shared-memory stages on mbarriers, every product is a ``wgmma``,
and logits, probabilities and accumulators stay in registers. The forward
kernel is ``csrc/attention.cu``: one block of two warpgroups per (b*h,
128-row Q tile), online-max softmax over 64-key tiles, fp32 logits, P
rounded to bf16 for P.V, fp32 accumulation; when a gradient is needed it
also writes each row's fp32 log-sum-exp. The backward is
``csrc/attention_bwd.cu``: dQ per 64-row Q tile (its prologue also takes
delta = rowsum(dO * O)), then dK/dV per 64-key tile, with P recomputed from
(q, k) and that log-sum-exp, in two launches with no atomics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_KERNEL_D = (32, 64, 128)  # head dims the backward is instantiated for
_TILE = 64                 # rows of the backward kernels' tiles
NEG_INF = -1e30            # the Pallas kernels' mask value


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """Plain version of the forward kernel: exact row softmax, fp32 logits
    and sums, unnormalised P rounded to the input dtype for P.V (as the
    Pallas ``_attn_kernel``). q, k, v: [B, H, N, D]."""
    n = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel, as the Pallas
    ``_attn_bwd_kernel`` computes: normalised fp32 P recomputed from
    (q, k), with fully masked rows zeroed; dV = P^T dO; dP = dO V^T;
    delta = rowsum(dO * O); dS = P (dP - delta) scale; dQ = dS K,
    dK = dS^T Q. P and dS are rounded to the input dtype before their
    products, every sum is fp32. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    dt = v.dtype
    n, d = q.shape[-2:]
    scale = d ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    s = torch.where(keep, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(keep, p / p.sum(-1, keepdim=True), 0.0)
    do32 = do.to(dt).float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check(name: str, *ts: torch.Tensor) -> int:
    """Shape and type checks shared by the kernels; returns the
    backward's head dim (D padded up to 32, 64 or 128). The forward kernel
    takes any multiple of 8 up to 128 as it is."""
    if ts[0].dim() != 4 or any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{name}: q, k, v (and o, dO) must share a "
                         f"[B, H, N, D] shape: {[t.shape for t in ts]}")
    if any(t.dtype != torch.bfloat16 or not t.is_cuda for t in ts):
        raise TypeError(f"{name} kernel takes bf16 CUDA tensors")
    d = ts[0].shape[-1]
    if d > _KERNEL_D[-1]:
        raise ValueError(f"{name}: head dim {d} > {_KERNEL_D[-1]}")
    return next(x for x in _KERNEL_D if x >= d)


def _qkv_for_kernel(dk: int, *ts: torch.Tensor):
    """q, k, v as the kernels read them: zero columns up to the head dim
    ``dk`` (they change neither q.k nor the kept outputs), and one shared
    aligned stride."""
    d = ts[0].shape[-1]
    if dk != d:
        ts = tuple(F.pad(t, (0, dk - d)) for t in ts)
    if not (all(t.stride() == ts[0].stride() for t in ts)
            and all(_aligned(t) for t in ts)):
        ts = tuple(t.contiguous() for t in ts)
    return ts


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, with_lse: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel, at the head dim D itself where it
    is a multiple of 8 (the kernel's tensor maps end at D columns; TMA
    rows need 16 bytes, so any other D is padded up to the next one);
    returns (out, fp32 lse [B*H, N] or None)."""
    _check("flash_attention", q, k, v)
    b, h, n, d = q.shape
    dk = -(-d // 8) * 8
    q, k, v = _qkv_for_kernel(dk, q, k, v)
    out = torch.empty(b, h, n, dk, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b * h, n, dtype=torch.float32, device=q.device)
           if with_lse else None)
    _build.launch(
        "cet_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None, b, h, n, dk, n,
        int(causal), d ** -0.5, *q.stride()[:3], *out.stride()[:3],
    )
    flash_attention.launches += 1
    return (out if dk == d else out[..., :d]), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: Optional[torch.Tensor], causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention on [B, H, N, D] given its output ``o``,
    the output gradient ``do`` and the forward's fp32 log-sum-exp ``lse``
    [B*H, N].

    CPU tensors take :func:`flash_attention_bwd_reference` (``lse`` is not
    needed there). CUDA tensors must be bf16 and launch the kernels, which
    read all five inputs through their strides."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, do, causal)
    dk = _check("flash_attention_bwd", q, k, v, o, do)
    b, h, n, d = q.shape
    if (lse is None or lse.dtype != torch.float32 or not lse.is_cuda
            or lse.shape != (b * h, n) or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd needs the forward's fp32 "
                         "log-sum-exp, contiguous [B*H, N]")
    q, k, v = _qkv_for_kernel(dk, q, k, v)
    o, do = (F.pad(t, (0, dk - d)) if dk != d else t for t in (o, do))
    o, do = (t if _aligned(t) else t.contiguous() for t in (o, do))
    dq, dkk, dv = (torch.empty(b, h, n, dk, dtype=q.dtype, device=q.device)
                   for _ in range(3))
    # the kernels' fp32 scratch: lse and delta = rowsum(dO * O) of each
    # 64-row tile, written by the dQ launch for the dK/dV one
    scratch = torch.empty(b * h, 2 * _TILE * -(-n // _TILE),
                          dtype=torch.float32, device=q.device)
    _build.launch(
        "cet_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
        dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(), b, h, n, dk, n,
        int(causal), d ** -0.5, *q.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3],
    )
    flash_attention_bwd.launches += 1
    if dk != d:
        dq, dkk, dv = dq[..., :d], dkk[..., :d], dv[..., :d]
    return dq, dkk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the kernels' backward (the JAX custom VJP's
    ``_fwd``/``_bwd``). Saves (q, k, v, o) and, on the card, the fp32
    log-sum-exp; CPU tensors run the plain forward and backward through
    the same wiring."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal), None
        else:
            o, lse = _flash_forward(q, k, v, causal, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention on [B, H, N, D] with D <= 128; returns [B, H, N, D].

    With grad enabled and an input that requires grad it is
    :class:`FlashAttentionFunction`, whose backward is the backward kernel.
    CPU tensors take the plain versions. CUDA tensors must be bf16; the
    kernels read q, k and v through their strides (so views of a packed
    qkv buffer cost no copy).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    return _flash_forward(q, k, v, causal, with_lse=False)[0]


flash_attention.launches = 0
