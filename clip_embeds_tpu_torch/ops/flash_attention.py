"""Fused attention forward on [B, H, N, D]: CUDA kernel on the card, plain
PyTorch on the CPU.

Replaces the Pallas TPU kernel ``clip_embeds_tpu/ops/flash_attention.py``
``flash_attention`` (forward, ``_attn_kernel``). The kernel is
``csrc/attention.cu``: one block per (b*h, 64-row Q tile), online-max
softmax over 64-key tiles, fp32 logits, P rounded to bf16 for P.V, fp32
accumulation. At ViT-L (N = 577, D = 64) it is compute-bound (4*N*N*D FLOPs
per head on 4*N*D*2 bytes); the logits stay in shared memory. Forward only:
the backward kernel belongs to the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_KERNEL_D = (32, 64, 128)  # head dims the kernel is instantiated for


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """Plain version of the kernel: exact row softmax, fp32 logits and sums,
    unnormalised P rounded to the input dtype for P.V (as the Pallas
    ``_attn_kernel``). q, k, v: [B, H, N, D]."""
    n = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def _aligned(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention on [B, H, N, D] with D <= 128; returns [B, H, N, D].

    CPU tensors take the plain version. CUDA tensors must be bf16 and
    must not require grad; they launch the kernel, which reads q, k and v
    through their strides (so views of a packed qkv buffer cost no copy).
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share a [B, H, N, D] shape: "
                         f"{q.shape}, {k.shape}, {v.shape}")
    if any(t.dtype != torch.bfloat16 or not t.is_cuda for t in (q, k, v)):
        raise TypeError("flash_attention kernel takes bf16 CUDA tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward-only on CUDA")
    b, h, n, d = q.shape
    if d > _KERNEL_D[-1]:
        raise ValueError(f"head dim {d} > {_KERNEL_D[-1]}")
    dk = next(x for x in _KERNEL_D if x >= d)
    if dk != d:  # zero columns change neither q.k nor the kept outputs
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    if not (q.stride() == k.stride() == v.stride()
            and all(_aligned(t) for t in (q, k, v))):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty(b, h, n, dk, dtype=q.dtype, device=q.device)
    _build.launch(
        "cet_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, n, dk, n, int(causal), d ** -0.5,
        *q.stride()[:3], *out.stride()[:3],
    )
    flash_attention.launches += 1
    return out if dk == d else out[..., :d]


flash_attention.launches = 0
