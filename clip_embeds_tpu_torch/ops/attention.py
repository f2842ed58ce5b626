"""Attention dispatch: the CUDA flash kernel on the card, plain PyTorch
elsewhere (counterpart of ``clip_embeds_tpu/ops/attention.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention. q, k, v: [B, H, N, D]; mask: bool, broadcastable to
    [B, H, Nq, Nk], True where a key is kept. fp32 logits and softmax; the
    probabilities are cast to v's dtype before P.V."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        nq, nk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(nq, nk, dtype=torch.bool,
                          device=q.device).tril(nk - nq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def flash_eligible(q: torch.Tensor, mask: Optional[torch.Tensor] = None
                   ) -> bool:
    """The 'auto' gate for the flash kernels: the JAX package's gates (no
    mask, D <= 128, N >= 128) with "on the TPU" read as "a bf16 CUDA
    tensor" (the kernels are bf16; with grad, the backward kernel runs).
    So, as in JAX, the 77-token text tower takes plain attention and the
    577-token vision tower the kernels. Routing follows the inputs, never a
    failure."""
    return (
        q.is_cuda
        and q.dtype == torch.bfloat16
        and mask is None
        and q.shape[-1] <= 128
        and q.shape[-2] >= 128
    )


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head attention on [B, H, N, D] tensors.

    impl: 'auto' (the flash kernel where :func:`flash_eligible`), 'flash',
    or 'reference'.
    """
    if impl == "flash" or (impl == "auto" and flash_eligible(q, mask)):
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    return reference_attention(q, k, v, causal=causal, mask=mask)
