"""Pre-LN transformer block as hand-written CUDA kernels, for serving.

Counterpart of the Pallas TPU kernel ``clip_embeds_tpu/ops/fused_block.py``
``fused_block`` (``_kernel``):

    x' = x + out_proj(attn(LN1(x) Wqkv + bqkv))
    y  = x' + W2 act(W1 LN2(x') + b1) + b2

The Pallas kernel keeps one block's weights resident in VMEM (~25 MB at
ViT-L), which does not fit in an SM's 227 KB of shared memory. On the card
the block is a chain of seven launches of ``csrc/fused_block.cu``
(LayerNorm, and a GEMM with a bias / bias+act / bias+residual epilogue) and
``csrc/attention.cu`` (attention read straight out of the packed qkv
buffer). The projections are compute-bound GEMMs; fusing LN, bias,
activation and residual into the launches keeps the elementwise passes
out of device memory. Rounding points are the Pallas kernel's: qkv, the
attention output and each projection's ``(dot + bias)`` are rounded to
bf16, the activation is taken in fp32 and then rounded.

TPU-only parts are not ported: the rows-per-program choice, VMEM budgets,
cost estimates, ``interpret``, the k/v zero-padding to ``n_kv`` (the
kernel masks its ragged edge) and the clamped no-max softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_ACTS = {"quick": 0, "erf": 1, "tanh": 2}
_EPI_BIAS, _EPI_ACT, _EPI_RESIDUAL = 0, 1, 2
_KERNEL_HEAD_DIMS = (32, 64, 128)


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _apply_act(m: torch.Tensor, act: str) -> torch.Tensor:
    if act == "quick":
        return m * torch.sigmoid(1.702 * m)
    if act == "tanh":
        return torch.nn.functional.gelu(m, approximate="tanh")
    return torch.nn.functional.gelu(m)


def _linear32(a: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """fp32 (a W^T + b) of bf16/fp32 operands: exact products, fp32 sums."""
    return torch.matmul(a.float(), w.float().t()) + b.float()


def fused_block_reference(
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2, heads: int,
    kv_valid: int, quick_gelu: bool = False, ln_eps: float = 1e-5,
    causal: bool = False, act: Optional[str] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_block`, same arguments."""
    act = act or ("quick" if quick_gelu else "erf")
    dt = x.dtype
    b, n, d = x.shape
    hd = d // heads
    wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = (
        t.to(dt) for t in (wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2))

    h = _ln(x, ln1[0], ln1[1], ln_eps)
    qkv = _linear32(h, wqkv, bqkv).to(dt)
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    col = torch.arange(n, device=x.device)
    keep = (col < kv_valid)[None, :]
    if causal:
        keep = keep & (col[None, :] <= col[:, None])
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    att = torch.matmul(p.to(dt).float(), v.float()) / p.sum(-1, keepdim=True)
    att = att.to(dt).transpose(1, 2).reshape(b, n, d)

    x = x + _linear32(att, wo, bo).to(dt)
    h = _ln(x, ln2[0], ln2[1], ln_eps)
    m = _apply_act(_linear32(h, w1, b1), act).to(dt)
    return x + _linear32(m, w2, b2).to(dt)


def fused_block_supported(n: int, d: int, heads: int,
                          mlp_ratio: float) -> bool:
    """Shapes the CUDA kernels take: GEMM depths and widths that are
    multiples of 32 (``d`` and the MLP width), and a head dim the attention
    kernel is instantiated for."""
    if n < 1 or heads < 1 or d % heads != 0:
        return False
    mlp = int(d * mlp_ratio)
    return (d % 32 == 0 and mlp % 32 == 0
            and d // heads in _KERNEL_HEAD_DIMS)


def _gemm(a, w, bias, res, out, epi: int, act: int) -> None:
    m, k = a.numel() // a.shape[-1], a.shape[-1]
    _build.launch(
        "cet_gemm", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        res.data_ptr() if res is not None else None, out.data_ptr(),
        m, w.shape[0], k, epi, act,
    )


def _layernorm(x, ln, eps: float, out) -> None:
    d = x.shape[-1]
    _build.launch(
        "cet_layernorm", x.data_ptr(), ln.data_ptr(),
        ln.data_ptr() + d * ln.element_size(), out.data_ptr(),
        x.numel() // d, d, eps,
    )


def fused_block(
    x: torch.Tensor,      # [B, n, d]
    wqkv: torch.Tensor,   # [3d, d]  (attn.in_proj_weight, [out, in])
    bqkv: torch.Tensor,   # [3d]
    wo: torch.Tensor,     # [d, d]   (attn.out_proj.weight)
    bo: torch.Tensor,     # [d]
    w1: torch.Tensor,     # [mlp, d] (mlp.c_fc.weight)
    b1: torch.Tensor,     # [mlp]
    w2: torch.Tensor,     # [d, mlp] (mlp.c_proj.weight)
    b2: torch.Tensor,     # [d]
    ln1: torch.Tensor,    # [2, d] (scale, bias)
    ln2: torch.Tensor,    # [2, d]
    heads: int,
    kv_valid: int,
    quick_gelu: bool = False,
    ln_eps: float = 1e-5,
    causal: bool = False,
    act: Optional[str] = None,
) -> torch.Tensor:
    """One pre-LN transformer block; returns [B, n, d].

    Keys at positions >= ``kv_valid`` are masked (and later ones too when
    ``causal``). Weights are in the open_clip ``[out, in]`` layout. CPU
    tensors take :func:`fused_block_reference`; CUDA tensors must be bf16,
    must not require grad (forward only) and must pass
    :func:`fused_block_supported`, and launch the kernels.
    """
    args = (x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2)
    if x.device.type == "cpu":
        return fused_block_reference(*args, heads, kv_valid, quick_gelu,
                                     ln_eps, causal, act)
    act = act or ("quick" if quick_gelu else "erf")
    b, n, d = x.shape
    mlp = w1.shape[0]
    if any(t.dtype != torch.bfloat16 or not t.is_cuda for t in args):
        raise TypeError("fused_block kernels take bf16 CUDA tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("fused_block is forward-only")
    if not fused_block_supported(n, d, heads, mlp / d):
        raise ValueError(f"fused_block kernels do not take n={n} d={d} "
                         f"heads={heads} mlp={mlp}")
    if (wqkv.shape != (3 * d, d) or wo.shape != (d, d)
            or w1.shape != (mlp, d) or w2.shape != (d, mlp)
            or ln1.shape != (2, d) or ln2.shape != (2, d)):
        raise ValueError("fused_block weights must be in [out, in] layout")
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = (
        t.contiguous() for t in args)
    hd = d // heads
    a = _ACTS[act]

    h = torch.empty_like(x)
    _layernorm(x, ln1, ln_eps, h)
    qkv = torch.empty(b, n, 3 * d, dtype=x.dtype, device=x.device)
    _gemm(h, wqkv, bqkv, None, qkv, _EPI_BIAS, a)
    att = torch.empty_like(x)
    step = d * qkv.element_size()
    _build.launch(
        "cet_attention", qkv.data_ptr(), qkv.data_ptr() + step,
        qkv.data_ptr() + 2 * step, att.data_ptr(), b, heads, n, hd,
        kv_valid, int(causal), hd ** -0.5,
        n * 3 * d, hd, 3 * d,      # q/k/v strides: batch, head, row
        n * d, hd, d,              # output strides ([B, n, d])
    )
    x1 = torch.empty_like(x)
    _gemm(att, wo, bo, x, x1, _EPI_RESIDUAL, a)
    _layernorm(x1, ln2, ln_eps, h)
    m = torch.empty(b, n, mlp, dtype=x.dtype, device=x.device)
    _gemm(h, w1, b1, None, m, _EPI_ACT, a)
    y = torch.empty_like(x)
    _gemm(m, w2, b2, x1, y, _EPI_RESIDUAL, a)
    fused_block.launches += 1
    return y


fused_block.launches = 0
