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

:func:`fused_block_residuals` is the training variant (the Pallas
``fused_block_residuals``, ``_kernel_res``): the same chain, returning
``(y, qkv, att, m1, x_mid)``. The chain writes qkv, the attention output
and ``x_mid`` to device memory between launches anyway, so they are
returned instead of dropped; the c_fc launch takes an epilogue that also
stores the pre-activation ``m1`` (the fp32 ``dot + bias`` rounded to bf16).

:func:`fused_block_int8` is the W8A8 block (``fused_block_int8``,
``_kernel_int8``, ``_qdot``): int8 weights with fp32 per-output-channel
scales and fp32 biases, activations quantised with four static fp32 scales
(qkv, out, fc, proj), exact int8 x int8 -> int32 products dequantised to
fp32; attention stays bf16. On the card it is a chain of eight launches of
``csrc/fused_block_int8.cu`` (int8 ``wgmma`` GEMMs on a TMA ring, whose
plain version is :func:`gemm_s8_reference`) and ``csrc/attention.cu``.

TPU-only parts are not ported: the rows-per-program choice, VMEM budgets,
cost estimates, ``interpret``, the k/v zero-padding to ``n_kv`` (the
kernel masks its ragged edge) and the clamped no-max softmax.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_ACTS = {"quick": 0, "erf": 1, "tanh": 2}
_EPI_BIAS, _EPI_ACT, _EPI_RESIDUAL, _EPI_ACT_PRE = 0, 1, 2, 3
# csrc/fused_block_int8.cu epilogues
_EPI_Q_BF16, _EPI_Q_ACT_Q8, _EPI_Q_RESIDUAL = 0, 1, 2
_MAX_HEAD_DIM = 128  # csrc/attention.cu: any multiple of 8 up to it


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


def _attention_reference(qkv: torch.Tensor, heads: int, kv_valid: int,
                         causal: bool) -> torch.Tensor:
    """Per-head attention over the packed qkv [B, n, 3d]; returns [B, n, d]
    in qkv's dtype (fp32 logits and sums, P rounded to that dtype)."""
    dt = qkv.dtype
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    col = torch.arange(n, device=qkv.device)
    keep = (col < kv_valid)[None, :]
    if causal:
        keep = keep & (col[None, :] <= col[:, None])
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    att = torch.matmul(p.to(dt).float(), v.float()) / p.sum(-1, keepdim=True)
    return att.to(dt).transpose(1, 2).reshape(b, n, d)


def fused_block_residuals_reference(
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2, heads: int,
    kv_valid: int, quick_gelu: bool = False, ln_eps: float = 1e-5,
    causal: bool = False, act: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`fused_block_residuals`, same
    arguments: (y, qkv, att, m1, x_mid), all in x's dtype."""
    act = act or ("quick" if quick_gelu else "erf")
    dt = x.dtype
    wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = (
        t.to(dt) for t in (wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2))

    h = _ln(x, ln1[0], ln1[1], ln_eps)
    qkv = gemm_reference(h, wqkv, bqkv, None, _EPI_BIAS, act)
    att = _attention_reference(qkv, heads, kv_valid, causal)
    x_mid = gemm_reference(att, wo, bo, x, _EPI_RESIDUAL, act)
    h = _ln(x_mid, ln2[0], ln2[1], ln_eps)
    m, m1 = gemm_reference(h, w1, b1, None, _EPI_ACT, act, pre=True)
    y = gemm_reference(m, w2, b2, x_mid, _EPI_RESIDUAL, act)
    return y, qkv, att, m1, x_mid


def fused_block_reference(
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2, heads: int,
    kv_valid: int, quick_gelu: bool = False, ln_eps: float = 1e-5,
    causal: bool = False, act: Optional[str] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_block`, same arguments."""
    return fused_block_residuals_reference(
        x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2, heads, kv_valid,
        quick_gelu, ln_eps, causal, act)[0]


def qdot(x32: torch.Tensor, a_scale: torch.Tensor, wq: torch.Tensor,
         scale: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """W8A8 product (the Pallas ``_qdot``): fp32 activations -> int8 codes
    ``clip(round(x / a), -127, 127)`` (true division, round half to even)
    -> exact int8 x int8 sums -> ``acc * (a * scale) + bias`` in fp32.

    ``wq`` is int8 [out, in]; ``a_scale`` a 0-d fp32 tensor (no host
    sync). The sums go through a float64 matmul of the int8 values, exact
    on any device (|sum| <= 127^2 * in < 2^53)."""
    xq = torch.clamp(torch.round(x32 / a_scale), -127, 127)
    acc = torch.matmul(xq.double(), wq.double().t()).float()
    y = acc * (a_scale * scale.float())
    return y if bias is None else y + bias.float()


def fused_block_int8_reference(
    x, wqkv_q, sqkv, bqkv, wo_q, so, bo, w1_q, s1, b1, w2_q, s2, b2,
    ln1, ln2, act_scales, heads: int, kv_valid: int,
    quick_gelu: bool = False, ln_eps: float = 1e-5, causal: bool = False,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_block_int8`, same arguments."""
    act = act or ("quick" if quick_gelu else "erf")
    dt = x.dtype
    a = act_scales.float()
    ln1, ln2 = ln1.to(dt), ln2.to(dt)

    h32 = _ln(x, ln1[0], ln1[1], ln_eps).float()
    qkv = qdot(h32, a[0], wqkv_q, sqkv, bqkv).to(dt)
    att = _attention_reference(qkv, heads, kv_valid, causal)
    x = x + qdot(att.float(), a[1], wo_q, so, bo).to(dt)
    h32 = _ln(x, ln2[0], ln2[1], ln_eps).float()
    # the activation is quantised from fp32, without a round to dt
    m = _apply_act(qdot(h32, a[2], w1_q, s1, b1), act)
    return x + qdot(m, a[3], w2_q, s2, b2).to(dt)


def fused_block_supported(n: int, d: int, heads: int, mlp_ratio: float,
                          int8: bool = False) -> bool:
    """Shapes the CUDA kernels take: ``d`` and the MLP width, the K and N
    of the GEMMs, in whole 16-byte TMA rows: multiples of 8 for
    ``cet_gemm`` (bf16), of 16 with ``int8`` (``cet_gemm_s8``: int8 codes,
    the fc launch's int8 output too); and a head dim that is a multiple of
    8 up to 128 (``cet_attention``). LayerNorm takes any width."""
    if n < 1 or heads < 1 or d % heads != 0:
        return False
    mlp = int(d * mlp_ratio)
    hd = d // heads
    step = 16 if int8 else 8
    return (d % step == 0 and mlp % step == 0
            and hd % 8 == 0 and hd <= _MAX_HEAD_DIM)


def gemm_reference(a, w, bias, res, epi: int, act: str, pre: bool = False):
    """Plain PyTorch version of one :func:`_gemm` launch, in a's dtype:
    ``bf16(a W^T + bias)`` from fp32 sums (``_EPI_BIAS``), the activation
    taken in fp32 first (``_EPI_ACT``), or ``res`` plus the rounded sum
    (``_EPI_RESIDUAL``). With ``pre`` it returns ``(out, bf16(a W^T +
    bias))``, the pre-activation that ``_gemm``'s ``pre`` receives."""
    v = _linear32(a, w, bias)
    dt = a.dtype
    if epi == _EPI_ACT:
        out = _apply_act(v, act).to(dt)
    elif epi == _EPI_RESIDUAL:
        out = res + v.to(dt)
    else:
        out = v.to(dt)
    return (out, v.to(dt)) if pre else out


def _gemm(a, w, bias, res, out, epi: int, act: str, pre=None) -> None:
    """cet_gemm: ``out`` = the epilogue ``epi`` of ``a W^T + bias`` (see
    :func:`gemm_reference`); with a ``pre`` tensor (``_EPI_ACT`` only) it
    also stores the pre-activation there. The kernel reads ``a`` and ``w``
    by TMA and stores 16-byte rows, so every operand must be contiguous
    and 16-byte aligned, with K and N multiples of 8."""
    m, k = a.numel() // a.shape[-1], a.shape[-1]
    n = w.shape[0]
    if pre is not None:
        if epi != _EPI_ACT:
            raise ValueError("cet_gemm stores a pre-activation only with "
                             "the activation epilogue")
        epi = _EPI_ACT_PRE
    rows = [t for t in (a, w, res, out, pre) if t is not None]
    if k % 8 or n % 8:
        raise ValueError(f"cet_gemm needs K and N multiples of 8 (TMA's "
                         f"16-byte rows), not K={k} N={n}")
    if not all(t.is_contiguous() for t in (*rows, bias)):
        raise ValueError("cet_gemm takes contiguous operands")
    if any(t.data_ptr() % 16 for t in rows):  # the bias is read by element
        raise ValueError("cet_gemm takes 16-byte aligned operands")
    _build.launch(
        "cet_gemm", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        res.data_ptr() if res is not None else None, out.data_ptr(),
        pre.data_ptr() if pre is not None else None,
        m, n, k, epi, _ACTS[act],
    )


def _attention(qkv, out, heads: int, kv_valid: int, causal: bool,
               lse=None) -> None:
    """cet_attention straight out of the packed [B, n, 3d] qkv buffer;
    with ``lse`` (fp32 [B*heads, n]) it also stores the log-sum-exp the
    attention backward reads."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    step = d * qkv.element_size()
    _build.launch(
        "cet_attention", qkv.data_ptr(), qkv.data_ptr() + step,
        qkv.data_ptr() + 2 * step, out.data_ptr(),
        lse.data_ptr() if lse is not None else None, b, heads, n, hd,
        kv_valid, int(causal), hd ** -0.5,
        n * d3, hd, d3,            # q/k/v strides: batch, head, row
        n * d, hd, d,              # output strides ([B, n, d])
    )


def _layernorm(x, ln, eps: float, out) -> None:
    d = x.shape[-1]
    _build.launch(
        "cet_layernorm", x.data_ptr(), ln.data_ptr(),
        ln.data_ptr() + d * ln.element_size(), out.data_ptr(),
        x.numel() // d, d, eps,
    )


def _check_block(name: str, args, heads: int) -> Tuple[int, int, int, int]:
    """The bf16 block kernels' input checks; returns (b, n, d, mlp)."""
    x, wqkv, _, wo, _, w1, _, w2, _, ln1, ln2 = args
    b, n, d = x.shape
    mlp = w1.shape[0]
    if any(t.dtype != torch.bfloat16 or not t.is_cuda for t in args):
        raise TypeError(f"{name} kernels take bf16 CUDA tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(f"{name} is forward-only")
    if not fused_block_supported(n, d, heads, mlp / d):
        raise ValueError(f"{name} kernels do not take n={n} d={d} "
                         f"heads={heads} mlp={mlp}")
    if (wqkv.shape != (3 * d, d) or wo.shape != (d, d)
            or w1.shape != (mlp, d) or w2.shape != (d, mlp)
            or ln1.shape != (2, d) or ln2.shape != (2, d)):
        raise ValueError(f"{name} weights must be in [out, in] layout")
    return b, n, d, mlp


def _block_chain(args, heads: int, kv_valid: int, ln_eps: float,
                 causal: bool, act: str, residuals: bool, lse=None):
    """The seven launches of one block; returns (y, qkv, att, m1, x_mid),
    with m1 None unless ``residuals``."""
    b, n, d, mlp = _check_block(
        "fused_block_residuals" if residuals else "fused_block", args, heads)
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = (
        t.contiguous() for t in args)

    h = torch.empty_like(x)
    _layernorm(x, ln1, ln_eps, h)
    qkv = torch.empty(b, n, 3 * d, dtype=x.dtype, device=x.device)
    _gemm(h, wqkv, bqkv, None, qkv, _EPI_BIAS, act)
    att = torch.empty_like(x)
    _attention(qkv, att, heads, kv_valid, causal, lse)
    x1 = torch.empty_like(x)
    _gemm(att, wo, bo, x, x1, _EPI_RESIDUAL, act)
    _layernorm(x1, ln2, ln_eps, h)
    m = torch.empty(b, n, mlp, dtype=x.dtype, device=x.device)
    m1 = torch.empty_like(m) if residuals else None
    _gemm(h, w1, b1, None, m, _EPI_ACT, act, m1)
    y = torch.empty_like(x)
    _gemm(m, w2, b2, x1, y, _EPI_RESIDUAL, act)
    return y, qkv, att, m1, x1


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
    y = _block_chain(args, heads, kv_valid, ln_eps, causal, act, False)[0]
    fused_block.launches += 1
    return y


fused_block.launches = 0


def fused_block_residuals(
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2, heads: int,
    kv_valid: int, quick_gelu: bool = False, ln_eps: float = 1e-5,
    causal: bool = False, act: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """:func:`fused_block` that also returns the backward's inputs:
    ``(y, qkv [B, n, 3d], att [B, n, d], m1 [B, n, mlp], x_mid [B, n, d])``,
    m1 the pre-activation MLP hidden (fp32 ``dot + bias`` rounded to x's
    dtype) and x_mid the residual stream after attention. Same arguments
    and the same checks as :func:`fused_block`; CPU tensors take
    :func:`fused_block_residuals_reference`."""
    return _fused_block_residuals(
        (x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2), heads, kv_valid,
        quick_gelu, ln_eps, causal, act)[:5]


def _fused_block_residuals(args, heads: int, kv_valid: int,
                           quick_gelu: bool = False, ln_eps: float = 1e-5,
                           causal: bool = False, act: Optional[str] = None,
                           with_lse: bool = False):
    """:func:`fused_block_residuals` plus, on the card with ``with_lse``,
    the attention launch's fp32 log-sum-exp [B*heads, n] (else None), which
    the residual backward hands to the attention backward kernel."""
    x = args[0]
    if x.device.type == "cpu":
        return (*fused_block_residuals_reference(
            *args, heads, kv_valid, quick_gelu, ln_eps, causal, act), None)
    act = act or ("quick" if quick_gelu else "erf")
    b, n = x.shape[:2]
    lse = (torch.empty(b * heads, n, dtype=torch.float32, device=x.device)
           if with_lse else None)
    out = _block_chain(args, heads, kv_valid, ln_eps, causal, act, True, lse)
    fused_block_residuals.launches += 1
    return (*out, lse)


fused_block_residuals.launches = 0


def gemm_s8_reference(a_q, w_q, wscale, bias, act_scales, a_idx: int, res,
                      epi: int, act: str) -> torch.Tensor:
    """Plain PyTorch version of one :func:`_gemm_s8` launch, from ``qdot``'s
    pieces: int8 codes ``a_q`` [..., K] and ``w_q`` [N, K], exact sums,
    ``v = acc * (a * wscale) + bias`` in fp32 with ``a =
    act_scales[a_idx]``, then ``bf16(v)`` (``_EPI_Q_BF16``), ``res +
    bf16(v)`` (``_EPI_Q_RESIDUAL``, res bf16), or the int8 codes of
    ``act(v)`` at the next scale ``act_scales[a_idx + 1]``
    (``_EPI_Q_ACT_Q8``). The products and sums go through float64, exact
    on any device (|sum| <= 127^2 * K < 2^53)."""
    acc = torch.matmul(a_q.double(), w_q.double().t()).float()
    v = acc * (act_scales[a_idx].float() * wscale.float()) + bias.float()
    if epi == _EPI_Q_ACT_Q8:
        q = torch.round(_apply_act(v, act) / act_scales[a_idx + 1].float())
        return torch.clamp(q, -127, 127).to(torch.int8)
    if epi == _EPI_Q_RESIDUAL:
        return res + v.to(res.dtype)
    return v.to(torch.bfloat16)


def _gemm_s8(a, w, scale, bias, act_scales, a_idx: int, res, out, epi: int,
             act: int) -> None:
    """cet_gemm_s8: ``out`` = the epilogue ``epi`` of the int8 product
    ``a W^T`` (see :func:`gemm_s8_reference`). The kernel reads ``a``,
    ``w`` and ``res`` and writes ``out`` by TMA in 16-byte rows, so those
    must be contiguous with 16-byte aligned bases, K a multiple of 16, and
    N of 16 for int8 output (8 for bf16); the scales and biases are read
    by element."""
    m, k = a.numel() // a.shape[-1], a.shape[-1]
    n = w.shape[0]
    rows = [t for t in (a, w, res, out) if t is not None]
    n_step = 16 if epi == _EPI_Q_ACT_Q8 else 8
    if k % 16 or n % n_step:
        raise ValueError(f"cet_gemm_s8 needs K a multiple of 16 and N of "
                         f"{n_step} (TMA's 16-byte rows), not K={k} N={n}")
    if not all(t.is_contiguous() for t in (*rows, scale, bias, act_scales)):
        raise ValueError("cet_gemm_s8 takes contiguous operands")
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError("cet_gemm_s8 takes 16-byte aligned operands")
    _build.launch(
        "cet_gemm_s8", a.data_ptr(), w.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), act_scales.data_ptr(), a_idx,
        res.data_ptr() if res is not None else None, out.data_ptr(),
        m, n, k, epi, act,
    )


def _layernorm_s8(x, ln, eps: float, act_scales, a_idx: int, out) -> None:
    d = x.shape[-1]
    _build.launch(
        "cet_layernorm_s8", x.data_ptr(), ln.data_ptr(),
        ln.data_ptr() + d * ln.element_size(), act_scales.data_ptr(), a_idx,
        out.data_ptr(), x.numel() // d, d, eps,
    )


def fused_block_int8(
    x: torch.Tensor,           # [B, n, d] bf16
    wqkv_q: torch.Tensor,      # int8 [3d, d] ([out, in]: the JAX kernel^T)
    sqkv: torch.Tensor,        # fp32 [3d] per-output-channel scale
    bqkv: torch.Tensor,        # fp32 [3d]
    wo_q: torch.Tensor, so: torch.Tensor, bo: torch.Tensor,   # [d, d]
    w1_q: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,   # [mlp, d]
    w2_q: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,   # [d, mlp]
    ln1: torch.Tensor,         # [2, d] (scale, bias), cast to x's dtype
    ln2: torch.Tensor,
    act_scales: torch.Tensor,  # fp32 [4]: qkv, out, fc, proj
    heads: int,
    kv_valid: int,
    quick_gelu: bool = False,
    ln_eps: float = 1e-5,
    causal: bool = False,
    act: Optional[str] = None,
) -> torch.Tensor:
    """One W8A8 pre-LN transformer block; returns [B, n, d] in x's dtype.

    Argument order is the JAX ``fused_block_int8``'s; weights are in the
    ``[out, in]`` layout with per-row scales. CPU tensors take
    :func:`fused_block_int8_reference`. CUDA tensors must be bf16 ``x``,
    int8 weights, fp32 scales, biases and ``act_scales`` on the card, must
    not require grad, and must pass :func:`fused_block_supported`; they
    launch the kernels.
    """
    args = (x, wqkv_q, sqkv, bqkv, wo_q, so, bo, w1_q, s1, b1, w2_q, s2, b2,
            ln1, ln2, act_scales)
    if x.device.type == "cpu":
        return fused_block_int8_reference(*args, heads, kv_valid, quick_gelu,
                                          ln_eps, causal, act)
    act = act or ("quick" if quick_gelu else "erf")
    b, n, d = x.shape
    mlp = w1_q.shape[0]
    if not all(t.is_cuda for t in args):
        raise TypeError("fused_block_int8 kernels take CUDA tensors")
    if (x.dtype != torch.bfloat16
            or any(w.dtype != torch.int8 for w in (wqkv_q, wo_q, w1_q, w2_q))
            or any(t.dtype != torch.float32 for t in
                   (sqkv, bqkv, so, bo, s1, b1, s2, b2, act_scales))):
        raise TypeError("fused_block_int8 kernels take bf16 x, int8 weights "
                        "and fp32 scales, biases and act_scales")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("fused_block_int8 is forward-only")
    if not fused_block_supported(n, d, heads, mlp / d, int8=True):
        raise ValueError(f"fused_block_int8 kernels do not take n={n} d={d} "
                         f"heads={heads} mlp={mlp}")
    if (wqkv_q.shape != (3 * d, d) or wo_q.shape != (d, d)
            or w1_q.shape != (mlp, d) or w2_q.shape != (d, mlp)
            or sqkv.shape != (3 * d,) or bqkv.shape != (3 * d,)
            or so.shape != (d,) or bo.shape != (d,) or s1.shape != (mlp,)
            or b1.shape != (mlp,) or s2.shape != (d,) or b2.shape != (d,)
            or ln1.shape != (2, d) or ln2.shape != (2, d)
            or act_scales.shape != (4,)):
        raise ValueError("fused_block_int8 weights must be in [out, in] "
                         "layout with one scale and bias per output")
    (x, wqkv_q, sqkv, bqkv, wo_q, so, bo, w1_q, s1, b1, w2_q, s2, b2, ln1,
     ln2, act_scales) = (t.contiguous() for t in args)
    ln1, ln2 = ln1.to(x.dtype), ln2.to(x.dtype)
    a = _ACTS[act]

    h = torch.empty(b, n, d, dtype=torch.int8, device=x.device)
    _layernorm_s8(x, ln1, ln_eps, act_scales, 0, h)
    qkv = torch.empty(b, n, 3 * d, dtype=x.dtype, device=x.device)
    _gemm_s8(h, wqkv_q, sqkv, bqkv, act_scales, 0, None, qkv, _EPI_Q_BF16, a)
    att = torch.empty_like(x)
    _attention(qkv, att, heads, kv_valid, causal)
    _build.launch("cet_quantize_s8", att.data_ptr(), act_scales.data_ptr(), 1,
                  h.data_ptr(), att.numel())
    x1 = torch.empty_like(x)
    _gemm_s8(h, wo_q, so, bo, act_scales, 1, x, x1, _EPI_Q_RESIDUAL, a)
    _layernorm_s8(x1, ln2, ln_eps, act_scales, 2, h)
    m = torch.empty(b, n, mlp, dtype=torch.int8, device=x.device)
    _gemm_s8(h, w1_q, s1, b1, act_scales, 2, None, m, _EPI_Q_ACT_Q8, a)
    y = torch.empty_like(x)
    _gemm_s8(m, w2_q, s2, b2, act_scales, 3, x1, y, _EPI_Q_RESIDUAL, a)
    fused_block_int8.launches += 1
    return y


fused_block_int8.launches = 0
