"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path does not reach: ragged tiles, every head dim,
strided views, a zero weight row (int8), the training kernels (attention
backward, fused_block_residuals) at ViT-L and text shapes, inf and NaN in
the keys past kv_valid, a backward that repeats bit for bit, the bf16 and
int8 GEMMs alone over ragged M, N and K and every epilogue, the residual
block inside an autograd backward, the errors a wrapper raises, and the
PACL/SPARC slice on the card (the frozen-tower routes' patch tokens, a
head step, the head scorers' route), and the SigLIP shapes (attention at
head dims 72, 80, 88 and 104 from separate and packed buffers, the GEMMs
at N and K = 4304, the SO400M-width blocks and a two-layer tower on every
serving route), and VLM2Vec's other backbones (the attention causal at
head dim 96, int8_linear with a bias at N = 512, a tiny Phi-3-V,
LLaVA-NeXT, Qwen2-VL with its W8A8 trunk and Qwen2.5-VL on the card
against the plain path), and generation and CoCa (int8_linear at a
decode step's 1 and 8 rows, a tiny greedy decode and a CoCa train step on
the card against the CPU's plain path), and the zoo's training (the
attention backward at the head dims it pads to 128, 72-96, and a
two-block EVA01 CLIP's train step with remat against the CPU).
Marked ``cuda``; without a card they skip. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from clip_embeds_tpu_torch.ops.flash_attention import (
    _flash_forward,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from clip_embeds_tpu_torch.models.layers import ResidualAttentionBlock
from clip_embeds_tpu_torch.models.quant import (
    calibrate_act_scales,
    quantize_state_dict,
)
from clip_embeds_tpu_torch.models.serving import (
    INT8_BLOCK_ARGS,
    int8_block_args,
)
from clip_embeds_tpu_torch.ops.fused_block import (
    _ACTS,
    _EPI_ACT,
    _EPI_BIAS,
    _EPI_Q_ACT_Q8,
    _EPI_Q_BF16,
    _EPI_Q_RESIDUAL,
    _EPI_RESIDUAL,
    _gemm,
    _gemm_s8,
    fused_block,
    fused_block_int8,
    fused_block_int8_reference,
    fused_block_reference,
    fused_block_residuals,
    fused_block_residuals_reference,
    gemm_reference,
    gemm_s8_reference,
)
from clip_embeds_tpu_torch.ops.fused_block_ad import (
    BLOCK_PARAMS,
    make_fused_block_ad,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, *shape, std=1.0, mean=0.0):
    a = mean + std * rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", torch.bfloat16)


def _block_args(rng, b, n, d, mlp, bias_std=0.02, out_std=0.05):
    ln = lambda: torch.stack([_bf16(rng, d, std=0.1, mean=1.0),
                              _bf16(rng, d, std=0.1)])
    return (_bf16(rng, b, n, d), _bf16(rng, 3 * d, d, std=d ** -0.5),
            _bf16(rng, 3 * d, std=bias_std), _bf16(rng, d, d, std=out_std),
            _bf16(rng, d, std=bias_std),
            _bf16(rng, mlp, d, std=(2 * d) ** -0.5),
            _bf16(rng, mlp, std=bias_std), _bf16(rng, d, mlp, std=out_std),
            _bf16(rng, d, std=bias_std), ln(), ln())


@pytest.mark.parametrize("act", ["quick", "erf", "tanh"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, n, d, heads, kv_valid", [
    (3, 37, 64, 2, 37),     # ragged M tile, head dim 32
    (2, 144, 96, 3, 131),   # N = 288 not a multiple of the 128 tile
    (1, 80, 256, 2, 77),    # head dim 128
])
def test_fused_block_kernel_matches_plain(cuda, b, n, d, heads, kv_valid,
                                          causal, act):
    rng = np.random.default_rng(0)
    args = _block_args(rng, b, n, d, 4 * d)
    kw = dict(heads=heads, kv_valid=kv_valid, causal=causal, act=act)
    with torch.inference_mode():
        got = fused_block(*args, **kw)
        want = fused_block_reference(*args, **kw)
    diff = (got.float() - want.float())[:, :kv_valid].abs()
    # bf16 outputs of magnitude < 8: a rounding flip is 1/32; allow 4
    assert diff.max().item() <= 0.125, diff.max().item()
    assert diff.mean().item() <= 2e-3


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 1, 1, 64), (2, 3, 63, 32), (1, 2, 65, 128), (2, 2, 200, 40),
    (1, 16, 577, 64),
])
def test_flash_kernel_matches_plain(cuda, shape, causal):
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, *shape) for _ in range(3))
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal)
        want = flash_attention_reference(q, k, v, causal)
    assert got.shape == want.shape
    # |o| <= max|v| ~ 4: P is rounded to bf16 on both sides, the online
    # softmax rescales in fp32
    assert (got.float() - want.float()).abs().max().item() <= 0.02


def test_flash_kernel_reads_packed_views(cuda):
    """q, k, v as strided views of one [B, N, 3, H, D] buffer, as the
    composable attention passes them: the same result as contiguous."""
    rng = np.random.default_rng(2)
    qkv = _bf16(rng, 2, 300, 3, 4, 64)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    with torch.inference_mode():
        before = flash_attention.launches
        got = flash_attention(q, k, v)
        want = flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    assert flash_attention.launches == before + 2
    assert torch.equal(got, want)


def test_kernel_wrappers_reject_what_they_cannot_run(cuda):
    rng = np.random.default_rng(3)
    q = _bf16(rng, 1, 2, 128, 64)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float())
    w = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd(q, q, q, q, q, None)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_block_residuals(*(a.clone().requires_grad_() for a in
                                _block_args(rng, 1, 16, 64, 256)),
                              heads=2, kv_valid=16)
    args = _block_args(rng, 1, 16, 64, 256)
    with pytest.raises(ValueError):  # head dim 4: not a multiple of 8
        fused_block(*args, heads=16, kv_valid=16)
    with pytest.raises(TypeError):
        fused_block(*(a.float() for a in args), heads=2, kv_valid=16)


def _int8_block_args(rng, b, n, d, heads, kv_valid, causal):
    """fused_block_int8 inputs: bf16 x, weights quantised from random fp32
    ones (c_proj row 0 all zero), biases of std 0.5 (a dropped one would
    move the mean |diff| by ~0.4), static scales calibrated by a dynamic
    pass of the quantised composable block over x."""
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = _block_args(
        rng, b, n, d, 4 * d, bias_std=0.5)
    w2[0] = 0
    sd = {"ln_1.weight": ln1[0], "ln_1.bias": ln1[1],
          "attn.in_proj_weight": wqkv, "attn.in_proj_bias": bqkv,
          "attn.out_proj.weight": wo, "attn.out_proj.bias": bo,
          "ln_2.weight": ln2[0], "ln_2.bias": ln2[1],
          "mlp.c_fc.weight": w1, "mlp.c_fc.bias": b1,
          "mlp.c_proj.weight": w2, "mlp.c_proj.bias": b2}
    with torch.device("meta"):
        block = ResidualAttentionBlock(d, heads, quant="dynamic")
    block.load_state_dict(quantize_state_dict(sd), assign=True)
    with torch.inference_mode():
        calibrate_act_scales(block, [(x[:, :kv_valid], causal)])
    p = int8_block_args(block)
    assert p["s2"][0] == 1.0 and not p["w2_q"][0].any()
    return [x] + [p[k] for k in INT8_BLOCK_ARGS]


@pytest.mark.parametrize("act", ["quick", "erf", "tanh"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, n, d, heads, kv_valid", [
    (3, 37, 64, 2, 37),     # ragged M tile, head dim 32
    (2, 50, 128, 2, 45),    # head dim 64, M = 100
    (2, 144, 96, 3, 131),   # N = 288 and K = 96: ragged N and K tiles
    (1, 80, 256, 2, 77),    # head dim 128
])
def test_fused_block_int8_kernel_matches_plain(cuda, b, n, d, heads,
                                               kv_valid, causal, act):
    rng = np.random.default_rng(4)
    args = _int8_block_args(rng, b, n, d, heads, kv_valid, causal)
    kw = dict(heads=heads, kv_valid=kv_valid, causal=causal, act=act)
    with torch.inference_mode():
        before = fused_block_int8.launches
        got = fused_block_int8(*args, **kw)
        want = fused_block_int8_reference(*args, **kw)
    assert fused_block_int8.launches == before + 1
    diff = (got.float() - want.float())[:, :kv_valid].abs()
    # max as chip_smoke.py: bf16 rounding flips of outputs below 8, and
    # int8 codes the two sides round apart (each a * max|w|) spreading.
    # Mean: 2x the worst sound reading over these cases on the H100
    # (0.0022), far under a dropped bias (>= 0.18) and under two swapped
    # act scales (>= 0.009)
    assert diff.max().item() <= 0.125, diff.max().item()
    assert diff.mean().item() <= 0.005, diff.mean().item()


def test_fused_block_int8_wrapper_rejects(cuda):
    rng = np.random.default_rng(5)
    args = _int8_block_args(rng, 1, 16, 64, 2, 16, False)
    with pytest.raises(TypeError):  # fp32 activations
        fused_block_int8(args[0].float(), *args[1:], heads=2, kv_valid=16)
    with pytest.raises(TypeError):  # fp weights where int8 belong
        fused_block_int8(args[0], args[1].bfloat16(), *args[2:], heads=2,
                         kv_valid=16)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_block_int8(args[0].clone().requires_grad_(), *args[1:],
                         heads=2, kv_valid=16)
    with pytest.raises(ValueError):  # head dim 4: not a multiple of 8
        fused_block_int8(*args, heads=16, kv_valid=16)


def _bwd_inputs(rng, shape, causal):
    q, k, v, g = (_bf16(rng, *shape) for _ in range(4))
    with torch.inference_mode():
        o, lse = _flash_forward(q, k, v, causal, with_lse=True)
    return q, k, v, o, g, lse


def _bwd_diff(got, want):
    return [(a.float() - b.float()).abs() for a, b in zip(got, want)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 1, 1, 64), (2, 3, 63, 32), (1, 2, 65, 128), (2, 2, 200, 40),
    (1, 16, 577, 64), (2, 12, 77, 64), (1, 4, 577, 32), (1, 4, 577, 128),
])
def test_flash_bwd_kernel_matches_plain(cuda, shape, causal):
    """Ragged N (1, 63, 65, 77, 200, 577), head dims 32, 64, 128 and a
    padded 40, causal and not, ViT-L and text shapes; N = 577 also at the
    head dims whose accumulators press the register file hardest (D = 128
    takes 32-row Q sub-tiles in the dK/dV launch)."""
    rng = np.random.default_rng(6)
    q, k, v, o, g, lse = _bwd_inputs(rng, shape, causal)
    with torch.inference_mode():
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, o, g, lse, causal)
        want = flash_attention_bwd_reference(q, k, v, o, g, causal)
        torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    for name, d in zip("qkv", _bwd_diff(got, want)):
        # |dq|, |dk|, |dv| <~ 8 here: a bf16 rounding flip is <= 1/32, and
        # P and dS are rounded to bf16 on both sides from fp32 values that
        # the online (kernel) and two-pass (plain) softmax round apart.
        # Mean: the chip_smoke.py limit (sound 2.3e-7 at ViT-L and text
        # shapes on the H100; a dropped delta term reads >= 0.006)
        assert d.max().item() <= 0.0625, (name, d.max().item())
        assert d.mean().item() <= 2e-5, (name, d.mean().item())


def test_flash_bwd_kernel_reads_packed_views(cuda):
    """q, k, v as strided views of one [B, N, 3, H, D] buffer and dO as a
    strided view, as the composable training path passes them."""
    rng = np.random.default_rng(7)
    qkv = _bf16(rng, 2, 300, 3, 4, 64)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    g = _bf16(rng, 2, 300, 4, 64).transpose(1, 2)
    with torch.inference_mode():
        o, lse = _flash_forward(q, k, v, False, with_lse=True)
        got = flash_attention_bwd(q, k, v, o, g, lse)
        want = flash_attention_bwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), o, g.contiguous(), lse)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [130, 577])
def test_flash_attention_autograd_on_card(cuda, n, causal):
    """The autograd Function on the card (its backward runs on autograd's
    own thread): forward kernel with its log-sum-exp, backward kernel;
    output and gradients as the plain versions. At N = 577 the causal
    diagonal crosses ten key tiles."""
    rng = np.random.default_rng(8)
    q, k, v = (_bf16(rng, 2, 4, n, 64).requires_grad_() for _ in range(3))
    g = _bf16(rng, 2, 4, n, 64)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(q, k, v, causal)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want_out = flash_attention_reference(q, k, v, causal)
        want = flash_attention_bwd_reference(q, k, v, out, g, causal)
    assert (out.float() - want_out.float()).abs().max().item() <= 0.02
    for d in _bwd_diff(grads, want):
        assert d.max().item() <= 0.0625 and d.mean().item() <= 2e-5


@pytest.mark.parametrize("act", ["quick", "erf"])
@pytest.mark.parametrize("b, n, d, heads, kv_valid, causal", [
    (3, 37, 64, 2, 37, False),     # ragged M tile, head dim 32
    (2, 144, 96, 3, 131, True),    # N = 288 not a multiple of 128
    (1, 80, 256, 2, 77, False),    # head dim 128
    (2, 577, 1024, 16, 577, False),  # ViT-L/14-336 vision block
    (4, 77, 768, 12, 77, True),    # its text block
])
def test_fused_block_residuals_kernel_matches_plain(cuda, b, n, d, heads,
                                                    kv_valid, causal, act):
    rng = np.random.default_rng(9)
    args = _block_args(rng, b, n, d, 4 * d, bias_std=0.5)
    kw = dict(heads=heads, kv_valid=kv_valid, causal=causal, act=act)
    with torch.inference_mode():
        before = fused_block_residuals.launches
        got = fused_block_residuals(*args, **kw)
        want = fused_block_residuals_reference(*args, **kw)
        y = fused_block(*args, **kw)
    assert fused_block_residuals.launches == before + 1
    assert torch.equal(got[0], y)  # the same chain as fused_block
    for name, a, w in zip(("y", "qkv", "att", "m1", "x_mid"), got, want):
        assert a.shape == w.shape, name
        diff = (a.float() - w.float())[:, :kv_valid].abs()
        assert diff.max().item() <= 0.125, (name, diff.max().item())
        assert diff.mean().item() <= 4e-3, (name, diff.mean().item())


@pytest.mark.parametrize("causal", [False, True])
def test_attention_ignores_keys_past_kv_valid(cuda, causal):
    """The fused chain's packed call at n = 592, kv_valid = 577: inf in the
    K rows and NaN in the V rows past kv_valid change no output and no
    log-sum-exp (the K/V tensor maps end at kv_valid), and the 15 padded
    query rows stay finite."""
    from clip_embeds_tpu_torch.ops.fused_block import _attention

    rng = np.random.default_rng(10)
    b, n, kv, heads, d = 2, 592, 577, 16, 1024
    qkv = _bf16(rng, b, n, 3 * d)
    qkv[:, kv:, d:] = 0
    runs = []
    for fill in (None, (float("inf"), float("nan"))):
        x = qkv.clone()
        if fill is not None:
            x[:, kv:, d:2 * d] = fill[0]
            x[:, kv:, 2 * d:] = fill[1]
        out = torch.empty(b, n, d, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(b * heads, n, dtype=torch.float32, device="cuda")
        _attention(x, out, heads, kv, causal, lse)
        torch.cuda.synchronize()
        runs.append((out, lse))
    (out0, lse0), (out1, lse1) = runs
    assert torch.isfinite(out1).all() and torch.isfinite(lse1).all()
    assert torch.equal(out0, out1) and torch.equal(lse0, lse1)


def test_flash_bwd_kernel_is_deterministic(cuda):
    """No atomics: two backward calls on the same inputs are bit-equal."""
    rng = np.random.default_rng(11)
    q, k, v, o, g, lse = _bwd_inputs(rng, (4, 16, 577, 64), False)
    with torch.inference_mode():
        first = flash_attention_bwd(q, k, v, o, g, lse)
        second = flash_attention_bwd(q, k, v, o, g, lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# cet_gemm's four epilogues as (epi, pre): EPI_BIAS_ACT_PRE is the
# activation epilogue with a pre-activation tensor
GEMM_EPILOGUES = {"bias": (_EPI_BIAS, False), "act": (_EPI_ACT, False),
                  "residual": (_EPI_RESIDUAL, False),
                  "act_pre": (_EPI_ACT, True)}


def _gemm_inputs(rng, m, n, k):
    """a [m, k], w [n, k] (sums of std 1), bias of std 0.5, res [m, n]."""
    return (_bf16(rng, m, k), _bf16(rng, n, k, std=k ** -0.5),
            _bf16(rng, n, std=0.5), _bf16(rng, m, n))


def _run_gemm(a, w, bias, res, epi, act, pre):
    out = torch.empty(a.shape[0], w.shape[0], dtype=torch.bfloat16,
                      device="cuda")
    p = torch.empty_like(out) if pre else None
    _gemm(a, w, bias, res if epi == _EPI_RESIDUAL else None, out, epi, act,
          p)
    return (out, p) if pre else (out,)


@pytest.mark.parametrize("epilogue", list(GEMM_EPILOGUES))
@pytest.mark.parametrize("k", [32, 96, 1024, 4096])
@pytest.mark.parametrize("n", [40, 136, 288, 3072])
@pytest.mark.parametrize("m", [1, 63, 129, 2368])
def test_gemm_kernel_matches_plain(cuda, m, n, k, epilogue):
    """cet_gemm alone: ragged M (1, 63, 129) and N (40, 136, 288) tile
    edges, a K tail of half a 64-wide stage (32, 96), the serving image
    rows (2368) and the projections' widths and depths; every epilogue,
    the activation cycling over the three."""
    epi, pre = GEMM_EPILOGUES[epilogue]
    act = ("quick", "erf", "tanh")[(m + n + k) % 3]
    rng = np.random.default_rng(12)
    args = _gemm_inputs(rng, m, n, k)
    with torch.inference_mode():
        got = _run_gemm(*args, epi, act, pre)
        want = gemm_reference(*args, epi, act, pre=pre)
        torch.cuda.synchronize()
    want = want if pre else (want,)
    for g, w in zip(got, want, strict=True):
        diff = (g.float() - w.float()).abs()
        # the fp32 sums differ from the plain ones in order only: outputs
        # (|out| < 16) round apart by a bf16 step, rarely; the residual
        # rounds twice, so two steps
        assert diff.max().item() <= 0.125, diff.max().item()
        assert diff.mean().item() <= 1e-3, diff.mean().item()


def test_gemm_kernel_is_deterministic(cuda):
    """No split-K and no atomics: two calls are bit-equal, at a b32
    training shape and at the text serving rows (other tile widths)."""
    rng = np.random.default_rng(13)
    for m, n, k in ((18464, 1024, 1024), (640, 2304, 768)):
        args = _gemm_inputs(rng, m, n, k)
        with torch.inference_mode():
            first = _run_gemm(*args, _EPI_ACT, "quick", True)
            second = _run_gemm(*args, _EPI_ACT, "quick", True)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_gemm_wrapper_rejects(cuda):
    """What TMA cannot read: N or K not a multiple of 8 (16-byte rows), a
    base off 16 bytes; and a pre-activation without the act epilogue."""
    rng = np.random.default_rng(14)
    a, w, bias, _ = _gemm_inputs(rng, 64, 64, 64)
    out = torch.empty(64, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):  # N = 60
        _gemm(a, w[:60], bias[:60], None, out[:, :60].contiguous(),
              _EPI_BIAS, "quick")
    with pytest.raises(ValueError, match="multiples of 8"):  # K = 60
        _gemm(_bf16(rng, 64, 60), _bf16(rng, 64, 60), bias, None, out,
              _EPI_BIAS, "quick")
    shifted = _bf16(rng, 64 * 64 + 1)[1:].view(64, 64)
    with pytest.raises(ValueError, match="aligned"):
        _gemm(shifted, w, bias, None, out, _EPI_BIAS, "quick")
    with pytest.raises(ValueError, match="pre-activation"):
        _gemm(a, w, bias, None, out, _EPI_BIAS, "quick", out.clone())


def test_fused_block_residuals_in_autograd_backward(cuda):
    """The residual route's backward runs on autograd's own thread, where
    fused_block_residuals encodes its GEMM tensor maps: it launches, and
    its gradients agree with the vjp route's."""
    rng = np.random.default_rng(15)
    b, n, d, heads, mlp = 2, 144, 128, 2, 512
    shapes = {"ln_1.weight": (d,), "ln_1.bias": (d,),
              "attn.in_proj_weight": (3 * d, d), "attn.in_proj_bias": (3 * d,),
              "attn.out_proj.weight": (d, d), "attn.out_proj.bias": (d,),
              "ln_2.weight": (d,), "ln_2.bias": (d,),
              "mlp.c_fc.weight": (mlp, d), "mlp.c_fc.bias": (mlp,),
              "mlp.c_proj.weight": (d, mlp), "mlp.c_proj.bias": (d,)}
    params = [_bf16(rng, *shapes[k], std=0.05,
                    mean=1.0 if k.startswith("ln") and "weight" in k else 0.0)
              for k in BLOCK_PARAMS]
    x = _bf16(rng, b, n, d)
    g = _bf16(rng, b, n, d)
    grads = {}
    for impl in ("residual", "vjp"):
        leaves = [t.clone().requires_grad_() for t in (x, *params)]
        before = fused_block_residuals.launches
        y = make_fused_block_ad(heads, "quick", 1e-5, False,
                                impl).apply(*leaves)
        grads[impl] = torch.autograd.grad(y, leaves, g)
        torch.cuda.synchronize()
        assert fused_block_residuals.launches == before + (
            impl == "residual")
    for name, r, v in zip(("x", *BLOCK_PARAMS), grads["residual"],
                          grads["vjp"]):
        assert torch.isfinite(r).all(), name
        cos = torch.nn.functional.cosine_similarity(
            r.float().flatten(), v.float().flatten(), dim=0).item()
        # two bf16 backward formulas of one block (the training routes
        # agree with each other to >= 0.99 per tensor at ViT-L)
        assert cos >= 0.99, (name, cos)


# cet_gemm_s8's three epilogues as (epi, a_idx): the projection whose
# activation scale each reads in the block (qkv, out, fc)
GEMM_S8_EPILOGUES = {"bf16": (_EPI_Q_BF16, 0),
                     "residual": (_EPI_Q_RESIDUAL, 1),
                     "act_q8": (_EPI_Q_ACT_Q8, 2)}
# a[2] * s makes the sums of std ~1.6; a[3] puts act(v) over the codes
GEMM_S8_ACT_SCALES = (0.021, 0.034, 0.027, 0.0315)


def _gemm_s8_inputs(rng, m, n, k):
    """int8 codes a [m, k] and w [n, k] (std 40), fp32 column scales and
    biases (std 0.5), the four act scales, a bf16 residual [m, n]."""
    def codes(*shape):
        q = np.clip(np.round(40 * rng.standard_normal(shape)), -127, 127)
        return torch.from_numpy(q.astype(np.int8)).cuda()

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    wscale = (1 + 0.1 * rng.standard_normal(n)) / (30 * k ** 0.5)
    return (codes(m, k), codes(n, k), f32(wscale),
            f32(0.5 * rng.standard_normal(n)), f32(GEMM_S8_ACT_SCALES),
            _bf16(rng, m, n))


def _run_gemm_s8(a, w, wscale, bias, act_scales, res, epi, a_idx, act):
    out = torch.empty(a.shape[0], w.shape[0], device="cuda",
                      dtype=torch.int8 if epi == _EPI_Q_ACT_Q8
                      else torch.bfloat16)
    _gemm_s8(a, w, wscale, bias, act_scales, a_idx,
             res if epi == _EPI_Q_RESIDUAL else None, out, epi, _ACTS[act])
    return out


def _check_gemm_s8(got, want, epi):
    """bf16 and residual outputs bit-equal (exact int32 sums, the same
    unfused fp32 steps); int8 codes equal but for +-1 flips in at most
    1e-4 of the entries (the activation's exp and division round apart
    from torch's, which moves a code at a .5 boundary)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if epi != _EPI_Q_ACT_Q8:
        assert torch.equal(got, want), (got.float() - want.float()).abs().max()
        return
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1, diff.max().item()
    assert (diff > 0).sum().item() <= 1e-4 * diff.numel(), (
        (diff > 0).sum().item(), diff.numel())


@pytest.mark.parametrize("epilogue", list(GEMM_S8_EPILOGUES))
@pytest.mark.parametrize("k", [32, 96, 1024, 4096])
@pytest.mark.parametrize("n", [48, 144, 288, 3072])
@pytest.mark.parametrize("m", [1, 63, 129, 2368])
def test_gemm_s8_kernel_matches_plain(cuda, m, n, k, epilogue):
    """cet_gemm_s8 alone: ragged M (1, 63, 129) and N (48, 144, 288) tile
    edges, K tails under one 128-wide stage (32, 96), the serving image
    rows (2368) and the projections' widths and depths; every epilogue,
    the activation cycling over the three."""
    epi, a_idx = GEMM_S8_EPILOGUES[epilogue]
    act = ("quick", "erf", "tanh")[(m + n + k) % 3]
    rng = np.random.default_rng(16)
    args = _gemm_s8_inputs(rng, m, n, k)
    with torch.inference_mode():
        got = _run_gemm_s8(*args, epi, a_idx, act)
        want = gemm_s8_reference(*args[:5], a_idx, args[5], epi, act)
        torch.cuda.synchronize()
    _check_gemm_s8(got, want, epi)


def test_gemm_s8_kernel_is_deterministic(cuda):
    """No split-K and no atomics: two calls are bit-equal, at the b32 image
    rows' proj and at the text serving rows' qkv (the narrower tiles)."""
    rng = np.random.default_rng(17)
    for m, n, k in ((18944, 1024, 4096), (640, 2304, 768)):
        args = _gemm_s8_inputs(rng, m, n, k)
        for epi, a_idx in GEMM_S8_EPILOGUES.values():
            with torch.inference_mode():
                first = _run_gemm_s8(*args, epi, a_idx, "quick")
                second = _run_gemm_s8(*args, epi, a_idx, "quick")
            assert torch.equal(first, second)


def test_gemm_s8_wrapper_rejects(cuda):
    """What TMA cannot read or write: K not a multiple of 16, N not a
    multiple of 16 for int8 output (8 for bf16), a base off 16 bytes, a
    strided operand."""
    rng = np.random.default_rng(18)
    a, w, wscale, bias, scales, res = _gemm_s8_inputs(rng, 64, 64, 64)
    out = torch.empty(64, 64, dtype=torch.bfloat16, device="cuda")
    q8 = torch.empty(64, 56, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):  # K = 56
        _gemm_s8(a[:, :56].contiguous(), w[:, :56].contiguous(), wscale,
                 bias, scales, 0, None, out, _EPI_Q_BF16, 0)
    with pytest.raises(ValueError, match="N of 16"):  # int8 N = 56
        _gemm_s8(a, w[:56].contiguous(), wscale[:56], bias[:56], scales, 2,
                 None, q8, _EPI_Q_ACT_Q8, 0)
    with pytest.raises(ValueError, match="N of 8"):  # bf16 N = 60
        _gemm_s8(a, w[:60].contiguous(), wscale[:60], bias[:60], scales, 0,
                 None, out[:, :60].contiguous(), _EPI_Q_BF16, 0)
    shifted = torch.empty(64 * 64 + 1, dtype=torch.int8,
                          device="cuda")[1:].view(64, 64)
    with pytest.raises(ValueError, match="aligned"):
        _gemm_s8(shifted, w, wscale, bias, scales, 0, None, out,
                 _EPI_Q_BF16, 0)
    with pytest.raises(ValueError, match="contiguous"):
        _gemm_s8(a, w, wscale, bias, scales, 1, res.t(), out,
                 _EPI_Q_RESIDUAL, 0)


def test_scorer_card_route_matches_plain_path(cuda):
    """CLIPScorer on the card in bf16 takes the fused-block kernels for both
    towers (one fused_block launch a block a padded batch) and agrees with
    the plain fp32 composable path on the same weights; in fp32 on the card
    it takes the composable route, as cli/embed.py --fp32 does."""
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.scores.scorers import CLIPScorer

    rng = np.random.default_rng(19)
    images = [rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
              for _ in range(7)]
    texts = [f"a photo of {k} things" for k in range(5)]
    bf16 = CLIPScorer(create_model("test-tiny", seed=3, dtype=torch.bfloat16,
                                   device=cuda), batch_size=4)
    fp32 = CLIPScorer(create_model("test-tiny", seed=3, device=cuda),
                      batch_size=4)
    assert (bf16.route, fp32.route) == ("fused", "composable")
    fused_block.launches = 0
    img, txt = bf16.encode_images(images), bf16.encode_texts(texts)
    cfg = bf16.model.cfg
    # 2 padded image batches (the CLS-only last block is plain), 2 text
    assert fused_block.launches == (2 * (cfg.vision.layers - 1)
                                    + 2 * cfg.text.layers)
    for got, want in ((img, fp32.encode_images(images)),
                      (txt, fp32.encode_texts(texts))):
        assert got.dtype == np.float32 and got.shape == want.shape
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.99, cos


def test_pinned_pipeline_equals_a_synchronous_one(cuda):
    """embed_image_batches / embed_text_batches (non-blocking copies from
    pinned memory, outputs fetched once) give bit for bit what one blocking
    copy and one fetch a batch give."""
    from clip_embeds_tpu_torch.cli.embed import (
        embed_image_batches,
        embed_text_batches,
    )
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.models.serving import fused_encode_text

    model = create_model("test-tiny", seed=4, dtype=torch.bfloat16,
                         device=cuda)
    rng = np.random.default_rng(20)
    batches = [rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
               for n in (8, 8, 8, 3)]
    ids = [rng.integers(1, 49406, (n, 77)).astype(np.int64)
           for n in (8, 8, 5)]
    for row in np.concatenate(ids):
        row[int(rng.integers(2, 77))] = 49407  # EOT, the pooled position

    def sync(encode, arrs):
        outs = []
        with torch.inference_mode():
            for a in arrs:
                pad = np.concatenate([a, np.repeat(a[-1:], 8 - len(a), 0)])
                x = torch.from_numpy(pad).to(cuda)
                outs.append(encode(x)[: len(a)].float().cpu().numpy())
        return np.concatenate(outs)

    np.testing.assert_array_equal(
        embed_image_batches(model, batches, 8),
        sync(lambda x: model.encode_image(x.bfloat16(), normalize=True),
             batches))
    np.testing.assert_array_equal(
        embed_text_batches(model, ids, 8),
        sync(lambda x: fused_encode_text(model, x), ids))


def _vitl2(cuda, dtype=torch.float32):
    """ViT-L/14-336 widths (577 image tokens, so the flash kernel's gate
    opens), two blocks a tower, seeded random weights."""
    from clip_embeds_tpu_torch.core.factory import create_model

    return create_model("test-vitl-2layer", pretrained="openai", seed=0,
                        dtype=dtype, device=cuda)


def test_frozen_tower_routes_match_composable(cuda):
    """The head trainer's kernel routes (every image block through
    fused_block / fused_block_int8, tokens cut back to the 576 patches of
    the 577 rows the 592-row padding holds) against the composable fp32
    tower's patch tokens: bf16 fused at the trainer's 0.999 gate, int8 at
    the JAX package's 0.99 int8 gate against bf16."""
    from clip_embeds_tpu_torch.cli.train_pacl import (
        _cosine,
        make_frozen_features,
    )
    from clip_embeds_tpu_torch.models.serving import prepare_int8_tower

    model = _vitl2(cuda)
    rng = np.random.default_rng(21)
    ids = np.zeros((4, 77), np.int64)
    ids[:, 0], ids[:, 1:9], ids[:, 9] = 49406, rng.integers(1, 49406, 8), \
        49407
    batch = {"images": torch.from_numpy(rng.standard_normal(
        (4, 336, 336, 3)).astype(np.float32)).to(cuda),
        "texts": torch.from_numpy(ids).to(cuda)}
    qtower = prepare_int8_tower(model, batch["images"].bfloat16(),
                                torch.bfloat16)
    fused_block.launches = fused_block_int8.launches = 0
    feats = {route: make_frozen_features(model, "pacl", torch.float32,
                                         route, q)(batch)
             for route, q in (("composable", None), ("fused", None),
                              ("int8", qtower))}
    assert fused_block.launches == 2 * 2 + 2  # image + text, text
    assert fused_block_int8.launches == 2
    ref = feats["composable"][0]
    assert ref.shape == (4, 576, 1024)
    cos = {"fused": _cosine(feats["fused"][0], ref),
           "int8": _cosine(feats["int8"][0], ref),
           "int8_vs_fused": _cosine(feats["int8"][0], feats["fused"][0]),
           "text_fused": _cosine(feats["fused"][1], feats["composable"][1])}
    print(f"frozen-tower patch-token cosines: {cos}")
    assert all(f[0].shape == ref.shape and f[0].dtype == torch.float32
               for f in feats.values())
    assert cos["fused"] >= 0.999 and cos["text_fused"] >= 0.999
    assert cos["int8_vs_fused"] >= 0.99


@pytest.mark.parametrize("kind", ["pacl", "sparc"])
def test_head_step_on_card_matches_cpu(cuda, kind):
    """One frozen-tower step with Adam at dropout 0: the card's head params
    equal the CPU's within 1e-4."""
    import copy

    from clip_embeds_tpu_torch.losses.clip_loss import pacl_clip_loss
    from clip_embeds_tpu_torch.losses.sparc import (
        sparc_group_patches,
        sparc_loss,
    )
    from clip_embeds_tpu_torch.models.clip import l2_normalize
    from clip_embeds_tpu_torch.models.heads import (
        PACLHead,
        SPARCHead,
        init_head,
        language_mask_from_ids,
    )
    from clip_embeds_tpu_torch.train.optim import adam
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState,
        make_frozen_tower_train_step,
    )

    rng = np.random.default_rng(22)
    if kind == "pacl":
        head = PACLHead(64, 48, 32, pooling="weighted", dropout=0.0)
        text = rng.standard_normal((8, 48))
    else:
        head = SPARCHead(64, 48, 32, dropout=0.0)
        text = rng.standard_normal((8, 77, 48))
    feats = (torch.from_numpy(rng.standard_normal((8, 50, 64)).astype("f4")),
             torch.from_numpy(text.astype("f4")))
    ids = torch.from_numpy(rng.integers(1, 49406, (8, 77)))
    ids[:, 20] = 49407

    def loss_of_head(h, f, batch):
        out = h(*f)
        if kind == "pacl":
            return pacl_clip_loss(*out, 0.1), {}
        tnorm = l2_normalize(out[1])
        grouped = l2_normalize(sparc_group_patches(out[0], tnorm, 1 / 50))
        return sparc_loss(out[0], tnorm, grouped,
                          language_mask_from_ids(batch["texts"]), 0.1), {}

    heads = {}
    init_head(head, 3)
    for dev in ("cpu", cuda):
        h = copy.deepcopy(head).to(dev).train()
        state = TrainState(h, adam(h, 1e-4), const_lr(1e-4))
        make_frozen_tower_train_step(loss_of_head)(
            state, tuple(f.to(dev) for f in feats), {"texts": ids.to(dev)})
        heads[str(dev)] = h
    for (name, a), b in zip(heads["cpu"].named_parameters(),
                            heads["cuda"].parameters()):
        assert not torch.equal(a, head.get_parameter(name))
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=0, atol=1e-4)


def test_head_scorers_card_route_matches_plain_path(cuda):
    """PACLScorer and SPARCScorer on the card in bf16: the composable image
    tower takes the flash kernel (one launch a block a batch), and the
    image-side head outputs agree with the plain fp32 path's (fp32 towers
    and head, no kernel) at row cosine 0.99."""
    from clip_embeds_tpu_torch.models.heads import (
        PACLHead,
        SPARCHead,
        init_head,
    )
    from clip_embeds_tpu_torch.scores.scorers import PACLScorer, SPARCScorer

    rng = np.random.default_rng(23)
    images = [rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
              for _ in range(5)]
    models = _vitl2(cuda, torch.bfloat16), _vitl2(cuda)
    pacl = init_head(PACLHead(1024, 768, 768), 4).to(cuda)
    sparc = init_head(SPARCHead(1024, 768, 768), 5).to(cuda)
    text = torch.zeros(5, 768, device=cuda)
    outs = []
    for model in models:
        flash_attention.launches = 0
        ps = PACLScorer(model, pacl, batch_size=4)
        patches = ps._image_patches(images)
        with torch.inference_mode():
            v = ps.head(ps._to_head(patches), text)[0].cpu().numpy()
        ss = SPARCScorer(model, sparc, local=True)
        vproj, _ = ss.head_outputs(ss._pixels(images[:2]),
                                   ss.tokenizer(["a cat", "a dog"]))
        outs.append((v, vproj.reshape(-1, 768).cpu().numpy(),
                     flash_attention.launches))
    # bf16: 2 batches of PACL patches and 1 SPARC call, 2 blocks each
    assert [o[2] for o in outs] == [3 * 2, 0]
    for got, want in zip(outs[0][:2], outs[1][:2]):
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.99, cos.min()


# -- SigLIP shapes: head dims off the 32/64/128 tiles, MLP width 4304 ------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [72, 80, 88, 104])
def test_flash_kernel_odd_head_dims(cuda, hd, causal):
    """The forward at head dims the kernel has no tile of its own for (it
    runs the 128 tile on hd columns), from contiguous tensors and from
    strided views of one packed [B, N, 3, H, hd] buffer (no copy: the same
    bits), against the plain version; 4x16x729x72 is SO400M's image
    tower at batch 4."""
    rng = np.random.default_rng(30)
    shape = (4, 16, 729, hd) if hd == 72 else (2, 3, 200, hd)
    q, k, v = (_bf16(rng, *shape) for _ in range(3))
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal)
        want = flash_attention_reference(q, k, v, causal)
        b, h, n, _ = shape
        qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).contiguous()
        pq, pk, pv = qkv.permute(2, 0, 3, 1, 4)  # views of [B, N, 3, H, hd]
        packed = flash_attention(pq, pk, pv, causal)
    assert got.shape == want.shape == shape
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= 0.02, diff.max().item()
    assert diff.mean().item() <= 2e-4, diff.mean().item()
    assert torch.equal(packed, got)


@pytest.mark.parametrize("hd", [72, 80, 104])
def test_fused_attention_reads_packed_qkv_at_odd_head_dims(cuda, hd):
    """The block chain's attention (cet_attention straight out of the
    packed [B, n, 3d] buffer, heads side by side at hd columns) against
    the plain attention of the same buffer: a map that read past hd would
    take the next head's columns."""
    from clip_embeds_tpu_torch.ops.fused_block import (
        _attention,
        _attention_reference,
    )

    rng = np.random.default_rng(31)
    heads, n, kv = 4, 200, 190
    qkv = _bf16(rng, 2, n, 3 * heads * hd)
    out = torch.empty(2, n, heads * hd, dtype=torch.bfloat16, device="cuda")
    with torch.inference_mode():
        _attention(qkv, out, heads, kv, False)
        want = _attention_reference(qkv, heads, kv, False)
    diff = (out.float() - want.float()).abs()
    assert diff.max().item() <= 0.02, diff.max().item()
    assert diff.mean().item() <= 2e-4, diff.mean().item()


@pytest.mark.parametrize("epilogue", list(GEMM_EPILOGUES))
@pytest.mark.parametrize("m, n, k", [(129, 4304, 1152), (2944, 4304, 1152),
                                     (129, 1152, 4304), (2944, 1152, 4304)])
def test_gemm_kernel_siglip_widths(cuda, m, n, k, epilogue):
    """cet_gemm at SO400M's fc (N = 4304: the last 64-wide piece holds 16
    columns, the staged bias ends at N) and fc2 (K = 4304 = 67 x 64 + 16),
    against the plain version, every epilogue, tanh."""
    epi, pre = GEMM_EPILOGUES[epilogue]
    rng = np.random.default_rng(32)
    args = _gemm_inputs(rng, m, n, k)
    with torch.inference_mode():
        got = _run_gemm(*args, epi, "tanh", pre)
        want = gemm_reference(*args, epi, "tanh", pre=pre)
        torch.cuda.synchronize()
    for g, w in zip(got, want if pre else (want,), strict=True):
        diff = (g.float() - w.float()).abs()
        assert diff.max().item() <= 0.125, diff.max().item()
        assert diff.mean().item() <= 1e-3, diff.mean().item()


@pytest.mark.parametrize("epilogue", list(GEMM_S8_EPILOGUES))
@pytest.mark.parametrize("m, n, k", [(129, 4304, 1152), (2944, 4304, 1152),
                                     (129, 1152, 4304), (2944, 1152, 4304)])
def test_gemm_s8_kernel_siglip_widths(cuda, m, n, k, epilogue):
    """cet_gemm_s8 at SO400M's fc (N = 4304, int8 codes out) and fc2 (K =
    4304 = 33 x 128 + 80), against the plain version."""
    epi, a_idx = GEMM_S8_EPILOGUES[epilogue]
    rng = np.random.default_rng(33)
    args = _gemm_s8_inputs(rng, m, n, k)
    with torch.inference_mode():
        got = _run_gemm_s8(*args, epi, a_idx, "tanh")
        want = gemm_s8_reference(*args[:5], a_idx, args[5], epi, "tanh")
        torch.cuda.synchronize()
    _check_gemm_s8(got, want, epi)


def _siglip_block_args(rng, b, n, d, heads, mlp, kv):
    """fused_block inputs at a SigLIP block's shape, at the scales of
    chip_smoke.py's phase-3 inputs (out-projections of std 0.02, biases
    0.5), whose fault probes set the limits below; and the int8 ones from
    them (weights quantised, scales calibrated by a dynamic pass of a
    quantised SiglipBlock over x)."""
    from clip_embeds_tpu_torch.models.siglip import SiglipBlock
    from clip_embeds_tpu_torch.models.quant import quantize_linears
    from clip_embeds_tpu_torch.models.serving import siglip_int8_block_args

    args = _block_args(rng, b, n, d, mlp, bias_std=0.5, out_std=0.02)
    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = args
    sd = {"ln_1.weight": ln1[0], "ln_1.bias": ln1[1],
          "in_proj.weight": wqkv, "in_proj.bias": bqkv,
          "out_proj.weight": wo, "out_proj.bias": bo,
          "ln_2.weight": ln2[0], "ln_2.bias": ln2[1],
          "fc1.weight": w1, "fc1.bias": b1, "fc2.weight": w2, "fc2.bias": b2}
    with torch.device("meta"):
        block = SiglipBlock(d, heads, mlp, 1e-6, quant="dynamic")
    pairs = [(f"{k}.weight", k) for k in ("in_proj", "out_proj", "fc1",
                                          "fc2")]
    block.load_state_dict(quantize_linears(sd, pairs), assign=True)
    with torch.inference_mode():
        calibrate_act_scales(block, [x[:, :kv]])
    p = siglip_int8_block_args(block)
    return args, [x] + [p[k] for k in INT8_BLOCK_ARGS]


@pytest.mark.parametrize("b, n, d, heads, mlp, kv", [
    (4, 736, 1152, 16, 4304, 729),   # SO400M image block at batch 4
    (8, 64, 1152, 16, 4304, 64),     # its text block
    (2, 48, 144, 2, 208, 45),        # head dim 72, MLP width % 32 = 16
])
def test_fused_blocks_at_siglip_shapes(cuda, b, n, d, heads, mlp, kv):
    """fused_block and fused_block_int8 at head dim 72 with tanh-GELU and
    eps 1e-6 against their plain versions, within chip_smoke.py's
    SIGLIP_BLOCK_CASES limits (the image block's; sound readings on the
    H100 0.0013 and 0.0077)."""
    rng = np.random.default_rng(34)
    args, args8 = _siglip_block_args(rng, b, n, d, heads, mlp, kv)
    kw = dict(heads=heads, kv_valid=kv, act="tanh", ln_eps=1e-6)
    with torch.inference_mode():
        got, want = fused_block(*args, **kw), fused_block_reference(*args,
                                                                    **kw)
        got8 = fused_block_int8(*args8, **kw)
        want8 = fused_block_int8_reference(*args8, **kw)
    diff = (got.float() - want.float())[:, :kv].abs()
    assert diff.max().item() <= 0.125, diff.max().item()
    assert diff.mean().item() <= 4e-3, diff.mean().item()
    diff8 = (got8.float() - want8.float())[:, :kv].abs()
    # an int8 code the two sides round apart moves its projection and the
    # codes after it: at these widths (mlp 4304) such runs reach 5 bf16
    # steps of 1/32 (0.156 read at 4x736x1152 on the H100), so 8
    assert diff8.max().item() <= 0.25, diff8.max().item()
    assert diff8.mean().item() <= 0.012, diff8.mean().item()


def test_siglip_tower_routes_match_composable(cuda):
    """A two-layer SO400M-width SigLIP (729 image tokens, so the flash
    kernel's gate opens; 64 text tokens) on every serving route, with exact
    launches: bf16 fused and composable + flash against the composable
    fp32 path (row cosine >= 0.99), int8 against bf16 (the JAX package's
    0.99 gate); and SiglipScorer's route in either dtype."""
    import dataclasses

    from clip_embeds_tpu_torch.models.serving import (
        fused_encode_image_siglip,
        fused_encode_image_siglip_int8,
        fused_encode_text_siglip,
        fused_encode_text_siglip_int8,
        prepare_int8_siglip_text_tower,
        prepare_int8_siglip_tower,
        siglip_fused_available,
    )
    from clip_embeds_tpu_torch.models.siglip import (
        SiglipConfig,
        create_siglip,
    )

    base = SiglipConfig()
    cfg = SiglipConfig(dataclasses.replace(base.vision, layers=2),
                       dataclasses.replace(base.text, layers=2))
    assert siglip_fused_available(cfg.vision)
    ref = create_siglip(cfg, seed=0, device=cuda)
    model = create_siglip(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    rng = np.random.default_rng(35)
    px = torch.from_numpy(rng.standard_normal((4, 384, 384, 3)).astype(
        np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 32000, (8, 64))).to(cuda)

    def cos(a, b):
        a, b = a.float(), b.float()
        return (torch.nn.functional.cosine_similarity(a, b, dim=-1)
                .min().item())

    with torch.inference_mode():
        img32, txt32 = ref.encode_image(px), ref.encode_text(ids)
        flash_attention.launches = fused_block.launches = 0
        fused_block_int8.launches = 0
        img = fused_encode_image_siglip(model, px)
        txt = fused_encode_text_siglip(model, ids)
        assert (fused_block.launches, flash_attention.launches) == (4, 0)
        comp = model.encode_image(px)
        assert flash_attention.launches == 2
        q_img = prepare_int8_siglip_tower(ref, px, torch.bfloat16)
        q_txt = prepare_int8_siglip_text_tower(ref, ids, torch.bfloat16)
        assert flash_attention.launches == 4  # the image calibration pass
        img8 = fused_encode_image_siglip_int8(ref, q_img, px)
        txt8 = fused_encode_text_siglip_int8(ref, q_txt, ids)
        assert fused_block_int8.launches == 4
    from clip_embeds_tpu_torch.scores.scorers import SiglipScorer

    # the scorer's card route: fused images in bf16, composable in fp32
    assert SiglipScorer(model, None).route == "fused"
    assert SiglipScorer(ref, None).route == "composable"
    got = {"image": cos(img, img32), "text": cos(txt, txt32),
           "composable": cos(comp, img32), "int8_image": cos(img8, img),
           "int8_text": cos(txt8, txt)}
    print(f"SigLIP two-layer route cosines: {got}")
    assert min(got.values()) >= 0.99, got
    for e in (img, txt, img8, txt8):
        assert torch.isfinite(e).all()
        norms = e.float().norm(dim=-1)
        assert (norms - 1).abs().max().item() <= 2e-2


# -- the LLaVA slice: causal attention at head dim 128, the W8A8 trunk ------


@pytest.mark.parametrize("n", [128, 639, 703])
def test_flash_kernel_causal_head_dim_128(cuda, n):
    """The causal prefill's attention at head dim 128 (LLaVA-1.5-7B's
    trunk: F = Lp - 1 + 576 with Lp padded to 64, so 639 and 703 end in a
    partial Q tile) from the trunk's layout, [B, N, H, D] projections
    viewed as [B, H, N, D] (row stride H * D), against the plain version;
    the same bits as from contiguous tensors."""
    rng = np.random.default_rng(n)
    q, k, v = (_bf16(rng, 2, n, 8, 128).transpose(1, 2) for _ in range(3))
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_reference(q, k, v, causal=True)
        flat = flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    assert got.shape == want.shape == (2, 8, n, 128)
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= 0.02, diff.max().item()
    assert diff.mean().item() <= 2e-4, diff.mean().item()
    assert torch.equal(got, flat)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quant_linear_card_route_is_qdot_rounded_to_bf16(cuda, mode, bias):
    """QuantLinear on the card (cet_quantize_s8, then cet_gemm_s8 with the
    bf16 epilogue) equals qdot's exact product rounded to bf16, bit for
    bit, at a trunk projection's shape (K 4096, N 11008 would be the 7B's;
    here K 512, N 1376); the dynamic scale is the abs-max of the input,
    recorded without a host sync; one int8_linear launch a call."""
    from clip_embeds_tpu_torch.models.quant import QuantLinear, quantize_weight
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear, qdot

    rng = np.random.default_rng(40)
    x = _bf16(rng, 3, 213, 512)
    w = torch.from_numpy(rng.standard_normal((1376, 512)).astype(
        np.float32) * 0.02).to(cuda)
    lin = QuantLinear(512, 1376, mode, bias=bias).to(cuda)
    lin.weight_q, lin.scale = quantize_weight(w)
    if bias:
        lin.bias.normal_(std=0.1)
    lin.act_scale.fill_(0.0213)
    before = int8_linear.launches
    with torch.inference_mode():
        got = lin(x)
    assert int8_linear.launches == before + 1
    a = (lin.act_scale if mode == "static"
         else x.float().abs().amax() / 127.0)
    want = qdot(x.float(), a, lin.weight_q, lin.scale,
                lin.bias).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 213, 1376)
    assert torch.equal(got, want)
    if mode == "dynamic":
        assert lin.act_max.item() == x.float().abs().max().item()


def test_quant_linear_card_route_rejects(cuda):
    """Shapes and types cet_gemm_s8 does not take raise; nothing falls
    back to qdot's float64 product."""
    from clip_embeds_tpu_torch.models.quant import QuantLinear

    lin = QuantLinear(520, 64, bias=False).to(cuda)  # K % 16 != 0
    with pytest.raises(ValueError, match="multiples of 16"):
        lin(torch.zeros(4, 520, dtype=torch.bfloat16, device=cuda))
    lin = QuantLinear(64, 64, bias=False).to(cuda)
    with pytest.raises(TypeError, match="bf16"):
        lin(torch.zeros(4, 64, device=cuda))


def test_llava_routes_on_card_match_plain_path(cuda):
    """A two-layer LLaVA at head dim 128 in bf16 on the card: the prefill
    runs the flash kernel causal (one launch a vision block, one a trunk
    layer), the masked pair path only the vision tower's; the three
    VQAScorer paths agree with each other and with the fp32 plain path
    on the CPU, and the W8A8 trunk launches int8_linear 7 times a layer
    per trunk pass."""
    from clip_embeds_tpu_torch.core.config import VisionConfig
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.models.llama import LlamaConfig
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear
    from clip_embeds_tpu_torch.scores.vqa_score import VQAScorer

    cfg = LlavaConfig(
        llama=LlamaConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2),
        vision=VisionConfig(image_size=224, patch_size=14, width=128,
                            layers=3, head_width=64))
    model = init_llava(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    ref = init_llava(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    ref = ref.float().cpu()

    def tokenize(text):
        return [1] + [2 + sum(map(ord, w)) % 500 for w in text.split()]

    kw = dict(bos_token_id=1, pad_token_id=0)
    ours = VQAScorer(model, tokenize, device=cuda, **kw)
    plain = VQAScorer(ref, tokenize, device="cpu", **kw)
    rng = np.random.default_rng(41)
    images = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
              for _ in range(2)]
    texts = [["a cat", "two dogs on a red mat"], ["a box", "three cups"]]
    flash_attention.launches = 0
    pair = np.stack([ours.forward([im] * 2, t)
                     for im, t in zip(images, texts)])
    assert flash_attention.launches == 2 * cfg.tower_blocks
    flash_attention.launches = 0
    per_image = np.stack([ours.forward_image_texts(im, t)
                          for im, t in zip(images, texts)])
    assert flash_attention.launches == 2 * (cfg.tower_blocks + 2)
    flash_attention.launches = 0
    grouped = ours.forward_groups(images, texts)
    assert flash_attention.launches == cfg.tower_blocks + 2
    want = plain.forward_groups(images, texts)
    for got in (pair, per_image, grouped):
        assert np.isfinite(got).all() and (got > 0).all()
        np.testing.assert_allclose(np.log(got), np.log(want), atol=0.05)
    qmodel = quantize_llava_trunk(model)
    q = VQAScorer(qmodel, tokenize, device=cuda, **kw)
    int8_linear.launches = 0
    got = q.forward_groups(images, texts)
    assert int8_linear.launches == 7 * 2 * 2  # prefill + suffix passes
    np.testing.assert_allclose(np.log(got), np.log(want), atol=0.1)


def test_bundle_int8_trunk_on_card_is_quantised_from_fp32(cuda, tmp_path):
    """A score bundle loaded on the card with quant=True (bf16 serving)
    quantises the trunk on the card from the bundle's fp32 weights: the
    int8 codes and fp32 scales equal those of the fp32 load on the CPU,
    which tests/test_torch_vqa_score.py holds to JAX's."""
    from clip_embeds_tpu_torch.core.config import VisionConfig
    from clip_embeds_tpu_torch.core.convert import jax_params_from_module
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.models.llama import LlamaConfig
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import QuantLinear
    from clip_embeds_tpu_torch.scores.build import save_score_bundle
    from clip_embeds_tpu_torch.scores.registry import get_score_model

    cfg = LlavaConfig(
        llama=LlamaConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2),
        vision=VisionConfig(image_size=224, patch_size=14, width=128,
                            layers=3, head_width=64))
    src = init_llava(cfg, seed=0, device="cpu", dtype=torch.float32)
    save_score_bundle(str(tmp_path), "llava", cfg, jax_params_from_module(src),
                      conversation="chat")

    def quant_layers(device):
        score = get_score_model("llava-v1.5-7b", checkpoint=str(tmp_path),
                                tokenize=lambda t: [1, 2], quant=True,
                                device=device)
        model = score.pair_forward.__self__.model
        return model, [m for m in model.modules()
                       if isinstance(m, QuantLinear)]

    card, on_card = quant_layers(cuda)
    _, on_cpu = quant_layers("cpu")
    assert card.language_model.embed_tokens.weight.dtype == torch.bfloat16
    assert len(on_card) == len(on_cpu) == 7 * 2
    for got, want in zip(on_card, on_cpu):
        assert got.weight_q.is_cuda and got.scale.dtype == torch.float32
        assert torch.equal(got.weight_q.cpu(), want.weight_q)
        assert torch.equal(got.scale.cpu(), want.scale)


def _small_llava(cuda, **kw):
    """A two-layer LLaVA at head dim 128 whose 257-token tower takes the
    flash kernel, seeded, bf16 on the card; and its fp32 copy on the CPU."""
    from clip_embeds_tpu_torch.core.config import VisionConfig
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.models.llama import LlamaConfig
    from clip_embeds_tpu_torch.models.llava import LlavaConfig

    cfg = LlavaConfig(
        llama=LlamaConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2),
        vision=VisionConfig(image_size=224, patch_size=14, width=128,
                            layers=3, head_width=64))
    model = init_llava(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    return model, init_llava(cfg, seed=0, device=cuda,
                             dtype=torch.bfloat16).float().cpu()


def _mixed(n, seed):
    from clip_embeds_tpu_torch.cli.train_vlm2vec import (
        _synthetic_mixed_batches)

    return next(_synthetic_mixed_batches(n, 224, seed))


def _on(batch, device, dtype=torch.float32):
    from clip_embeds_tpu_torch.cli.train_vlm2vec import to_device

    return to_device(batch, device, dtype)


def test_static_act_scales_on_card_are_numpy_division(cuda):
    """Calibrating a W8A8 trunk on the card bakes max(act_max / 127, 1e-8)
    as numpy divides (the JAX package's host division), bit for bit."""
    from clip_embeds_tpu_torch.models.quant import (
        calibrate_act_scales, quant_layers, quantize_llava_trunk)

    model, _ = _small_llava(cuda)
    qmodel = quantize_llava_trunk(model)
    b = _on(_mixed(4, 3), cuda, torch.bfloat16)
    calibrate_act_scales(qmodel, [(b["qry_ids"], b["qry_pixels"],
                                   b["qry_image_valid"], b["qry_mask"])],
                         method="embed_mixed")
    layers = quant_layers(qmodel)
    assert len(layers) == 7 * 2
    for q in layers:
        act_max = np.float32(q.act_max.cpu().numpy())
        want = np.float32(max(act_max / 127.0, 1e-8))
        got = q.act_scale.cpu().numpy()
        assert got.view(np.int32) == np.array(want).view(np.int32)


def test_vlm2vec_embeddings_on_card_match_plain_path(cuda):
    """embed_last_token and embed_mixed in bf16 on the card: one flash
    launch a vision block, none in the padded trunk; with the W8A8 trunk
    seven int8_linear launches a layer; against the fp32 plain path on the
    CPU (least row cosine 0.99; W8A8 against bf16 0.97), unit norm, and
    the mixed batch equal to its rows on their own paths."""
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    model, ref = _small_llava(cuda)
    qmodel = quantize_llava_trunk(model)
    b = _mixed(4, 5)
    on, cpu = _on(b, cuda, torch.bfloat16), _on(b, "cpu")
    args = ("qry_ids", "qry_pixels", "qry_image_valid", "qry_mask")
    tb = model.cfg.tower_blocks

    def cos(x, y):
        return torch.nn.functional.cosine_similarity(
            x.float().cpu(), y.float().cpu(), dim=-1).min().item()

    with torch.inference_mode():
        want = ref.embed_mixed(*(cpu[k] for k in args))
        flash_attention.launches = int8_linear.launches = 0
        got = model.embed_mixed(*(on[k] for k in args))
        assert (flash_attention.launches, int8_linear.launches) == (tb, 0)
        assert cos(got, want) > 0.99
        norms = got.float().norm(dim=-1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-2)
        int8_linear.launches = 0
        q = qmodel.embed_mixed(*(on[k] for k in args))
        assert int8_linear.launches == 7 * 2 and cos(q, got) > 0.97
        flash_attention.launches = 0
        text = model.embed_last_token(on["tgt_ids"], None, on["tgt_mask"])
        assert flash_attention.launches == 0
        assert cos(text, ref.embed_last_token(cpu["tgt_ids"], None,
                                              cpu["tgt_mask"])) > 0.99
        for i in range(4):
            if not b["qry_image_valid"][i]:
                continue
            one = model.embed_last_token(on["qry_ids"][i:i + 1],
                                         on["qry_pixels"][i:i + 1],
                                         on["qry_mask"][i:i + 1])
            assert cos(one, got[i:i + 1]) > 0.999


def test_lora_step_over_int8_trunk_on_card_matches_cpu(cuda):
    """One GradCache step of LoRA adapters through the side-path over the
    W8A8 trunk (remat per block), bf16 on the card against fp32 on the CPU
    from the same codes and adapters (SGD at lr 1: the updated adapters
    hold the gradients), at temperature 1 (VLM2Vec's 0.02 scales the
    logits' bf16 rounding by 50): the loss within 0.02, the adapters'
    gradients at cosine 0.99 over all; the frozen base unchanged."""
    from clip_embeds_tpu_torch.models import lora
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear
    from clip_embeds_tpu_torch.train.vlm2vec import (
        Vlm2VecState, make_vlm2vec_mixed_train_step)

    model, ref = _small_llava(cuda)
    kw = dict(lora_rank=4, lora_alpha=16.0, remat=True)
    qmodel = quantize_llava_trunk(model, **kw)
    qref = quantize_llava_trunk(ref, **kw)
    tree = lora.init_lora(qref, rank=4, generator=torch.Generator()
                          .manual_seed(1))
    rng = np.random.default_rng(2)
    for ab in tree.values():
        ab["b"] = torch.tensor(0.02 * rng.standard_normal(ab["b"].shape),
                               dtype=torch.float32)
    before = {k: v.clone() for k, v in qmodel.state_dict().items()
              if not k.endswith("act_max")}
    batch = _mixed(4, 7)
    grads, losses = [], []
    for m, device, dtype in ((qmodel, cuda, torch.bfloat16),
                             (qref, "cpu", torch.float32)):
        t = {k: {n: v.to(device).clone().requires_grad_()
                 for n, v in ab.items()} for k, ab in tree.items()}
        tensors = list(lora.lora_tensors(t))
        state = Vlm2VecState(model=m, optimizer=torch.optim.SGD(tensors,
                                                                lr=1.0),
                             schedule=lambda s: 1.0, params=t)
        step = make_vlm2vec_mixed_train_step(m, lora_alpha=16.0,
                                             temperature=1.0,
                                             grad_cache_chunks=2)
        int8_linear.launches = 0
        losses.append(float(step(state, _on(batch, device, dtype))["loss"]))
        if device == cuda:  # 2 chunks x 2 sides: no-grad pass, re-forward
            # and its recompute in the backward
            assert int8_linear.launches == 7 * 2 * 2 * 2 * 3
        old = torch.cat([v.flatten() for v in lora.lora_tensors(tree)])
        new = torch.cat([v.detach().float().cpu().flatten()
                         for v in tensors])
        grads.append(old - new)
    assert abs(losses[0] - losses[1]) < 0.02
    cos = torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0)
    assert cos.item() > 0.99
    after = qmodel.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())


def test_training_kernels_at_the_patch_dropout_rows(cuda):
    """--force-patch-dropout 0.5 leaves the ViT-L/14-336 image blocks 1 +
    288 = 289 rows (a partial last tile where 577 had its own): the fused
    blocks at 2x289x1024 and the attention forward and backward at
    2x16x289x64 against their plain versions, under the limits of the
    577-row cases."""
    rng = np.random.default_rng(40)
    args = _block_args(rng, 2, 289, 1024, 4096, bias_std=0.5)
    kw = dict(heads=16, kv_valid=289, causal=False, act="quick")
    with torch.inference_mode():
        y = fused_block(*args, **kw)
        got = fused_block_residuals(*args, **kw)
        want = fused_block_residuals_reference(*args, **kw)
    assert torch.equal(got[0], y)
    for name, a, w in zip(("y", "qkv", "att", "m1", "x_mid"), got, want):
        diff = (a.float() - w.float()).abs()
        assert diff.max().item() <= 0.125, (name, diff.max().item())
        assert diff.mean().item() <= 4e-3, (name, diff.mean().item())
    q, k, v, o, g, lse = _bwd_inputs(rng, (2, 16, 289, 64), False)
    with torch.inference_mode():
        fwd = flash_attention(q, k, v)
        assert (fwd.float() - flash_attention_reference(q, k, v).float()
                ).abs().max().item() <= 0.02
        grads = flash_attention_bwd(q, k, v, o, g, lse)
        want = flash_attention_bwd_reference(q, k, v, o, g)
    for name, d in zip("qkv", _bwd_diff(grads, want)):
        assert d.max().item() <= 0.0625, (name, d.max().item())
        assert d.mean().item() <= 2e-5, (name, d.mean().item())


@pytest.mark.parametrize("block_impl", ["composable", "fused-train",
                                        "fused-train-res"])
def test_patch_dropout_step_on_card(cuda, block_impl):
    """A train step of the two-block ViT-L-width model with patch dropout
    0.5 on each block route: the image blocks see 289 rows, the route's
    kernels launch once a block where phase 6 of chip_smoke.py counts
    them (the 77-token text attention stays plain), and the loss and
    every gradient are finite."""
    import dataclasses

    from clip_embeds_tpu_torch.core.config import get_model_config
    from clip_embeds_tpu_torch.models.clip import CLIP
    from clip_embeds_tpu_torch.train.steps import (
        clip_train_loss, patch_dropout_generator)

    cfg = get_model_config("test-vitl-2layer", "openai")
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision,
                                                 patch_dropout=0.5))
    model = CLIP(cfg, block_impl=block_impl,
                 compute_dtype=torch.bfloat16).to(cuda).train()
    model.load_state_dict(_vitl2(cuda).state_dict())
    rows = []
    model.visual.transformer.register_forward_pre_hook(
        lambda mod, a: rows.append(a[0].shape[1]))
    rng = np.random.default_rng(41)
    ids = np.zeros((4, 77), np.int64)
    ids[:, 0], ids[:, 1:9], ids[:, 9] = 49406, rng.integers(1, 49406, 8), \
        49407
    batch = {"images": torch.from_numpy(rng.standard_normal(
        (4, 336, 336, 3)).astype(np.float32)).to(cuda),
        "texts": torch.from_numpy(ids).to(cuda)}
    counted = (fused_block, fused_block_residuals, flash_attention,
               flash_attention_bwd)
    for fn in counted:
        fn.launches = 0
    loss, _ = clip_train_loss(model, batch,
                              generator=patch_dropout_generator(0, 0, cuda))
    loss.backward()
    torch.cuda.synchronize()
    want = {"composable": (0, 0, 2, 2), "fused-train": (4, 0, 2, 2),
            "fused-train-res": (4, 4, 0, 2)}[block_impl]
    assert rows == [289]
    assert tuple(fn.launches for fn in counted) == want
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_t5_family_routes_on_card_match_plain_path(cuda):
    """The T5 / BLIP families' towers on the card in bf16 (the flash
    kernel once a block: a 3-block CLIP tower tapped at -2, an EVA-style
    tower at head dim 88, a BLIP ViT at 145 rows) against the fp32 plain
    path on the CPU; the W8A8 T5 trunk's 7 + 11 int8_linear launches a
    layer a pass."""
    from clip_embeds_tpu_torch.core.config import VisionConfig
    from clip_embeds_tpu_torch.core.factory import init_score_model
    from clip_embeds_tpu_torch.models.blip import (
        BlipConfig, BlipTextConfig, ImageReward)
    from clip_embeds_tpu_torch.models.blip2 import QFormerConfig
    from clip_embeds_tpu_torch.models.clip_t5 import CLIPT5, CLIPT5Config
    from clip_embeds_tpu_torch.models.instructblip import (
        InstructBlipConfig, InstructBlipT5)
    from clip_embeds_tpu_torch.models.quant import quantize_clip_t5_trunk
    from clip_embeds_tpu_torch.models.t5 import T5Config
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear
    from clip_embeds_tpu_torch.scores.score import ImageRewardScore
    from clip_embeds_tpu_torch.scores.vqa_score import (
        InstructBlipVQAScorer, T5VQAScorer)

    t5 = T5Config(vocab_size=512, d_model=256, d_kv=32, d_ff=512,
                  num_layers=2, num_heads=8)
    clip_cfg = CLIPT5Config(t5=t5, vision=VisionConfig(
        image_size=192, patch_size=16, width=128, layers=3, head_width=64))
    ib_cfg = InstructBlipConfig(
        vision=VisionConfig(image_size=192, patch_size=16, width=176,
                            layers=2, head_width=88, mlp_ratio=2.0),
        qformer=QFormerConfig(vocab_size=512, hidden_size=64, num_layers=2,
                              num_heads=4, intermediate_size=128,
                              encoder_hidden_size=176),
        t5=t5, num_query_tokens=4)

    def build(cls, cfg, device, dtype, seed, **kw):
        with torch.device("meta"):
            m = cls(cfg)
        return init_score_model(m, seed, device, dtype, **kw)

    def tokenize(text):
        return [2 + sum(map(ord, w)) % 500 for w in text.split()] + [1]

    rng = np.random.default_rng(43)
    images = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
              for _ in range(2)]
    texts = ["a cat", "two dogs on a red mat", "a box"]
    model = build(CLIPT5, clip_cfg, "cpu", torch.float32, 0)
    ib = build(InstructBlipT5, ib_cfg, "cpu", torch.float32, 1, t5=model.t5)
    want = T5VQAScorer(model, tokenize, device="cpu").forward_groups(
        images, [texts] * 2)
    ib_want = InstructBlipVQAScorer(ib, tokenize, tokenize,
                                    device="cpu").forward(images * 3,
                                                          texts * 2)
    # the same draws (the T5 trunk comes last in both), then the trunk
    # shared as on the CPU
    gpu = build(CLIPT5, clip_cfg, "cpu", torch.float32, 0).to(
        cuda, torch.bfloat16)
    gpu_ib = build(InstructBlipT5, ib_cfg, "cpu", torch.float32, 1).to(
        cuda, torch.bfloat16)
    gpu_ib.t5 = gpu.t5
    flash_attention.launches = 0
    got = T5VQAScorer(gpu, tokenize, device=cuda).forward_groups(
        images, [texts] * 2)
    assert flash_attention.launches == clip_cfg.tower_blocks
    np.testing.assert_allclose(np.log(got), np.log(want), atol=0.05)
    flash_attention.launches = 0
    ib_got = InstructBlipVQAScorer(gpu_ib, tokenize, tokenize,
                                   device=cuda).forward(images * 3, texts * 2)
    assert flash_attention.launches == ib_cfg.vision.layers  # one chunk
    np.testing.assert_allclose(np.log(ib_got), np.log(ib_want), atol=0.05)
    q = T5VQAScorer(quantize_clip_t5_trunk(gpu), tokenize, device=cuda)
    int8_linear.launches = 0
    got8 = q.forward_groups(images, [texts] * 2)
    assert int8_linear.launches == 7 * 2 + 11 * 2  # one chunk of 6 pairs
    np.testing.assert_allclose(np.log(got8), np.log(want), atol=0.2)
    ir_cfg = BlipConfig(
        vision=VisionConfig(image_size=192, patch_size=16, width=128,
                            layers=2, head_width=64),
        text=BlipTextConfig(vocab_size=512, hidden_size=64, num_layers=2,
                            num_heads=4, intermediate_size=128))
    ir = build(ImageReward, ir_cfg, "cpu", torch.float32, 2)
    ir_want = ImageRewardScore(ir, tokenize, image_size=192,
                               device="cpu")(images, texts)
    flash_attention.launches = 0
    ir_got = ImageRewardScore(ir.to(cuda, torch.bfloat16), tokenize,
                              image_size=192, device=cuda)(images, texts)
    assert flash_attention.launches == 2 * ir_cfg.vision.layers
    np.testing.assert_allclose(ir_got, ir_want, atol=0.1)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_linear_with_bias_at_qwen2_kv_width(cuda, mode):
    """QuantLinear with a bias at Qwen2-7B's K/V projection (3584 -> 512,
    the narrowest N a W8A8 trunk has run): bit-equal to qdot's exact
    product plus the fp32 bias, rounded to bf16; a dropped bias would not
    be."""
    from clip_embeds_tpu_torch.models.quant import QuantLinear, quantize_weight
    from clip_embeds_tpu_torch.ops.fused_block import qdot

    rng = np.random.default_rng(50)
    x = _bf16(rng, 2, 153, 3584)
    w = torch.from_numpy(rng.standard_normal((512, 3584)).astype(
        np.float32) * 0.02).to(cuda)
    lin = QuantLinear(3584, 512, mode, bias=True).to(cuda)
    lin.weight_q, lin.scale = quantize_weight(w)
    lin.bias.copy_(torch.from_numpy(0.5 * rng.standard_normal(512).astype(
        np.float32)))
    lin.act_scale.fill_(0.0213)
    with torch.inference_mode():
        got = lin(x)
    a = (lin.act_scale if mode == "static"
         else x.float().abs().amax() / 127.0)
    want = qdot(x.float(), a, lin.weight_q, lin.scale,
                lin.bias).to(torch.bfloat16)
    no_bias = qdot(x.float(), a, lin.weight_q, lin.scale,
                   None).to(torch.bfloat16)
    assert got.shape == (2, 153, 512) and torch.equal(got, want)
    assert not torch.equal(got, no_bias)


@pytest.mark.parametrize("n", [128, 641, 2555])
def test_flash_kernel_causal_head_dim_96(cuda, n):
    """Phi-3's causal trunk at head dim 96 (32 heads of 96 over ~2.5k rows
    with a square Phi-3-V image), from the trunk's [B, N, H, D] layout
    viewed as [B, H, N, D], against the plain version."""
    rng = np.random.default_rng(n)
    q, k, v = (_bf16(rng, 1, n, 4, 96).transpose(1, 2) for _ in range(3))
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_reference(q, k, v, causal=True)
    assert got.shape == want.shape == (1, 4, n, 96)
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= 0.02, diff.max().item()
    assert diff.mean().item() <= 2e-4, diff.mean().item()


def _vlm_on_card_and_cpu(family, cfg):
    """A seeded bf16 model on the card and its fp32 copy on the CPU."""
    from clip_embeds_tpu_torch.core.factory import init_vlm

    model = init_vlm(family, cfg, seed=0, device="cuda")
    ref = init_vlm(family, cfg, seed=0, device="cuda")
    return model, ref.float().cpu()


def _least_cos(a, b):
    return torch.nn.functional.cosine_similarity(
        a.float().cpu(), b.float().cpu(), dim=-1).min().item()


def test_phi3_v_on_card_matches_plain_path(cuda):
    """A tiny Phi-3-V (168-px crops: 145 tower rows; a trunk at head dim
    96) on the card: the tower takes the flash kernel once a block, the
    unmasked forward once a trunk layer more, the masked embedding none in
    the trunk; both agree with the fp32 plain path on the CPU."""
    from clip_embeds_tpu_torch.core.config import VisionConfig
    from clip_embeds_tpu_torch.models.llama import LlamaConfig
    from clip_embeds_tpu_torch.models.phi3_v import Phi3VConfig

    cfg = Phi3VConfig(
        text=LlamaConfig(vocab_size=512, hidden_size=192,
                         intermediate_size=384, num_layers=2, num_heads=2),
        vision=VisionConfig(image_size=168, patch_size=14, width=128,
                            layers=3, head_width=64))
    model, ref = _vlm_on_card_and_cpu("phi3_v", cfg)
    s = 6 * 13 + 1 + 6 * 7  # a 1 x 2 grid of 12 x 12 patches a crop
    rng = np.random.default_rng(51)
    ids = torch.from_numpy(rng.integers(2, 500, (2, 160))).long()
    ids[:, 1:1 + s] = -1
    mask = torch.ones_like(ids)
    mask[1, 150:] = 0
    px = torch.from_numpy(rng.standard_normal((2, 4, 168, 168, 3)).astype(
        np.float32))
    on = dict(ids=ids.to(cuda), px=px.to(cuda, torch.bfloat16),
              mask=mask.to(cuda))
    with torch.inference_mode():
        flash_attention.launches = 0
        got = model.embed_last_token(on["ids"], on["px"], 1, 2, on["mask"])
        assert flash_attention.launches == cfg.tower_blocks
        flash_attention.launches = 0
        logits = model(on["ids"], on["px"], 1, 2)[:, -1]
        assert flash_attention.launches == cfg.tower_blocks + 2
        want = ref.embed_last_token(ids, px, 1, 2, mask)
        want_logits = ref(ids, px, 1, 2)[:, -1]
    assert _least_cos(got, want) > 0.99
    assert _least_cos(logits, want_logits) > 0.99


def test_llava_next_on_card_matches_plain_path(cuda):
    """A tiny LLaVA-NeXT on the card: one tower call over every crop (the
    flash kernel once a block), the masked trunk plain; agrees with the
    fp32 plain path on the CPU."""
    from clip_embeds_tpu_torch.core.config import VisionConfig
    from clip_embeds_tpu_torch.models.llama import LlamaConfig
    from clip_embeds_tpu_torch.models.llava import IMAGE_TOKEN_INDEX
    from clip_embeds_tpu_torch.models.llava_next import (
        LlavaNextConfig, anyres_pack_plan)

    pins = ((168, 336), (336, 168), (336, 336))
    cfg = LlavaNextConfig(
        llama=LlamaConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2),
        vision=VisionConfig(image_size=168, patch_size=14, width=128,
                            layers=3, head_width=64),
        grid_pinpoints=pins)
    model, ref = _vlm_on_card_and_cpu("llava_next", cfg)
    rng = np.random.default_rng(52)
    plans = [anyres_pack_plan(hw, pins, 168, 14, cfg.max_features)
             for hw in ((200, 400), (300, 300))]
    ids = torch.from_numpy(rng.integers(2, 500, (2, 20))).long()
    ids[:, 1] = IMAGE_TOKEN_INDEX
    mask = torch.ones_like(ids)
    mask[1, 15:] = 0
    args = [ids, torch.from_numpy(rng.standard_normal(
        (2, 5, 168, 168, 3)).astype(np.float32))] + [
        torch.from_numpy(np.stack([getattr(p, k) for p in plans]))
        for k in ("gather", "is_newline", "valid")] + [mask]
    on = [a.to(cuda, torch.bfloat16) if a.is_floating_point() else
          a.to(cuda) for a in args]
    with torch.inference_mode():
        flash_attention.launches = 0
        got = model.embed_last_token(*on)
        assert flash_attention.launches == cfg.tower_blocks
        want = ref.embed_last_token(*args)
    assert _least_cos(got, want) > 0.99


@pytest.mark.parametrize("v25", [False, True], ids=["qwen2", "qwen2.5"])
def test_qwen_vl_on_card_matches_plain_path(cuda, v25):
    """A tiny Qwen2-VL / Qwen2.5-VL (trunk at head dim 128, GQA 2/1,
    M-RoPE) on the card: the unmasked forward takes the flash kernel once
    a trunk layer (the towers' attention is plain, as in JAX); W8A8
    Qwen2-VL runs int8_linear 7 times a layer a pass with q/k/v biases;
    each agrees with the fp32 plain path on the CPU (W8A8 with bf16)."""
    from clip_embeds_tpu_torch.models.llama import LlamaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.models.qwen2_vl import (
        Qwen25VLConfig, Qwen25VLVisionConfig, Qwen2VLConfig,
        Qwen2VLVisionConfig, get_rope_index)
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    text = LlamaConfig(vocab_size=1024, hidden_size=256,
                       intermediate_size=512, num_layers=2, num_heads=2,
                       num_kv_heads=1, rope_theta=1e6, rms_norm_eps=1e-6,
                       attention_bias=True, mrope_section=(16, 24, 24))
    ids_kw = dict(image_token_id=1000, video_token_id=1001,
                  vision_start_token_id=1002)
    if v25:
        cfg = Qwen25VLConfig(text=text, vision=Qwen25VLVisionConfig(
            depth=3, embed_dim=64, intermediate_size=128, hidden_size=256,
            num_heads=2, fullatt_block_indexes=(1,)), **ids_kw)
        family = "qwen2_5_vl"
    else:
        cfg = Qwen2VLConfig(text=text, vision=Qwen2VLVisionConfig(
            depth=2, embed_dim=64, hidden_size=256, num_heads=2), **ids_kw)
        family = "qwen2_vl"
    model, ref = _vlm_on_card_and_cpu(family, cfg)
    grid = (1, 16, 16)
    rng = np.random.default_rng(53)
    ids = rng.integers(2, 900, (2, 140))
    ids[:, 3:67] = 1000
    pos = torch.from_numpy(get_rope_index(ids, [grid] * 2, None, cfg))
    ids = torch.from_numpy(ids).long()
    patches = torch.from_numpy(rng.standard_normal((2, 256, 1176)).astype(
        np.float32))
    on = (ids.to(cuda), patches.to(cuda, torch.bfloat16), grid, None,
          pos.to(cuda))
    with torch.inference_mode():
        flash_attention.launches = 0
        got = model(*on)[:, -1]
        assert flash_attention.launches == 2
        want = ref(ids, patches, grid, None, pos)[:, -1]
    assert _least_cos(got, want) > 0.99
    if v25:
        return
    qmodel = quantize_llava_trunk(model, "dynamic")
    with torch.inference_mode():
        int8_linear.launches = 0
        got8 = qmodel(*on)[:, -1]
        assert int8_linear.launches == 7 * 2
    assert _least_cos(got8, got) > 0.95


# -- generation and CoCa -----------------------------------------------------


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n, k", [(4096, 4096), (11008, 4096),
                                  (4096, 11008)])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_linear_at_decode_rows(cuda, mode, n, k, m):
    """QuantLinear's card route at a decode step's 1 and 8 rows (one a
    prompt; the A tile boxes 128) through the 7B trunk's three projection
    shapes: bit-equal to qdot rounded to bf16."""
    from clip_embeds_tpu_torch.models.quant import QuantLinear, quantize_weight
    from clip_embeds_tpu_torch.ops.fused_block import qdot

    rng = np.random.default_rng(50 + m)
    x = _bf16(rng, m, 1, k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(
        np.float32) * 0.02).to(cuda)
    lin = QuantLinear(k, n, mode, bias=False).to(cuda)
    lin.weight_q, lin.scale = quantize_weight(w)
    lin.act_scale.fill_(0.5 * x.float().abs().max().item() / 127.0)
    with torch.inference_mode():
        got = lin(x)
    a = (lin.act_scale if mode == "static"
         else x.float().abs().amax() / 127.0)
    want = qdot(x.float(), a, lin.weight_q, lin.scale,
                None).to(torch.bfloat16)
    assert got.shape == (m, 1, n) and torch.equal(got, want)


def test_greedy_generate_on_card_matches_cpu(cuda):
    """A two-layer LLaVA at head dim 128 in bf16 on the card and its W8A8
    twin: llava_greedy_generate launches the flash kernel once a vision
    block and once a trunk layer in the prefill (none in a decode step)
    and int8_linear 7 times a layer a pass; the first token's logits
    against the fp32 plain path on the CPU, and the tokens against the
    argmax of the card model's own full forward where the margin is clear."""
    from clip_embeds_tpu_torch.core.config import VisionConfig
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.models.generate import llava_greedy_generate
    from clip_embeds_tpu_torch.models.llama import LlamaConfig
    from clip_embeds_tpu_torch.models.llava import (
        IMAGE_TOKEN_INDEX, LlavaConfig)
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    cfg = LlavaConfig(
        llama=LlamaConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2),
        vision=VisionConfig(image_size=224, patch_size=14, width=128,
                            layers=3, head_width=64))
    model = init_llava(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    ref = init_llava(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    ref = ref.float().cpu()
    rng = np.random.default_rng(42)
    ids = np.concatenate([np.ones((2, 1), np.int64),
                          np.full((2, 1), IMAGE_TOKEN_INDEX),
                          rng.integers(2, 512, (2, 10))], 1)
    px = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    ids_c = torch.from_numpy(ids).to(cuda)
    px_c = torch.from_numpy(px).to(cuda, torch.bfloat16)
    flash_attention.launches = 0
    toks = llava_greedy_generate(model, ids_c, px_c, 6)
    assert flash_attention.launches == cfg.tower_blocks + 2
    assert toks.shape == (2, 6)
    with torch.inference_mode():
        embeds = model.merge(ids_c, model.encode_images(px_c))
        lm = model.language_model
        full = lm.logits(lm.trunk(torch.cat(
            [embeds, lm.embed(toks[:, :-1])], 1))[:, embeds.shape[1] - 1:]
        ).float()
        top2 = full.topk(2, -1).values
        clear = top2[..., 0] - top2[..., 1] > 0.1
        assert torch.equal(full.argmax(-1)[clear], toks[clear])
        want = ref.language_model.logits(ref.language_model.trunk(ref.merge(
            torch.from_numpy(ids), ref.encode_images(torch.from_numpy(
                px)))))[:, -1]
    cos = torch.nn.functional.cosine_similarity(full[:, 0].cpu(), want,
                                                dim=-1)
    assert (cos > 0.99).all()
    qmodel = quantize_llava_trunk(model)
    int8_linear.launches = 0
    qtoks = llava_greedy_generate(qmodel, ids_c, px_c, 6)
    assert int8_linear.launches == 7 * 2 * 6 and qtoks.shape == (2, 6)


def test_coca_step_on_card_matches_cpu(cuda):
    """A two-layer CoCa whose tower has CoCa ViT-L/14's attention shape
    (16 heads of 64 over 257 rows) in bf16 compute on fp32 masters: a
    train step launches the flash forward and backward once a tower block
    each, the losses and gradients against the fp32 plain path on the
    CPU, and top-k 1 captions well formed."""
    from clip_embeds_tpu_torch.core.config import TextConfig, VisionConfig
    from clip_embeds_tpu_torch.core.factory import init_coca
    from clip_embeds_tpu_torch.losses.coca import coca_loss
    from clip_embeds_tpu_torch.models.coca import (
        CoCa, CoCaConfig, MultimodalConfig)
    from clip_embeds_tpu_torch.models.generate import coca_sample_generate

    cfg = CoCaConfig(
        embed_dim=256,
        vision=VisionConfig(image_size=224, patch_size=14, width=1024,
                            layers=2),
        text=TextConfig(context_length=20, vocab_size=1024, width=256,
                        heads=4, layers=2),
        multimodal=MultimodalConfig(context_length=20, width=256, heads=4,
                                    layers=2),
        attn_pooler_queries=16, attn_pooler_heads=4)
    with torch.device("meta"):
        ref = CoCa(cfg)
    ref.to_empty(device="cpu")
    init_coca(ref, torch.Generator().manual_seed(0))
    model = CoCa(cfg, compute_dtype=torch.bfloat16).to(cuda)
    model.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(43)
    texts = np.zeros((4, 20), np.int64)
    texts[:, 0], texts[:, 1:12], texts[:, 12] = 1022, rng.integers(
        1, 1000, (4, 11)), 1023
    images = rng.standard_normal((4, 224, 224, 3)).astype(np.float32)
    losses, grads = {}, {}
    for name, m, dev in (("card", model, cuda), ("cpu", ref, "cpu")):
        flash_attention.launches = flash_attention_bwd.launches = 0
        out = coca_loss(m(torch.from_numpy(images).to(dev),
                          torch.from_numpy(texts).to(dev)))
        out["loss"].backward()
        torch.cuda.synchronize()
        if name == "card":
            assert (flash_attention.launches,
                    flash_attention_bwd.launches) == (2, 2)
        losses[name] = {k: float(v) for k, v in out.items()}
        grads[name] = torch.cat([p.grad.float().cpu().flatten()
                                 for p in m.parameters()])
    for k in losses["cpu"]:
        assert abs(losses["card"][k] - losses["cpu"][k]) < 0.05 * abs(
            losses["cpu"][k]) + 0.05, k
    cos = torch.nn.functional.cosine_similarity(grads["card"],
                                                grads["cpu"], dim=0)
    assert cos > 0.99
    model.eval()
    toks = coca_sample_generate(
        model, torch.from_numpy(images).to(cuda, torch.bfloat16),
        seq_len=12, generation_type="top_k", top_k=1, sot_token_id=1022,
        eos_token_id=1023)
    assert toks.shape == (4, 12) and (toks[:, 0] == 1022).all()
    assert ((toks == 1023).any(dim=1)).all()


@pytest.mark.parametrize("hd", [72, 80, 88, 96])
def test_flash_bwd_kernel_at_padded_head_dims(cuda, hd):
    """The backward at head dims it pads to the 128-wide kernel (zero
    columns past hd), at EVA01-g-14's 257 rows (a partial last tile) and a
    ragged 200, under the limits of test_flash_bwd_kernel_matches_plain;
    each output keeps the width it was given."""
    rng = np.random.default_rng(hd)
    for shape in ((2, 16, 257, hd), (1, 3, 200, hd)):
        q, k, v, o, g, lse = _bwd_inputs(rng, shape, False)
        with torch.inference_mode():
            got = flash_attention_bwd(q, k, v, o, g, lse)
            want = flash_attention_bwd_reference(q, k, v, o, g)
            torch.cuda.synchronize()
        for name, a, d in zip("qkv", got, _bwd_diff(got, want)):
            assert a.shape == shape, (name, a.shape)
            assert d.max().item() <= 0.0625, (shape, name, d.max().item())
            assert d.mean().item() <= 2e-5, (shape, name, d.mean().item())


def test_zoo_train_step_on_card_matches_cpu(cuda):
    """A two-block EVA01 CLIP at EVA01-g-14's attention shape (16 heads of
    88 over 257 rows) in bf16 compute on fp32 masters, remat on: a train
    step launches the flash forward and backward once a tower block each
    (the text tower's 77 tokens take plain attention), and its loss and
    gradients agree with the fp32 plain path on the CPU."""
    from clip_embeds_tpu_torch.core.config import (
        CLIPConfig, TextConfig, VisionConfig)
    from clip_embeds_tpu_torch.core.factory import init_params
    from clip_embeds_tpu_torch.models.clip import CLIP
    from clip_embeds_tpu_torch.train.steps import clip_train_loss

    cfg = CLIPConfig(
        embed_dim=256,
        vision=VisionConfig(tower="eva", image_size=224, patch_size=14,
                            width=1408, layers=2, head_width=88,
                            mlp_ratio=6144 / 1408),
        text=TextConfig(width=256, heads=4, layers=2))
    ref = CLIP(cfg).train()
    init_params(ref, seed=0)
    model = CLIP(cfg, remat=True, compute_dtype=torch.bfloat16).to(cuda)
    model.load_state_dict(ref.state_dict())
    model.train()
    rng = np.random.default_rng(44)
    texts = np.zeros((4, 77), np.int64)
    texts[:, 0], texts[:, 1:12], texts[:, 12] = 49406, rng.integers(
        1, 49000, (4, 11)), 49407
    batch = {"images": rng.standard_normal((4, 224, 224, 3)).astype(
        np.float32), "texts": texts}
    losses, grads = {}, {}
    for name, m, dev in (("card", model, cuda), ("cpu", ref, "cpu")):
        flash_attention.launches = flash_attention_bwd.launches = 0
        loss, _ = clip_train_loss(m, {k: torch.from_numpy(v).to(dev)
                                      for k, v in batch.items()})
        loss.backward()
        torch.cuda.synchronize()
        if name == "card":
            # the forward once, then again in remat's recompute
            assert (flash_attention.launches,
                    flash_attention_bwd.launches) == (4, 2)
            assert all(p.grad.dtype == torch.float32
                       for p in m.parameters())
        losses[name] = loss.item()
        grads[name] = torch.cat([p.grad.float().cpu().flatten()
                                 for p in m.parameters()])
    assert abs(losses["card"] - losses["cpu"]) < 0.02 * losses["cpu"]
    cos = torch.nn.functional.cosine_similarity(grads["card"],
                                                grads["cpu"], dim=0)
    assert cos > 0.99
