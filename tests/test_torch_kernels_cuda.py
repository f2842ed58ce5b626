"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path does not reach: ragged tiles, every head dim,
strided views, a zero weight row (int8), the training kernels (attention
backward, fused_block_residuals) at ViT-L and text shapes, inf and NaN in
the keys past kv_valid, a backward that repeats bit for bit, and the errors
a wrapper raises.
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
    fused_block,
    fused_block_int8,
    fused_block_int8_reference,
    fused_block_reference,
    fused_block_residuals,
    fused_block_residuals_reference,
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


def _block_args(rng, b, n, d, mlp, bias_std=0.02):
    ln = lambda: torch.stack([_bf16(rng, d, std=0.1, mean=1.0),
                              _bf16(rng, d, std=0.1)])
    return (_bf16(rng, b, n, d), _bf16(rng, 3 * d, d, std=d ** -0.5),
            _bf16(rng, 3 * d, std=bias_std), _bf16(rng, d, d, std=0.05),
            _bf16(rng, d, std=bias_std),
            _bf16(rng, mlp, d, std=(2 * d) ** -0.5),
            _bf16(rng, mlp, std=bias_std), _bf16(rng, d, mlp, std=0.05),
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
    with pytest.raises(ValueError):  # head dim 16
        fused_block(*args, heads=4, kv_valid=16)
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
    with pytest.raises(ValueError):  # head dim 16
        fused_block_int8(*args, heads=4, kv_valid=16)


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
