"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path does not reach: ragged tiles, every head dim,
strided views, and the errors a wrapper raises. Marked ``cuda``; without a
card they skip. On the card: ``python -m pytest -m cuda tests/ -q``."""

import numpy as np
import pytest
import torch

from clip_embeds_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from clip_embeds_tpu_torch.ops.fused_block import (
    fused_block,
    fused_block_reference,
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


def _block_args(rng, b, n, d, mlp):
    ln = lambda: torch.stack([_bf16(rng, d, std=0.1, mean=1.0),
                              _bf16(rng, d, std=0.1)])
    return (_bf16(rng, b, n, d), _bf16(rng, 3 * d, d, std=d ** -0.5),
            _bf16(rng, 3 * d, std=0.02), _bf16(rng, d, d, std=0.05),
            _bf16(rng, d, std=0.02), _bf16(rng, mlp, d, std=(2 * d) ** -0.5),
            _bf16(rng, mlp, std=0.02), _bf16(rng, d, mlp, std=0.05),
            _bf16(rng, d, std=0.02), ln(), ln())


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
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(w, q, q)
    args = _block_args(rng, 1, 16, 64, 256)
    with pytest.raises(ValueError):  # head dim 16
        fused_block(*args, heads=4, kv_valid=16)
    with pytest.raises(TypeError):
        fused_block(*(a.float() for a in args), heads=2, kv_valid=16)
