"""Port ops against the JAX package's Pallas kernels (interpret mode on the
CPU): the plain fused_block and flash_attention, and attention routing."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.ops import flash_attention as jax_fa
from clip_embeds_tpu.ops import fused_block as jax_fb
from clip_embeds_tpu_torch.ops.attention import (
    dot_product_attention,
    flash_eligible,
    reference_attention,
)
from clip_embeds_tpu_torch.ops.flash_attention import flash_attention
from clip_embeds_tpu_torch.ops.fused_block import (
    fused_block,
    fused_block_reference,
    fused_block_supported,
)


def _pallas_interpret(monkeypatch):
    """Route pallas_call through the interpreter (no TPU in tests)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _block_weights(rng, d, mlp):
    """JAX-layout fused_block weights, std 0.05 (logits far below the
    Pallas kernel's clamp at 75)."""
    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    ln = lambda: np.stack([1 + w(d), w(d)])
    return [w(d, 3 * d), w(3 * d), w(d, d), w(d), w(d, mlp), w(mlp),
            w(mlp, d), w(d), ln(), ln()]


@pytest.mark.parametrize("act", ["quick", "erf", "tanh"])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_block_matches_pallas(act, causal):
    rng = np.random.default_rng(0)
    b, n, d, heads, mlp, kv_valid = 2, 16, 64, 4, 128, 13
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    ws = _block_weights(rng, d, mlp)
    want = jax_fb.fused_block(
        jnp.asarray(x), *map(jnp.asarray, ws), heads=heads,
        kv_valid=kv_valid, causal=causal, act=act, interpret=True)
    # the port takes [out, in] weights (open_clip layout)
    t = [torch.from_numpy(a) for a in ws]
    for i in (0, 2, 4, 6):
        t[i] = t[i].t().contiguous()
    got = fused_block(torch.from_numpy(x), *t, heads=heads,
                      kv_valid=kv_valid, causal=causal, act=act)
    # fp32 both sides; rows past kv_valid are padding, but both compute them
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    ref = fused_block_reference(torch.from_numpy(x), *t, heads=heads,
                                kv_valid=kv_valid, causal=causal, act=act)
    assert torch.equal(got, ref)  # CPU tensors take the plain version


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape", [(2, 4, 128, 64), (1, 2, 77, 64), (1, 3, 577, 64)])
def test_flash_attention_matches_pallas(monkeypatch, causal, shape):
    _pallas_interpret(monkeypatch)
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    want = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal)
    # fp32 on both sides; only the summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def _fake(shape, is_cuda=True, dtype=torch.bfloat16, requires_grad=False):
    return types.SimpleNamespace(shape=shape, is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("q, mask, want", [
    (_fake((2, 16, 577, 64)), None, True),          # ViT-L/14-336 tokens
    (_fake((2, 12, 77, 64)), None, False),          # text: N < 128
    (_fake((2, 2, 128, 256)), None, False),         # head dim > 128
    (_fake((2, 16, 577, 64)), object(), False),     # explicit mask
    (_fake((2, 16, 577, 64), dtype=torch.float32), None, False),
    (_fake((2, 16, 577, 64), requires_grad=True), None, True),  # training
    (_fake((2, 16, 577, 64), is_cuda=False), None, False),
])
def test_dot_product_attention_routes_by_shape(q, mask, want):
    assert flash_eligible(q, mask) is want


def test_dot_product_attention_cpu_paths_agree():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 130, 32)).astype(
        np.float32)) for _ in range(3))
    ref = reference_attention(q, k, v, causal=True)
    assert torch.equal(dot_product_attention(q, k, v, causal=True), ref)
    flash = dot_product_attention(q, k, v, causal=True, impl="flash")
    torch.testing.assert_close(flash, ref, rtol=1e-5, atol=1e-5)
    mask = torch.from_numpy(rng.random((1, 1, 130, 130)) > 0.3)
    mask[..., 0] = True
    masked = dot_product_attention(q, k, v, mask=mask)
    torch.testing.assert_close(
        masked, reference_attention(q, k, v, mask=mask), rtol=0, atol=0)


def test_fused_block_supported_gates():
    assert fused_block_supported(592, 1024, 16, 4.0)   # ViT-L/14-336
    assert fused_block_supported(80, 768, 12, 4.0)     # its text tower
    assert fused_block_supported(80, 768, 16, 4.0)     # head dim 48
    # SigLIP SO400M: head dim 72, MLP width 4304 (% 32 = 16), both dtypes
    assert fused_block_supported(736, 1152, 16, 4304 / 1152)
    assert fused_block_supported(736, 1152, 16, 4304 / 1152, int8=True)
    assert not fused_block_supported(80, 100, 2, 4.0)   # width % 8
    assert not fused_block_supported(80, 1024, 4, 4.0)  # head dim 256
    assert not fused_block_supported(80, 96, 8, 4.0)    # head dim 12 % 8
    # MLP width 200: whole bf16 rows (% 8), not whole int8 ones (% 16)
    assert fused_block_supported(80, 64, 2, 200 / 64)
    assert not fused_block_supported(80, 64, 2, 200 / 64, int8=True)
