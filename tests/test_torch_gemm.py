"""The port's plain GEMM (``gemm_reference``, the plain version of the
``cet_gemm`` kernel behind fused_block and fused_block_residuals) against
the JAX package's fused-block projection: ``_dot`` (fp32 sums), the bias in
fp32, ``_apply_act`` and the ``astype`` rounding points of ``_kernel`` and
``_kernel_res``, on the same seed-made numpy inputs, for each epilogue and
activation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.ops import fused_block as jax_fb
from clip_embeds_tpu_torch.ops.fused_block import (
    _EPI_ACT,
    _EPI_BIAS,
    _EPI_RESIDUAL,
    gemm_reference,
)

M, K, N = 37, 96, 40  # ragged rows; K and N as the kernel takes them

# (epilogue, pre): the kernel's four, EPI_BIAS_ACT_PRE being the
# activation epilogue that also returns the pre-activation
EPILOGUES = {"bias": (_EPI_BIAS, False), "act": (_EPI_ACT, False),
             "residual": (_EPI_RESIDUAL, False), "act_pre": (_EPI_ACT, True)}


def _jax_gemm(a, w, bias, res, epi, act, pre, dt):
    """The JAX kernels' projection: w in their [in, out] layout."""
    v = jax_fb._dot(a, w) + bias.astype(jnp.float32)
    if epi == _EPI_ACT:
        out = jax_fb._apply_act(v, act).astype(dt)
    elif epi == _EPI_RESIDUAL:
        out = res + v.astype(dt)
    else:
        out = v.astype(dt)
    return (out, v.astype(dt)) if pre else (out,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["quick", "erf", "tanh"])
@pytest.mark.parametrize("name", list(EPILOGUES))
def test_gemm_reference_matches_jax(name, act, dtype):
    epi, pre = EPILOGUES[name]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K)).astype(np.float32)
    w = (K ** -0.5 * rng.standard_normal((N, K))).astype(np.float32)
    bias = (0.5 * rng.standard_normal(N)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    got = gemm_reference(*(torch.from_numpy(t).to(tdt)
                           for t in (a, w, bias, res)), epi, act, pre=pre)
    got = got if pre else (got,)
    want = _jax_gemm(*(jnp.asarray(t, jdt) for t in (a, w.T, bias, res)),
                     epi, act, pre, jdt)
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        assert g.dtype == tdt and g.shape == (M, N)
        g = g.float().numpy()
        wnt = np.asarray(wnt.astype(jnp.float32))
        if dtype == "float32":
            # fp32 sums of 96 products taken in another order
            np.testing.assert_allclose(g, wnt, rtol=1e-5, atol=1e-5)
        else:
            # the same bf16 inputs and rounding points: the fp32 sums differ
            # in order only, so a rounding of the sum (2^-7 of |sum| at
            # most) and of the output (2^-7 of |out|) may fall apart, rarely
            diff = np.abs(g - wnt)
            step = 2.0 ** -7 * (np.abs(wnt) + np.abs(a @ w.T + bias))
            assert (diff <= step + 1e-6).all(), diff.max()
            assert (diff > 0).mean() <= 0.01
