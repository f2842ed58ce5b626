"""The port's plain int8 GEMM (``gemm_s8_reference``, the plain version of
the ``cet_gemm_s8`` kernel behind fused_block_int8) against the JAX
package's W8A8 projection: ``_qdot`` (weights in its ``[in, out]`` layout),
with ``_kernel_int8``'s ``astype`` and residual add, and for the
activation epilogue ``_apply_act`` and the next ``_qdot``'s quantisation,
on the same seed-made numpy inputs, for each epilogue and activation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.ops import fused_block as jax_fb
from clip_embeds_tpu_torch.ops.fused_block import (
    _EPI_Q_ACT_Q8,
    _EPI_Q_BF16,
    _EPI_Q_RESIDUAL,
    gemm_s8_reference,
)

M, K, N = 37, 96, 48  # ragged rows; K and N as the kernel takes them
# qkv, out, fc, proj: each epilogue's projection reads a[a_idx]; the
# activation epilogue quantises with a[a_idx + 1]
ACT_SCALES = np.array([0.021, 0.034, 0.027, 0.0315], np.float32)
EPILOGUES = {"bf16": (_EPI_Q_BF16, 0), "residual": (_EPI_Q_RESIDUAL, 1),
             "act_q8": (_EPI_Q_ACT_Q8, 2)}


def _inputs(rng):
    """int8 codes of A and W, fp32 per-column scales (sums of std ~1.5),
    biases of std 0.5, a bf16 residual."""
    a_q = np.clip(np.round(40 * rng.standard_normal((M, K))), -127, 127)
    w_q = np.clip(np.round(40 * rng.standard_normal((N, K))), -127, 127)
    wscale = ((1 + 0.1 * rng.standard_normal(N)) / (30 * K ** 0.5)
              ).astype(np.float32)
    bias = (0.5 * rng.standard_normal(N)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    return a_q.astype(np.int8), w_q.astype(np.int8), wscale, bias, res


def _jax_gemm_s8(a_q, w_q, wscale, bias, res, epi, a_idx, act):
    """The Pallas block's projection: ``_qdot`` on fp32 activations whose
    codes are ``a_q`` (``round(a_q * a / a) = a_q``)."""
    a = jnp.asarray(ACT_SCALES)
    x32 = jnp.asarray(a_q, jnp.float32) * a[a_idx]
    v = jax_fb._qdot(x32, a[a_idx], jnp.asarray(w_q.T),
                     jnp.asarray(wscale).reshape(1, -1),
                     jnp.asarray(bias).reshape(1, -1))
    if epi == _EPI_Q_ACT_Q8:
        m = jax_fb._apply_act(v, act)
        return jnp.clip(jnp.round(m / a[a_idx + 1]), -127, 127).astype(
            jnp.int8)
    if epi == _EPI_Q_RESIDUAL:
        return jnp.asarray(res, jnp.bfloat16) + v.astype(jnp.bfloat16)
    return v.astype(jnp.bfloat16)


@pytest.mark.parametrize("act", ["quick", "erf", "tanh"])
@pytest.mark.parametrize("name", list(EPILOGUES))
def test_gemm_s8_reference_matches_jax(name, act):
    epi, a_idx = EPILOGUES[name]
    rng = np.random.default_rng(0)
    a_q, w_q, wscale, bias, res = _inputs(rng)
    # the codes come back from _qdot's quantisation unchanged
    a = ACT_SCALES[a_idx]
    assert (np.round((a_q * a).astype(np.float32) / a) == a_q).all()

    got = gemm_s8_reference(
        torch.from_numpy(a_q), torch.from_numpy(w_q),
        torch.from_numpy(wscale), torch.from_numpy(bias),
        torch.from_numpy(ACT_SCALES), a_idx,
        torch.from_numpy(res).bfloat16(), epi, act)
    want = np.asarray(_jax_gemm_s8(a_q, w_q, wscale, bias, res, epi, a_idx,
                                   act).astype(jnp.float32))
    assert got.shape == (M, N)
    if epi == _EPI_Q_ACT_Q8:
        assert got.dtype == torch.int8
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        # exact sums on both sides; the fp32 steps and the activation may
        # round apart, which moves a code at a .5 boundary by one
        assert diff.max() <= 1 and (diff > 0).sum() <= 1, diff.sum()
        assert np.abs(want).max() > 64  # the codes span the range
        return
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # the same exact sums and fp32 steps; a fused multiply-add on one side
    # may move the rounding to bf16 by one step of the output's binade
    step = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert (np.abs(got - want) <= step).all(), np.abs(got - want).max()
