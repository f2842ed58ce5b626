"""The port's training kernels' plain versions and their autograd wiring
against the JAX package's Pallas kernels (interpret mode on the CPU): the
flash-attention backward, the flash-attention custom VJP, the
fused_block_residuals outputs and the FusedTrainBlock gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.models.layers import FusedTrainBlock as JaxFusedBlock
from clip_embeds_tpu.ops import flash_attention as jax_fa
from clip_embeds_tpu.ops import fused_block as jax_fb
from clip_embeds_tpu_torch.core.convert import _transformer
from clip_embeds_tpu_torch.models.layers import FusedTrainBlock
from clip_embeds_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from clip_embeds_tpu_torch.ops.fused_block import (
    fused_block_residuals,
    fused_block_residuals_reference,
)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route pallas_call through the interpreter (no TPU in tests)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _qkvog(rng, shape, causal, dtype=np.float32):
    """q, k, v, dO from a seed and o the forward's output, as numpy."""
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    if dtype != np.float32:  # round to bf16 once, give both sides the same
        q, k, v, g = (torch.from_numpy(a).bfloat16().float().numpy()
                      for a in (q, k, v, g))
    o = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal).numpy()
    return q, k, v, o, g


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [16, 77, 130])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_reference_matches_pallas_fp32(pallas_interpret, causal,
                                                 n, d):
    rng = np.random.default_rng(n + d)
    arrs = _qkvog(rng, (2, 2, n, d), causal)
    want = jax_fa._flash_attention_bwd_impl(
        *map(jnp.asarray, arrs), causal, jax_fa._pick_block_q(n))
    got = flash_attention_bwd_reference(
        *(torch.from_numpy(a) for a in arrs), causal)
    for name, a, b in zip("qkv", got, want):
        # fp32 on both sides; only the order of the sums differs
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("n", [16, 77, 130])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_reference_matches_pallas_bf16(pallas_interpret, causal,
                                                 n):
    rng = np.random.default_rng(n)
    arrs = _qkvog(rng, (2, 2, n, 64), causal, dtype="bf16")
    want = jax_fa._flash_attention_bwd_impl(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), causal,
        jax_fa._pick_block_q(n))
    got = flash_attention_bwd_reference(
        *(torch.from_numpy(a).bfloat16() for a in arrs), causal)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, name
        b = np.asarray(b.astype(jnp.float32))
        # one bf16 ulp (2^-7 relative) of the output's largest magnitude:
        # the two sides round P and dS to bf16 from fp32 values summed in
        # another order, and the outputs once more
        ulp = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=ulp,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [(2, 2, 130, 32), (1, 3, 77, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_jax_grad(pallas_interpret, shape, causal):
    """The CPU autograd Function (plain forward and backward, saved
    tensors, causal, ragged N, q/k/v as strided views of a packed qkv)
    against jax.grad of the JAX flash_attention custom VJP."""
    rng = np.random.default_rng(3)
    b, h, n, d = shape
    qkv = rng.standard_normal((b, n, 3, h, d)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    def jax_loss(qkv_):
        q, k, v = jnp.transpose(qkv_, (2, 0, 3, 1, 4))
        return (jax_fa.flash_attention(q, k, v, causal) * g).sum()

    want = jax.grad(jax_loss)(jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_()
    q, k, v = t.permute(2, 0, 3, 1, 4)
    out = flash_attention(q, k, v, causal)
    assert out.grad_fn is not None and "Flash" in type(out.grad_fn).__name__
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_bwd_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    arrs = [torch.from_numpy(a) for a in _qkvog(rng, (1, 2, 20, 32), True)]
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*arrs, None, True)
    want = flash_attention_bwd_reference(*arrs, True)
    assert flash_attention_bwd.launches == before  # no kernel on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _jax_block_weights(rng, d, mlp, bias_std=0.05):
    """JAX-layout ([in, out]) block weights, std 0.05: logits far below the
    Pallas kernel's clamp at 75."""
    def w(*shape, std=0.05):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    ln = lambda: np.stack([1 + w(d), w(d)])
    return [w(d, 3 * d), w(3 * d, std=bias_std), w(d, d),
            w(d, std=bias_std), w(d, mlp), w(mlp, std=bias_std), w(mlp, d),
            w(d, std=bias_std), ln(), ln()]


@pytest.mark.parametrize("act", ["quick", "erf"])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_block_residuals_matches_pallas(act, causal):
    rng = np.random.default_rng(5)
    b, n, d, heads, mlp, kv_valid = 2, 16, 64, 4, 128, 13
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    ws = _jax_block_weights(rng, d, mlp, bias_std=0.5)
    want = jax_fb.fused_block_residuals(
        jnp.asarray(x), *map(jnp.asarray, ws), heads=heads,
        kv_valid=kv_valid, causal=causal, act=act, interpret=True)
    t = [torch.from_numpy(a) for a in ws]
    for i in (0, 2, 4, 6):  # the port takes [out, in] weights
        t[i] = t[i].t().contiguous()
    kw = dict(heads=heads, kv_valid=kv_valid, causal=causal, act=act)
    got = fused_block_residuals(torch.from_numpy(x), *t, **kw)
    ref = fused_block_residuals_reference(torch.from_numpy(x), *t, **kw)
    names = ("y", "qkv", "att", "m1", "x_mid")
    for name, a, r, w in zip(names, got, ref, want):
        assert torch.equal(a, r), name  # CPU tensors: the plain version
        # fp32 both sides; rows past kv_valid are padding, computed by both
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def _jax_block_tree(rng, d, mlp):
    wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = _jax_block_weights(
        rng, d, mlp, bias_std=0.1)
    dense = lambda k, b_: {"kernel": jnp.asarray(k), "bias": jnp.asarray(b_)}
    lnp = lambda a: {"scale": jnp.asarray(a[0]), "bias": jnp.asarray(a[1])}
    return {"ln_1": lnp(ln1), "ln_2": lnp(ln2),
            "attn": {"in_proj": dense(wqkv, bqkv),
                     "out_proj": dense(wo, bo)},
            "mlp": {"c_fc": dense(w1, b1), "c_proj": dense(w2, b2)}}


def _as_port(tree):
    """A JAX block tree (params or gradients) in the port's layout, through
    core/convert.py's transformer mapping."""
    sd = _transformer({"resblocks_0": jax.tree.map(np.asarray, tree)}, "t")
    return {k[len("t.resblocks.0."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("bwd_impl", ["vjp", "residual"])
@pytest.mark.parametrize("act", ["quick", "erf"])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_train_block_matches_jax(pallas_interpret, bwd_impl, act,
                                       causal):
    b, n, d, heads = 2, 11, 64, 4
    rng = np.random.default_rng(6)
    x = (0.5 * rng.standard_normal((b, n, d))).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    tree = _jax_block_tree(rng, d, 4 * d)
    jblock = JaxFusedBlock(d, heads, quick_gelu=act == "quick",
                           interpret=True, bwd_impl=bwd_impl)

    def jax_loss(p, x_):
        y = jblock.apply({"params": p}, x_, causal)
        return (y * g).sum(), y

    (_, y_want), (dp_want, dx_want) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(tree, jnp.asarray(x))

    block = FusedTrainBlock(d, heads, quick_gelu=act == "quick",
                            bwd_impl=bwd_impl)
    block.load_state_dict(_as_port(tree))
    xt = torch.from_numpy(x).requires_grad_()
    y = block(xt, causal)
    names = [k for k, _ in block.named_parameters()]
    grads = torch.autograd.grad(y, [xt, *block.parameters()],
                                torch.from_numpy(g))
    # fp32 both sides: the same formulas, sums in another order
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(dx_want),
                               rtol=1e-4, atol=1e-4)
    want = _as_port(dp_want)
    for name, got in zip(names, grads[1:]):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
