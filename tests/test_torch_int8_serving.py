"""The port's W8A8 serving path against the JAX package, fp32 on the CPU:
the plain fused_block_int8 against the Pallas kernel (interpret mode), the
calibrated int8 towers, and fused_encode_image_int8 / fused_encode_text_int8
on the same weights and the same calibration inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.models import serving as jax_serving
from clip_embeds_tpu.ops import fused_block as jax_fb
from clip_embeds_tpu_torch.core.convert import (
    load_open_clip_state_dict,
    state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.models.serving import (
    INT8_BLOCK_ARGS,
    fused_encode_image_int8,
    fused_encode_text_int8,
    prepare_int8_text_tower,
    prepare_int8_tower,
)
from clip_embeds_tpu_torch.models.quant import quantize_weight
from clip_embeds_tpu_torch.ops.fused_block import (
    fused_block_int8,
    fused_block_int8_reference,
)
from test_torch_ops import _pallas_interpret

_WEIGHTS = ("wqkv_q", "wo_q", "w1_q", "w2_q")


def _ids(rng, b, ctx):
    """Token ids with an EOT (the argmax) at a random position."""
    ids = rng.integers(1, 400, (b, ctx))
    for row, length in zip(ids, rng.integers(3, 20, b)):
        row[0], row[length - 1], row[length:] = 49406, 49407, 0
    return ids.astype(np.int32)


@pytest.fixture(scope="module")
def towers():
    """JAX and port test-tiny CLIPs on one set of weights, each with its
    image and text tower calibrated on the same pixels and ids."""
    jm, jp = jax_create_model("test-tiny", pretrained="openai", seed=1,
                              attn_impl="reference")
    jp = jax.tree.map(np.asarray, jp)
    tm = create_model("test-tiny", pretrained="openai")
    load_open_clip_state_dict(tm, state_dict_from_jax_params(jp))
    rng = np.random.default_rng(0)
    calib_px = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    calib_ids = _ids(rng, 4, tm.cfg.text.context_length)
    jq_img = jax_serving.prepare_int8_tower(jm, jp, jnp.asarray(calib_px))
    jq_txt = jax_serving.prepare_int8_text_tower(jm, jp,
                                                 jnp.asarray(calib_ids))
    tq_img = prepare_int8_tower(tm, torch.from_numpy(calib_px))
    tq_txt = prepare_int8_text_tower(tm, torch.from_numpy(calib_ids).long())
    return dict(jm=jm, jp=jp, tm=tm, jq_img=jq_img, jq_txt=jq_txt,
                tq_img=tq_img, tq_txt=tq_txt)


@pytest.mark.parametrize("tower", ["img", "txt"])
def test_prepared_towers_match_jax(towers, tower):
    jq, tq = towers[f"jq_{tower}"], towers[f"tq_{tower}"]
    assert len(jq["blocks"]) == len(tq["blocks"]) == 2
    for jb, tb in zip(jq["blocks"], tq["blocks"]):
        for name in _WEIGHTS:  # JAX [in, out] == port [out, in] transposed
            assert tb[name].dtype == torch.int8
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]).T)
        for name in ("sqkv", "so", "s1", "s2", "bqkv", "bo", "b1", "b2"):
            assert tb[name].dtype == torch.float32
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]))
        # the same activations up to fp32 summation order
        np.testing.assert_allclose(tb["act_scales"].numpy(),
                                   np.asarray(jb["act_scales"]), rtol=1e-5)


def _int8_block_inputs(rng, d, mlp):
    """Random fp weights quantised by the port ([out, in], one row all
    zero) and the same values in the JAX [in, out] layout, with static
    activation scales of the size a calibration gives."""
    def w(*shape, std=0.05):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    fp = [w(3 * d, d, std=d ** -0.5), w(d, d), w(mlp, d, std=(2 * d) ** -0.5),
          w(d, mlp)]
    biases = [w(3 * d, std=0.02), w(d, std=0.02), w(mlp, std=0.02),
              w(d, std=0.02)]
    fp[1][3] = 0.0  # a zero row: scale 1.0, codes 0
    port = {}
    for (qn, sn, bn), wt, bias in zip(
            (("wqkv_q", "sqkv", "bqkv"), ("wo_q", "so", "bo"),
             ("w1_q", "s1", "b1"), ("w2_q", "s2", "b2")), fp, biases):
        q, s = quantize_weight(torch.from_numpy(wt))
        port.update({qn: q, sn: s, bn: torch.from_numpy(bias)})
    ln = lambda: np.stack([1 + w(d, std=0.1), w(d, std=0.1)])
    port["ln1"], port["ln2"] = torch.from_numpy(ln()), torch.from_numpy(ln())
    # act scales as a calibration would give them (abs-max / 127)
    port["act_scales"] = torch.tensor([0.03, 0.01, 0.03, 0.02])
    jax_args = [np.asarray(port[n]).T if n in _WEIGHTS else np.asarray(port[n])
                for n in INT8_BLOCK_ARGS]
    return [port[n] for n in INT8_BLOCK_ARGS], jax_args


@pytest.mark.parametrize("causal, kv_valid", [(False, 13), (True, 16)])
@pytest.mark.parametrize("act", ["quick", "erf"])
def test_fused_block_int8_matches_pallas(monkeypatch, causal, kv_valid, act):
    _pallas_interpret(monkeypatch)
    rng = np.random.default_rng(2)
    b, n, d, heads, mlp = 2, 16, 64, 4, 256
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    port, jargs = _int8_block_inputs(rng, d, mlp)
    want = np.asarray(jax_fb.fused_block_int8(
        jnp.asarray(x), *map(jnp.asarray, jargs), heads=heads,
        kv_valid=kv_valid, causal=causal, act=act, interpret=True))
    got = fused_block_int8(torch.from_numpy(x), *port, heads=heads,
                           kv_valid=kv_valid, causal=causal, act=act)
    ref = fused_block_int8_reference(torch.from_numpy(x), *port, heads=heads,
                                     kv_valid=kv_valid, causal=causal,
                                     act=act)
    assert torch.equal(got, ref)  # CPU tensors take the plain version
    diff = np.abs(got.numpy() - want)[:, :kv_valid]
    # fp32 both sides with exact int8 sums: only summation order differs
    # (LN stats, attention), so most values agree to 1e-5; where it moves
    # an activation across a .5 rounding boundary, one code of the next
    # projection moves, by at most a * max|W| = 0.03 * 0.2
    assert np.mean(diff > 1e-5) < 0.01, np.mean(diff > 1e-5)
    assert diff.max() < 0.03 * 0.2, diff.max()


@pytest.mark.parametrize("cls_fast_last", [True, False])
def test_fused_encode_image_int8_matches_jax(monkeypatch, towers,
                                             cls_fast_last):
    _pallas_interpret(monkeypatch)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jax_serving.fused_encode_image_int8(
        towers["jm"], towers["jp"], towers["jq_img"], jnp.asarray(images),
        dtype=jnp.float32, interpret=True, cls_fast_last=cls_fast_last)
    with torch.no_grad():
        got = fused_encode_image_int8(towers["tm"], towers["tq_img"],
                                      torch.from_numpy(images),
                                      dtype=torch.float32,
                                      cls_fast_last=cls_fast_last)
    # same int8 weights, act scales equal to rtol 1e-5: fp32 order only
    # (measured < 2e-7); a moved int8 code would show as ~1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_fused_encode_image_int8_output_tokens(monkeypatch, towers):
    _pallas_interpret(monkeypatch)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want_p, want_t = jax_serving.fused_encode_image_int8(
        towers["jm"], towers["jp"], towers["jq_img"], jnp.asarray(images),
        dtype=jnp.float32, interpret=True, output_tokens=True)
    with torch.no_grad():
        got_p, got_t = fused_encode_image_int8(
            towers["tm"], towers["tq_img"], torch.from_numpy(images),
            dtype=torch.float32, output_tokens=True)
    assert got_t.shape == want_t.shape == (2, 4, 64)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                               rtol=1e-4, atol=1e-4)


def test_fused_encode_text_int8_matches_jax(monkeypatch, towers):
    _pallas_interpret(monkeypatch)
    rng = np.random.default_rng(5)
    ids = _ids(rng, 3, towers["tm"].cfg.text.context_length)
    want = jax_serving.fused_encode_text_int8(
        towers["jm"], towers["jp"], towers["jq_txt"], jnp.asarray(ids),
        dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        got = fused_encode_text_int8(towers["tm"], towers["tq_txt"],
                                     torch.from_numpy(ids).long(),
                                     dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-5)
