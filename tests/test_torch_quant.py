"""The port's int8 quantisation (models/quant.py) and its --int8 entry points
against the JAX package, fp32 on the CPU, on shared weights and numpy
inputs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.cli.embed import main as jax_embed_main
from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu.models import quant as jax_quant
from clip_embeds_tpu_torch.cli import validate_int8
from clip_embeds_tpu_torch.cli.embed import main as embed_main
from clip_embeds_tpu_torch.core.convert import (
    load_open_clip_state_dict,
    state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.models.quant import (
    QuantLinear,
    calibrate_act_scales,
    cast_floating,
    quant_layers,
    quantize_model,
    quantize_weight,
)
from test_torch_embed_cli import _cos, _mk_images, checkpoint  # noqa: F401


@pytest.mark.parametrize("shape", [(96, 64), (64, 256), (7, 5)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)   # [out, in]
    w[2] = 0.0                                          # a zero row
    w[3, 1] = 0.5 * np.abs(w[3]).max()                  # a .5 code
    q, scale = quantize_weight(torch.from_numpy(w))
    jq, jscale = jax_quant.quantize_weight(w.T)         # [in, out]
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq.T)      # bit for bit
    np.testing.assert_array_equal(scale.numpy(), jscale)
    assert scale[2] == 1.0 and not q[2].any()


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quant_linear_matches_quant_dense(mode):
    rng = np.random.default_rng(1)
    w = (0.05 * rng.standard_normal((48, 64))).astype(np.float32)
    b = (0.02 * rng.standard_normal(48)).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    q, scale = quantize_weight(torch.from_numpy(w))
    lin = QuantLinear(64, 48, mode)
    lin.weight_q.copy_(q)
    lin.scale.copy_(scale)
    lin.bias.copy_(torch.from_numpy(b))
    params = {"kernel_q": q.numpy().T, "scale": scale.numpy(), "bias": b}
    if mode == "static":
        lin.act_scale.fill_(0.02)
        params["act_scale"] = np.float32(0.02)
    want, state = jax_quant.QuantDense(48, mode=mode).apply(
        {"params": params}, jnp.asarray(x), mutable=["quant_obs"])
    with torch.no_grad():
        got = lin(torch.from_numpy(x))
    # identical int8 codes and exact int32 sums; the dequantisation is the
    # same fp32 ops in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if mode == "dynamic":  # the running abs-max is flax's sown act_max
        assert float(lin.act_max) == float(state["quant_obs"]["act_max"])
    else:
        assert float(lin.act_max) == 0.0


def _pair(seed=1):
    jm, jp = jax_create_model("test-tiny", seed=seed, attn_impl="reference")
    jp = jax.tree.map(np.asarray, jp)
    tm = create_model("test-tiny")
    load_open_clip_state_dict(tm, state_dict_from_jax_params(jp))
    return jm, jp, tm


def _inputs(seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49000, (4, 77)).astype(np.int32)
    return images, texts


def _features(out):
    return {k: np.asarray(out[k]) for k in ("image_features",
                                             "text_features")}


def test_dynamic_quant_clip_matches_jax():
    """Counterpart of tests/test_quant.py test_quantized_clip_close_to_fp."""
    jm, jp, tm = _pair()
    images, texts = _inputs(1)
    qm = JaxCLIP(jm.cfg, attn_impl="reference", quant=True)
    want = _features(qm.apply({"params": jax_quant.quantize_dense_tree(jp)},
                              jnp.asarray(images), jnp.asarray(texts)))
    fp = _features(jm.apply({"params": jp}, jnp.asarray(images),
                            jnp.asarray(texts)))
    q = quantize_model(tm, "dynamic")
    assert q.visual.transformer.resblocks[0].attn.in_proj.weight_q.dtype \
        == torch.int8
    assert "conv1.weight" in dict(q.visual.named_parameters())  # stays fp
    with torch.no_grad():
        got = {k: v.numpy() for k, v in q(torch.from_numpy(images),
                                          torch.from_numpy(texts).long())
               .items() if k in want}
    for key in want:
        # fp32 both sides, same codes: summation order only
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5)
        assert (got[key] * fp[key]).sum(-1).min() > 0.98


def test_static_calibration_matches_jax():
    """Counterpart of tests/test_quant.py test_static_calibration_matches_
    dynamic: the same act_scales, then the same static outputs."""
    jm, jp, tm = _pair()
    images, texts = _inputs(2)
    qdyn = JaxCLIP(jm.cfg, attn_impl="reference", quant="dynamic")
    qparams = jax_quant.quantize_dense_tree(jp)
    sparams = jax_quant.calibrate_act_scales(
        qdyn, qparams, [(jnp.asarray(images), jnp.asarray(texts))])
    qstat = JaxCLIP(jm.cfg, attn_impl="reference", quant="static")
    want = _features(qstat.apply({"params": sparams}, jnp.asarray(images),
                                 jnp.asarray(texts)))

    q = quantize_model(tm, "dynamic")
    batch = (torch.from_numpy(images), torch.from_numpy(texts).long())
    calibrate_act_scales(q, [batch])
    assert all(layer.mode == "static" for layer in quant_layers(q))
    blk = sparams["visual"]["transformer"]["resblocks_0"]
    for name, layer in (("in_proj", q.visual.transformer.resblocks[0]
                         .attn.in_proj),
                        ("out_proj", q.visual.transformer.resblocks[0]
                         .attn.out_proj)):
        np.testing.assert_allclose(float(layer.act_scale),
                                   float(blk["attn"][name]["act_scale"]),
                                   rtol=1e-5)
    with torch.no_grad():
        got = q(*batch)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-5)


def test_quantize_model_keeps_fp32_scales_in_bf16():
    _, _, tm = _pair()
    q = quantize_model(tm, "dynamic", torch.bfloat16)
    lin = q.transformer.resblocks[1].mlp.c_fc
    assert q.visual.proj.dtype == torch.bfloat16
    assert lin.scale.dtype == lin.bias.dtype == torch.float32
    # quantised from the fp32 weights, not from their bf16 rounding
    want, _ = quantize_weight(tm.transformer.resblocks[1].mlp.c_fc.weight)
    assert torch.equal(lin.weight_q, want)
    assert tm.visual.proj.dtype == torch.float32  # the source is untouched
    cast_floating(q, torch.float32)
    assert q.visual.proj.dtype == torch.float32
    images, _ = _inputs(3)
    with torch.no_grad():
        out = q.encode_image(torch.from_numpy(images), normalize=True)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("tower", ["visual", "text"])
def test_quantize_model_one_tower(tower):
    """Only the named tower is quantised and copied; its weights and its
    embeddings are those of the whole quantised CLIP."""
    _, _, tm = _pair()
    whole = quantize_model(tm, "dynamic")
    one = quantize_model(tm, "dynamic", tower=tower)
    kept, other = (one.visual, one.transformer) if tower == "visual" else \
        (one.transformer, one.visual)
    assert not any(t.is_meta for t in kept.state_dict().values())
    assert all(t.is_meta for t in other.state_dict().values())
    want = (whole.visual if tower == "visual" else whole).transformer
    got = (one.visual if tower == "visual" else one).transformer
    for (k, a), (_, b) in zip(want.state_dict().items(),
                              got.state_dict().items()):
        assert torch.equal(a, b), k
    images, texts = _inputs(4)
    method, batch = (("encode_image", torch.from_numpy(images))
                     if tower == "visual" else
                     ("encode_text", torch.from_numpy(texts).long()))
    with torch.no_grad():
        assert torch.equal(getattr(one, method)(batch),
                           getattr(whole, method)(batch))
    with pytest.raises(ValueError):
        quantize_model(tm, "dynamic", tower="both")


def test_int8_route_on_card(monkeypatch):
    """On the card --int8 takes the fused_block_int8 kernels whenever the
    shapes allow, as the JAX CLI does on the TPU; the kernels compute in
    bf16, so --fp32 there raises instead of serving another route."""
    from clip_embeds_tpu_torch.cli import embed
    from clip_embeds_tpu_torch.models import serving

    tm = create_model("test-tiny")
    monkeypatch.setattr(serving, "fused_path_available", lambda m: True)
    monkeypatch.setattr(embed, "_on_card", lambda m: True)
    for route in (embed.image_route, embed.text_route):
        assert route(tm, True, torch.bfloat16) == "fused_int8"
        with pytest.raises(ValueError, match="fp32"):
            route(tm, True, torch.float32)
    with pytest.raises(ValueError, match="fp32"):
        embed.embed_image_batches(tm, iter(()), 4, int8=True,
                                  dtype=torch.float32)
    # off the card, as the JAX CLI off the TPU
    monkeypatch.setattr(embed, "_on_card", lambda m: False)
    assert embed.image_route(tm, True, torch.float32) == "composable_int8"
    assert embed.text_route(tm, True, torch.float32) == "composable"


def test_embed_cli_int8_images_match_jax(tmp_path, checkpoint, capsys):
    _mk_images(tmp_path)
    common = ["--model", "test-tiny", "--pretrained", checkpoint,
              "--input", str(tmp_path), "--batch-size", "4", "--fp32",
              "--int8"]
    ours, theirs = tmp_path / "ours.npy", tmp_path / "jax.npy"
    assert embed_main(common + ["--output", str(ours), "--device",
                                 "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["route"] == "composable_int8" and result["images"] == 10
    assert jax_embed_main(common + ["--output", str(theirs),
                                    "--no-data-parallel"]) == 0
    a, b = np.load(ours), np.load(theirs)
    assert a.shape == b.shape == (10, 64)
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, rtol=1e-5)
    # the JAX CLI decodes natively: its pixels, and so its calibrated
    # scales and some int8 codes, differ slightly from PIL's
    assert _cos(a, b).min() >= 0.999, _cos(a, b)


def test_embed_cli_int8_texts_match_jax(tmp_path, checkpoint, capsys):
    txt = tmp_path / "caps.txt"
    txt.write_text("a photo of a cat\na photo of a dog\nan aerial view\n")
    common = ["--model", "test-tiny", "--pretrained", checkpoint,
              "--input-texts", str(txt), "--batch-size", "2", "--fp32",
              "--int8"]
    ours, theirs = tmp_path / "ours.npy", tmp_path / "jax.npy"
    assert embed_main(common + ["--output", str(ours), "--device",
                                 "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["route"] == "composable"  # off the card: the fp tower
    assert jax_embed_main(common + ["--output", str(theirs),
                                    "--no-data-parallel"]) == 0
    np.testing.assert_allclose(np.load(ours), np.load(theirs), rtol=1e-5,
                               atol=1e-5)


def test_validate_int8_cli(tmp_path):
    """Counterpart of tests/test_quant.py test_validate_int8_cli."""
    out = tmp_path / "report.json"
    report = validate_int8.main([
        "--model", "test-tiny", "--batch-size", "8",
        "--distributions", "noise,smooth",
        "--min-cos", "0.95", "--min-agreement", "0.5",
        "--out", str(out), "--device", "cpu",
    ])
    assert report["fused_path"] is False and len(report["pairs"]) == 4
    for row in report["pairs"]:
        assert row["cos_mean"] > 0.95
    assert report["pass"] is True
    assert json.load(open(out))["pass"] is True


def test_validate_int8_batches_and_preprocess():
    rng = np.random.default_rng(0)
    for dist in ("noise", "smooth", "charts"):
        batch = validate_int8.make_batch(dist, 3, 32, rng)
        assert batch.shape == (3, 32, 32, 3) and batch.dtype == np.uint8
    px = validate_int8.preprocess(torch.from_numpy(batch), 32, torch.float32)
    assert px.shape == (3, 32, 32, 3) and px.dtype == torch.float32
    with pytest.raises(ValueError):  # no resize is ported
        validate_int8.preprocess(torch.from_numpy(batch), 48, torch.float32)
