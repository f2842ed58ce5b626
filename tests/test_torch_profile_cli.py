"""``cli/profile.py`` against the JAX package's on the CPU: the same CSV
columns, ``mparams`` equal to JAX's for ViT-B-32 and every zoo tower
family (JAX's ``count_params`` over its parameter tree, ModifiedResNet's
BatchNorm statistics included; post-norm EVA02's zero k-bias slot, which
JAX holds, a held difference), and the FLOP counts held to JAX's by the
measured ratio: XLA's ``cost_analysis`` also counts elementwise work,
``FlopCounterMode`` only the matrix products and convolutions, so JAX's
count is 1.1682 / 1.1382 / 1.1705 times the port's for test-tiny (whole
model / image tower / text tower, unrounded) and 1.0183 / 1.0147 /
1.0235 for ViT-B-32 (the rounded CSV rows). ``--trace`` writes a
``torch.profiler`` trace, on the card unless asked."""

import csv
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from clip_embeds_tpu.cli import profile as jprofile
from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu_torch.cli import profile as pprofile
from clip_embeds_tpu_torch.core import config as port_config
from torch_zoo_fixtures import (  # noqa: F401 - fixture
    TOWERS,
    jax_config_of,
    jit_safe,
    one_torch_thread,
    tiny_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COLUMNS = ["model", "image_size", "image_width", "text_width", "embed_dim",
           "mparams", "gflops", "image_gflops", "text_gflops"]
# JAX's count / the port's: (whole model, image tower, text tower)
RATIOS = {"test-tiny": (1.1682, 1.1382, 1.1705),
          "ViT-B-32": (1.0183, 1.0147, 1.0235)}


def _jax_flops(name):
    """Unrounded ``cost_analysis`` FLOPs of JAX's three forwards, as its
    ``profile_model`` lowers them."""
    model, params = jax_create_model(name)
    cfg = model.cfg
    s = cfg.vision.image_size
    images = jnp.zeros((1, s, s, 3))
    texts = jnp.zeros((1, cfg.text.context_length), jnp.int32)

    def flops(fn, *args):
        cost = jax.jit(fn).lower(params, *args).compile().cost_analysis()
        return cost["flops"]

    return (flops(lambda p, i, t: model.apply({"params": p}, i, t),
                  images, texts),
            flops(lambda p, i: model.apply({"params": p}, i,
                                           method="encode_image"), images),
            flops(lambda p, t: model.apply({"params": p}, t,
                                           method="encode_text"), texts))


def _port_flops(name):
    model = pprofile._meta_model(name)
    cfg = model.cfg
    s = cfg.vision.image_size
    images = torch.zeros(1, s, s, 3, device="meta")
    texts = torch.zeros(1, cfg.text.context_length, dtype=torch.long,
                        device="meta")
    return (pprofile._flops(model, images, texts),
            pprofile._flops(model.encode_image, images),
            pprofile._flops(model.encode_text, texts))


def test_test_tiny_rows_and_flop_ratio_match_jax():
    ours, theirs = (pprofile.profile_model("test-tiny"),
                    jprofile.profile_model("test-tiny"))
    assert list(ours) == list(theirs) == COLUMNS
    for k in ("model", "image_size", "image_width", "text_width",
              "embed_dim", "mparams"):
        assert ours[k] == theirs[k], k
    for got, want, ratio in zip(_port_flops("test-tiny"),
                                _jax_flops("test-tiny"),
                                RATIOS["test-tiny"]):
        assert want / got == pytest.approx(ratio, abs=1e-4)


def test_vit_b_32_row_holds_the_flop_ratio():
    ours, theirs = (pprofile.profile_model("ViT-B-32"),
                    jprofile.profile_model("ViT-B-32"))
    assert ours["mparams"] == theirs["mparams"] == 151.28
    for key, ratio in zip(("gflops", "image_gflops", "text_gflops"),
                          RATIOS["ViT-B-32"]):
        # the CSV rounds to 0.01 GFLOP: 1e-3 of the ratio covers it
        assert theirs[key] / ours[key] == pytest.approx(ratio, abs=1e-3)


@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_zoo_mparams_count_what_jax_counts(kind, monkeypatch):
    cfg = tiny_config(kind)
    monkeypatch.setitem(port_config.MODEL_CONFIGS, f"tiny-{kind}", cfg)
    jcfg = jax_config_of(cfg)
    s = cfg.vision.image_size
    with jit_safe(kind):  # JAX's Swin fails to trace otherwise
        shapes = jax.eval_shape(lambda: JaxCLIP(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
            jnp.zeros((1, cfg.text.context_length), jnp.int32)))["params"]
    want = jprofile.count_params(shapes)
    got = pprofile.count_params(pprofile._meta_model(f"tiny-{kind}"))
    if cfg.vision.eva_post_norm:
        # a held difference: JAX's post-norm EVA02 keeps the fused qkv
        # bias [q; 0; v] whole, zero k slot included; the port (timm) holds
        # q_bias and v_bias
        assert want - got == cfg.vision.layers * cfg.vision.width
    else:
        assert got == want
    assert pprofile.profile_model(f"tiny-{kind}")["mparams"] == round(
        got / 1e6, 2)
    flops = _port_flops(f"tiny-{kind}")
    assert flops[1] > 0 and flops[0] == flops[1] + flops[2]


def test_cli_writes_the_csv_and_a_trace(tmp_path, capsys, monkeypatch):
    out = tmp_path / "rows.csv"
    rows = pprofile.main(["--model", "test-tiny", "--results-file", str(out),
                          "--trace", str(tmp_path / "tr"), "--device", "cpu",
                          "--trace-batch-size", "2"])
    with open(out) as fh:
        read = list(csv.DictReader(fh))
    assert list(read[0]) == list(rows[0]) == COLUMNS
    assert read[0]["model"] == "test-tiny"
    trace = tmp_path / "tr" / "test-tiny" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert "trace for test-tiny" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        pprofile.main(["--model", "test-tiny", "--trace", str(tmp_path)])
