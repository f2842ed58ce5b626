"""``core/export.py`` against the JAX package's on the CPU: a ViT CLIP
bundle written by the port loads in JAX's ``load_model_bundle`` and one
written by JAX loads in the port, the same embeddings (fp32, within 1e-5)
and the config JSON equal byte for byte; an EVA01 bundle round-trips in the
port and loads in JAX; the other zoo towers raise, naming ROADMAP.md's
item; ``push_to_hub`` raises JAX's RuntimeError without
``huggingface_hub``; the loader runs on the card unless asked."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core import export as jexport
from clip_embeds_tpu.core.torch_convert import convert_clip_state_dict
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu_torch.core import config as port_config
from clip_embeds_tpu_torch.core import export as pexport
from clip_embeds_tpu_torch.core.factory import create_model
from torch_zoo_fixtures import (  # noqa: F401 - fixture
    jax_config_of,
    one_torch_thread,
    tiny_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-5, atol=1e-5)


def _images(cfg, n=2, seed=0):
    s = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal(
        (n, s, s, 3)).astype(np.float32)


def _texts(cfg, n=2):
    ids = np.random.default_rng(1).integers(
        1, 1000, (n, cfg.text.context_length))
    ids[:, 6] = 49407
    return ids.astype(np.int32)


def _port_features(model, cfg):
    with torch.no_grad():
        out = model(torch.from_numpy(_images(cfg)),
                    torch.from_numpy(_texts(cfg)).long())
    return out["image_features"].numpy(), out["text_features"].numpy()


def _jax_features(jmodel, params, cfg):
    out = jmodel.apply({"params": params}, jnp.asarray(_images(cfg)),
                       jnp.asarray(_texts(cfg)))
    return np.asarray(out["image_features"]), np.asarray(out["text_features"])


def _read(folder, name):
    with open(os.path.join(folder, name), "rb") as fh:
        return fh.read()


def test_vit_bundles_cross_load_both_ways(tmp_path):
    model = create_model("test-tiny", seed=3)
    cfg = model.cfg
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "jax")
    pexport.save_model_bundle(ours, model, "ViT-B-32", "openai")
    jmodel0 = JaxCLIP(jax_config.get_model_config("test-tiny"))
    params = jax.tree.map(np.asarray, convert_clip_state_dict(
        model.state_dict()))
    jexport.save_model_bundle(theirs, jmodel0, params, "ViT-B-32", "openai")
    assert _read(ours, pexport.CONFIG_NAME) == _read(theirs,
                                                     jexport.CONFIG_NAME)
    a = np.load(os.path.join(ours, pexport.WEIGHTS_NAME))
    b = np.load(os.path.join(theirs, jexport.WEIGHTS_NAME))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    want = _port_features(model, cfg)
    jmodel, jparams = jexport.load_model_bundle(ours)
    for got, ref in zip(_jax_features(jmodel, jparams, cfg), want):
        np.testing.assert_allclose(got, ref, **TOL)
    loaded = pexport.load_model_bundle(theirs, device="cpu")
    assert not loaded.training and loaded.cfg == cfg
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    for got, ref in zip(_port_features(loaded, cfg), want):
        np.testing.assert_allclose(got, ref, **TOL)


def test_eva01_bundle_round_trips_and_loads_in_jax(tmp_path, monkeypatch):
    cfg = tiny_config("eva")
    monkeypatch.setitem(port_config.MODEL_CONFIGS, "tiny-eva", cfg)
    model = create_model("tiny-eva", seed=4)
    folder = str(tmp_path / "eva")
    pexport.save_model_bundle(folder, model, "tiny-eva")
    loaded = pexport.load_model_bundle(folder, device="cpu")
    assert loaded.cfg == cfg
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    want = _port_features(model, cfg)
    for got, ref in zip(_port_features(loaded, cfg), want):
        np.testing.assert_array_equal(got, ref)
    jmodel, jparams = jexport.load_model_bundle(folder)
    assert jmodel.cfg == jax_config_of(cfg)
    for got, ref in zip(_jax_features(jmodel, jparams, cfg), want):
        np.testing.assert_allclose(got, ref, **TOL)


def test_other_zoo_towers_raise_naming_the_item(tmp_path, monkeypatch):
    monkeypatch.setitem(port_config.MODEL_CONFIGS, "tiny-resnet",
                        tiny_config("resnet"))
    model = create_model("tiny-resnet", seed=0)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1 item 15d"):
        pexport.save_model_bundle(str(tmp_path / "rn"), model)


def test_push_to_hub_raises_as_jax_without_the_package(monkeypatch,
                                                       tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    errors = []
    for fn in (pexport.push_to_hub, jexport.push_to_hub):
        with pytest.raises(RuntimeError) as exc:
            fn(str(tmp_path), "someone/model")
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "huggingface_hub" in errors[0]


def test_loading_takes_the_card_unless_asked(tmp_path, monkeypatch):
    folder = str(tmp_path / "b")
    pexport.save_model_bundle(folder, create_model("test-tiny", seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        pexport.load_model_bundle(folder)
