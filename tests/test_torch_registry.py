"""The port's open_clip registry against the JAX package's: every one of
the 126 model names (backend, resolved config or the exception), the
whole pretrained table and its preprocess configs, the mocked download,
``get_model_config`` / ``list_models``, ``create_model_and_transforms``'
preprocess, and every 'clip' name built at its published widths (on the
meta device; one per tower family counted against JAX's parameters)."""

import dataclasses
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core import factory as jax_factory
from clip_embeds_tpu.core import openclip_registry as jax_registry
from clip_embeds_tpu.image import transform as jax_transform
from clip_embeds_tpu_torch.core import config as port_config
from clip_embeds_tpu_torch.core import factory as port_factory
from clip_embeds_tpu_torch.core import openclip_registry as port_registry
from clip_embeds_tpu_torch.image import transform as port_transform
from clip_embeds_tpu_torch.models.clip import CLIP

NAMES = jax_registry.list_openclip_models()


def _outcome(fn, *args):
    """(dataclass as a dict, or (exception type name, message))."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return (type(e).__name__, str(e))
    return dataclasses.asdict(out)


def test_every_name_resolves_as_in_jax():
    assert port_registry.list_openclip_models() == NAMES and len(NAMES) == 126
    for name in NAMES:
        assert port_registry.get_raw_model_config(name) == \
            jax_registry.get_raw_model_config(name), name
        assert port_registry.classify_model(name) == \
            jax_registry.classify_model(name), name
        for fn in ("resolve_clip_config", "resolve_siglip_config",
                   "resolve_coca_config"):
            assert _outcome(getattr(port_registry, fn), name) == _outcome(
                getattr(jax_registry, fn), name), (fn, name)
        for tag in (None, "openai"):
            assert _outcome(port_config.get_model_config, name, tag) == \
                _outcome(jax_config.get_model_config, name, tag), name
    assert port_registry.classify_model("no-such-model") == \
        jax_registry.classify_model("no-such-model")
    assert port_config.list_models() == jax_config.list_models()
    with pytest.raises(KeyError, match="unknown model"):
        port_config.get_model_config("no-such-model")


def test_pretrained_table_and_preprocess_cfgs_as_in_jax():
    pairs = jax_registry.list_pretrained()
    assert port_registry.list_pretrained() == pairs
    assert port_registry.list_pretrained(as_str=True) == \
        jax_registry.list_pretrained(as_str=True)
    for tag in ("openai", "laion2b_s34b_b79k", "WebLI"):
        assert port_registry.list_pretrained_models_by_tag(tag) == \
            jax_registry.list_pretrained_models_by_tag(tag)
    for name, tag in pairs + [("RN50", "no-such-tag")]:
        assert port_registry.get_pretrained_cfg(name, tag) == \
            jax_registry.get_pretrained_cfg(name, tag), (name, tag)
        assert port_registry.is_pretrained_cfg(name, tag) == \
            jax_registry.is_pretrained_cfg(name, tag)
        assert port_registry.list_pretrained_tags_by_model(name) == \
            jax_registry.list_pretrained_tags_by_model(name)
        for size in (224, (256, 320)):
            assert dataclasses.asdict(port_transform.pretrained_preprocess_cfg(
                name, tag, size)) == dataclasses.asdict(
                    jax_transform.pretrained_preprocess_cfg(name, tag, size))


def test_download_pretrained_mocked(tmp_path, monkeypatch):
    """The cache lookup and the URL fetch (replaced: no network), as
    tests/test_registry.py holds JAX's; an hf_hub-only entry raises."""
    calls = []

    def fake_urlretrieve(url, target):
        calls.append(url)
        with open(target, "wb") as f:
            f.write(b"ckpt")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    cfg = port_registry.get_pretrained_cfg("RN50", "openai")
    assert cfg["url"]
    path = port_registry.download_pretrained(cfg, cache_dir=str(tmp_path))
    assert path == jax_registry.download_pretrained(cfg,
                                                    cache_dir=str(tmp_path))
    assert path.startswith(str(tmp_path)) and open(path, "rb").read() == \
        b"ckpt"
    assert calls == [cfg["url"]]  # the second lookup hit the cache
    monkeypatch.setenv("CLIP_EMBEDS_CKPT_DIR", str(tmp_path / "env"))
    assert port_registry.download_pretrained(cfg).startswith(
        str(tmp_path / "env"))
    for reg in (port_registry, jax_registry):
        with pytest.raises(FileNotFoundError, match="hf_hub"):
            reg.download_pretrained({"hf_hub": "org/repo/"},
                                    cache_dir=str(tmp_path))


@pytest.mark.parametrize("name,tag,size", [
    ("ViT-B-32", "openai", 224), ("ViT-B-16-SigLIP", "webli", 224),
    ("ViT-H-14-378", "dfn5b", 378)])
def test_create_model_and_transforms_preprocess_as_in_jax(
        monkeypatch, tmp_path, name, tag, size):
    """The preprocess of one OpenAI tag, one SigLIP tag (0.5 stats, squash,
    bicubic) and a DFN tag, on a fixture photo: the same pixels. The model
    builders are replaced by a stand-in of the config's image size (the
    SigLIP name builds through models/siglip.py, not create_model), so the
    preprocess alone is held."""
    cfg = jax_config.CLIPConfig(
        vision=jax_config.VisionConfig(image_size=size),
        text=jax_config.TextConfig(context_length=77))
    stub = type("M", (), {"cfg": cfg})()
    monkeypatch.setattr(jax_factory, "create_model",
                        lambda *a, **k: (stub, {}))
    monkeypatch.setattr(port_factory, "create_model", lambda *a, **k: stub)
    rng = np.random.default_rng(0)
    photo = Image.fromarray(rng.integers(0, 256, (300, 451, 3), np.uint8))
    _, _, want_pp, want_tok = jax_factory.create_model_and_transforms(
        name, tag)
    _, got_pp, got_tok = port_factory.create_model_and_transforms(name, tag)
    want, got = want_pp(photo), got_pp(photo)
    assert got.shape == want.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_tok(["a cat"]), want_tok(["a cat"]))
    _, _, _, train = port_factory.create_model_and_transforms(
        name, tag, aug_cfg={})
    assert train(photo, np.random.default_rng(1)).shape == (size, size, 3)


def test_every_clip_name_builds():
    """Every name JAX builds through create_model (backend 'clip': 87),
    the port builds, at the published widths, on the meta device."""
    names = [n for n in NAMES if jax_registry.classify_model(n)[0] == "clip"]
    assert len(names) == 87
    for name in names:
        with torch.device("meta"):
            model = CLIP(port_config.get_model_config(name))
        assert model.cfg.vision == port_config.get_model_config(name).vision


@pytest.mark.parametrize("name", [
    "RN50", "EVA01-g-14", "EVA02-B-16", "convnext_base_w", "ViTamin-S",
    "MobileCLIP-S1",
    "MobileCLIP-B", "vit_medium_patch16_gap_256",
    "vit_relpos_medium_patch16_cls_224", "ViT-H-14-378"])
def test_published_widths_count_as_in_jax(name):
    """The vision tower's parameter count at the published widths equals
    JAX's (jax.eval_shape of its init; the folded FastViT / MCi-ViT stems
    on both sides, ResNet's BatchNorm statistics counted). JAX's Swin
    builds its shift mask with numpy and cannot be traced; its tiny tower
    is held in tests/test_torch_zoo.py."""
    from clip_embeds_tpu.models.clip import CLIP as JaxCLIP

    cfg = jax_config.get_model_config(name)
    shapes = jax.eval_shape(
        lambda: JaxCLIP(cfg).init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3)),
            jnp.zeros((1, cfg.text.context_length), jnp.int32)))
    want = sum(int(np.prod(x.shape)) for x in
               jax.tree_util.tree_leaves(shapes["params"]["visual"]))
    with torch.device("meta"):
        model = CLIP(port_config.get_model_config(name))
    # JAX's FrozenBatchNorm keeps its statistics as params
    got = sum(p.numel() for p in model.visual.parameters()) + sum(
        b.numel() for b in model.visual.buffers() if b.is_floating_point())
    assert got == want, (name, got, want)
