"""``create_model``'s ``pretrained`` resolved as the JAX package's
(``core/factory.py resolve_pretrained``), on the CPU: an ``.npz`` of the
flax tree (a bundle's weights) for every zoo tower of
``torch_export_fixtures.KINDS``, the same file found through
``$CLIP_EMBEDS_CKPT_DIR/<name>__<tag>``, the extensions in JAX's order
(JAX's own ``create_model`` picks the same file), a tag without a file
seeded, a missing weights path and a directory (JAX's orbax checkpoint)
raising; and a CoCa ``.npz`` through ``create_coca_model``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core import factory as jax_factory
from clip_embeds_tpu.core import openclip_registry as jax_registry
from clip_embeds_tpu.core.torch_convert import convert_coca_state_dict
from clip_embeds_tpu_torch.core import config as port_config
from clip_embeds_tpu_torch.core import openclip_registry as port_registry
from clip_embeds_tpu_torch.core.convert import jax_params_from_clip
from clip_embeds_tpu_torch.core.factory import (
    create_coca_model,
    create_model,
    init_coca,
    save_params_npz,
)
from clip_embeds_tpu_torch.models.coca import CoCa
from torch_export_fixtures import KINDS, port_model
from torch_zoo_fixtures import (  # noqa: F401 - fixture
    flat,
    jax_config_of,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _register(monkeypatch, kind, model):
    name = f"tiny-pretrained-{kind}"
    monkeypatch.setitem(port_config.MODEL_CONFIGS, name, model.cfg)
    monkeypatch.setitem(jax_config.MODEL_CONFIGS, name,
                        jax_config_of(model.cfg))
    return name


def _equal(model, want):
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", KINDS)
def test_npz_path_and_tag_load_the_tree(kind, tmp_path, monkeypatch):
    """An ``.npz`` path and a tag found under CLIP_EMBEDS_CKPT_DIR give the
    model whose tree it holds, bit for bit."""
    model = port_model(kind, seed=2)
    name = _register(monkeypatch, kind, model)
    path = tmp_path / "weights.npz"
    save_params_npz(jax_params_from_clip(model), str(path))
    _equal(create_model(name, pretrained=str(path)), model.state_dict())
    monkeypatch.setenv("CLIP_EMBEDS_CKPT_DIR", str(tmp_path))
    save_params_npz(jax_params_from_clip(model),
                    str(tmp_path / f"{name}__mytag.npz"))
    _equal(create_model(name, pretrained="mytag"), model.state_dict())


def test_tags_resolve_in_jax_order(tmp_path, monkeypatch):
    """A tag with both a ``.pt`` and an ``.npz`` takes the ``.pt``, as
    JAX's create_model does (its params equal the ``.pt``'s); one with an
    ``.npz`` alone takes it; one without a file is seeded."""
    a, b = port_model("resnet", seed=3), port_model("resnet", seed=4)
    name = _register(monkeypatch, "resnet", a)
    monkeypatch.setenv("CLIP_EMBEDS_CKPT_DIR", str(tmp_path))
    torch.save(a.state_dict(), tmp_path / f"{name}__both.pt")
    for tag in ("both", "npz"):
        save_params_npz(jax_params_from_clip(b),
                        str(tmp_path / f"{name}__{tag}.npz"))
    _equal(create_model(name, pretrained="both"), a.state_dict())
    _equal(create_model(name, pretrained="npz"), b.state_dict())
    _, params = jax_factory.create_model(name, pretrained="both")
    want = flat(jax_params_from_clip(a))
    got = flat(jax.tree.map(np.asarray, params))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    seeded = create_model(name, pretrained="none", seed=5)
    _equal(seeded, create_model(name, seed=5).state_dict())


def test_a_directory_or_a_missing_file_raises(tmp_path, monkeypatch):
    """A directory is JAX's orbax format, which the port cannot read; a
    weights path that does not exist raises rather than seeding."""
    model = port_model("timm-vit")
    name = _register(monkeypatch, "timm-vit", model)
    orbax = tmp_path / "ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        create_model(name, pretrained=str(orbax))
    monkeypatch.setenv("CLIP_EMBEDS_CKPT_DIR", str(tmp_path))
    (tmp_path / f"{name}__dir.npz").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        create_model(name, pretrained="dir")
    for ext in (".pt", ".npz"):
        with pytest.raises(FileNotFoundError):
            create_model(name, pretrained=str(tmp_path / f"gone{ext}"))


# the tiny CoCa of tests/test_torch_coca.py's CLI runs
_COCA = {
    "embed_dim": 32, "custom_text": True,
    "multimodal_cfg": {"context_length": 15, "width": 32, "heads": 2,
                       "layers": 2, "vocab_size": 49408},
    "text_cfg": {"context_length": 15, "vocab_size": 49408, "width": 32,
                 "heads": 2, "layers": 2, "embed_cls": True},
    "vision_cfg": {"image_size": 32, "patch_size": 8, "width": 32,
                   "layers": 2, "head_width": 16, "attn_pooler_queries": 8,
                   "attn_pooler_heads": 2},
}


def test_coca_npz_and_tag(tmp_path, monkeypatch):
    """create_coca_model reads JAX's CoCa tree (``convert_coca_state_dict``
    of a seeded model) from an ``.npz`` path and from a tag."""
    for reg in (jax_registry, port_registry):
        monkeypatch.setitem(reg._registry()["model_configs"], "coca_tiny",
                            _COCA)
    cfg = port_registry.resolve_coca_config("coca_tiny")
    with torch.device("meta"):
        model = CoCa(cfg)
    model.to_empty(device="cpu")
    init_coca(model, torch.Generator().manual_seed(6))
    params = convert_coca_state_dict(model.state_dict())
    path = tmp_path / "coca.npz"
    save_params_npz(params, str(path))
    _equal(create_coca_model("coca_tiny", pretrained=str(path)),
           model.state_dict())
    monkeypatch.setenv("CLIP_EMBEDS_CKPT_DIR", str(tmp_path))
    save_params_npz(params, str(tmp_path / "coca_tiny__t.npz"))
    loaded = create_model("coca_tiny", pretrained="t")
    assert type(loaded).__name__ == "CoCa" and dataclasses.asdict(
        loaded.cfg) == dataclasses.asdict(cfg)
    _equal(loaded, model.state_dict())
