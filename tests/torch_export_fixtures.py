"""Shared checks of the zoo towers' flax trees and bundles
(``tests/test_torch_export_zoo*.py``): the port's writer against JAX's own
converter, a port-written bundle in JAX's ``load_model_bundle``, a
JAX-written bundle in the port's, each on the tiny configs of
``torch_zoo_fixtures.TOWERS``, seeded with numpy. Files cannot share
pytest fixtures under ``--dist loadfile``, so they import these."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from clip_embeds_tpu.core import export as jexport
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu_torch.core import export as pexport
from clip_embeds_tpu_torch.core.convert import (
    jax_params_from_clip,
    load_open_clip_state_dict,
    state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.models.clip import CLIP
from torch_zoo_fixtures import (
    flat,
    inputs,
    jax_config_of,
    jax_params,
    open_clip_state_dict,
    tiny_config,
)

# the 11 tiny kinds of the zoo towers that EVA01's and the ViT's older
# writer did not cover, in two halves of about equal JAX time
KINDS = ("resnet", "eva02-swiglu", "eva02-post", "timm-vit", "relpos-vit",
         "mci-vit", "swin", "vitamin", "fastvit", "convnext-linear",
         "convnext-mlp")
HALVES = (KINDS[:6], KINDS[6:])
# a port-written bundle's features in JAX (fp32, another summation order)
JAX_TOL = dict(rtol=0, atol=1e-5)


def port_model(kind: str, seed: int = 0) -> CLIP:
    """The tiny ``kind`` CLIP in eval mode, from a numpy-seeded open_clip
    state dict (timm's training layout for FastViT and MCi-ViT's stem,
    which the port folds at load)."""
    model = CLIP(tiny_config(kind)).eval()
    load_open_clip_state_dict(model, open_clip_state_dict(kind, model))
    if seed:  # other values, the same layout
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.from_numpy(np.asarray(
                    0.01 * rng.standard_normal(p.shape), np.float32)))
    return model


def port_features(model: CLIP):
    images, ids = inputs(model.cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(ids).long())
    return out["image_features"].numpy(), out["text_features"].numpy()


def jax_features(jmodel, params, cfg):
    images, ids = inputs(cfg)
    out = jmodel.apply({"params": params}, jnp.asarray(images),
                       jnp.asarray(ids))
    return (np.asarray(out["image_features"]),
            np.asarray(out["text_features"]))


def check_writer(kind: str) -> None:
    """``jax_params_from_clip`` gives JAX's converter's tree of the port's
    state dict, leaf for leaf and bit for bit (dtype and shape too); read
    back in memory by ``state_dict_from_jax_params``, it is the state dict
    again, sharing no memory with the model's."""
    model = port_model(kind)
    want = flat(jax_params(kind, model.cfg, model.state_dict()))
    got = jax_params_from_clip(model)
    assert sorted(flat(got)) == sorted(want)
    for path, a in flat(got).items():
        leaf = got
        for name in path.split("/"):
            leaf = leaf[name]
        assert leaf.dtype == np.float32, path
        assert a.shape == want[path].shape, path
        np.testing.assert_array_equal(a, want[path], err_msg=path)
    sd = model.state_dict()
    back = state_dict_from_jax_params(got)
    assert sorted(back) == sorted(sd)
    ptrs = {v.data_ptr() for v in sd.values()}
    for k, v in back.items():
        assert torch.equal(v, sd[k]) and v.data_ptr() not in ptrs, k


def check_port_bundle_in_jax(kind: str, folder: str) -> None:
    """A bundle the port writes loads in JAX's ``load_model_bundle``: the
    config JAX's, the features within ``JAX_TOL`` of the port's."""
    model = port_model(kind)
    pexport.save_model_bundle(folder, model, f"tiny-{kind}")
    jmodel, params = jexport.load_model_bundle(folder)
    assert jmodel.cfg == jax_config_of(model.cfg)
    for got, want in zip(jax_features(jmodel, params, model.cfg),
                         port_features(model)):
        np.testing.assert_allclose(got, want, **JAX_TOL)


def check_jax_bundle_in_port(kind: str, tmp) -> None:
    """A bundle JAX writes (its converter's tree of the port's state dict)
    loads in the port on the CPU: the state dict equal to the source
    model's, the features bit-equal, and the config JSON byte for byte the
    one the port writes for the same model."""
    model = port_model(kind, seed=1)
    cfg = model.cfg
    theirs, ours = str(tmp / "jax"), str(tmp / "port")
    params = jax_params(kind, cfg, model.state_dict())
    jexport.save_model_bundle(theirs, JaxCLIP(jax_config_of(cfg)), params,
                              f"tiny-{kind}")
    pexport.save_model_bundle(ours, model, f"tiny-{kind}")
    with open(os.path.join(theirs, jexport.CONFIG_NAME), "rb") as a, \
            open(os.path.join(ours, pexport.CONFIG_NAME), "rb") as b:
        assert a.read() == b.read()
    loaded = pexport.load_model_bundle(theirs, device="cpu")
    assert not loaded.training and loaded.cfg == cfg
    want = model.state_dict()
    assert sorted(loaded.state_dict()) == sorted(want)
    for k, v in loaded.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    for got, ref in zip(port_features(loaded), port_features(model)):
        np.testing.assert_array_equal(got, ref)
