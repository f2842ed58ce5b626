"""Port weight conversion, config registry and tokenizer: open_clip state
dict -> JAX params -> back, exact; the port's own copies of the registry and
the tokenizer against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core.torch_convert import convert_clip_state_dict
from clip_embeds_tpu.text.tokenizer import get_tokenizer as jax_tokenizer
from clip_embeds_tpu_torch.core.config import MODEL_CONFIGS, get_model_config
from clip_embeds_tpu_torch.core.convert import (
    load_open_clip_state_dict,
    state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.models.clip import CLIP


def _random_open_clip_sd(name: str, seed: int = 0):
    """A state dict in open_clip layout with every entry random."""
    model = CLIP(get_model_config(name))
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["test-tiny", "test-pacl-tiny"])
def test_state_dict_round_trip_is_exact(name):
    sd = _random_open_clip_sd(name)
    back = state_dict_from_jax_params(convert_clip_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k  # a pure relayout: tolerance 0


def test_load_open_clip_state_dict_strips_module_prefix():
    sd = _random_open_clip_sd("test-tiny", seed=1)
    wrapped = {"module." + k: v for k, v in sd.items()}
    wrapped["module.context_length"] = torch.tensor(77)  # OpenAI extra key
    model = CLIP(get_model_config("test-tiny"))
    load_open_clip_state_dict(model, wrapped)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(RuntimeError):  # strict: a missing key is an error
        load_open_clip_state_dict(model, {k: v for k, v in sd.items()
                                          if k != "visual.proj"})


def test_model_config_shared_with_jax_package():
    """The port keeps its own copy of the registry: equal to the JAX one,
    field by field, for every name the JAX registry holds."""
    assert sorted(MODEL_CONFIGS) == sorted(jax_config.MODEL_CONFIGS)
    for name, jax_cfg in jax_config.MODEL_CONFIGS.items():
        for tag in (None, "openai"):
            ours = get_model_config(name, tag)
            assert (dataclasses.asdict(ours) == dataclasses.asdict(
                jax_config.get_model_config(name, tag))), (name, tag)
        assert ours.vision.heads == jax_cfg.vision.heads, name
        assert ours.vision.num_patches == jax_cfg.vision.num_patches, name
    cfg = get_model_config("ViT-L-14-336", pretrained="openai")
    assert cfg.quick_gelu and cfg.vision.heads == 16
    assert cfg.vision.num_patches == 576 and cfg.text.heads == 12
    assert not get_model_config("ViT-L-14-336").quick_gelu
    with pytest.raises(KeyError, match="not ported"):
        get_model_config("ViT-SO400M-14-SigLIP")


def test_tokenizer_matches_jax_package():
    from clip_embeds_tpu_torch.text.tokenizer import get_tokenizer

    captions = ["a photo of a cat", "Two DOGS,  playing   in the snow!",
                "a diagram of 3 gears &amp; a lever", "café au lait",
                " ".join(["word"] * 100)]  # truncated with EOT kept
    for ctx in (77, 16):
        ours, theirs = get_tokenizer(ctx), jax_tokenizer(ctx)
        got, want = ours(captions), theirs(captions)
        assert got.dtype == want.dtype and got.shape == (5, ctx)
        np.testing.assert_array_equal(got, want)
        assert ours.decode(got[0, 1:5]) == theirs.decode(want[0, 1:5])
