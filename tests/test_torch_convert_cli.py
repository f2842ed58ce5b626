"""``cli/convert.py`` against the JAX package's on the CPU: the state-dict
readers (a torch file, an HF directory of bin shards or of safetensors),
the converter each registered score name dispatches to, and a tiny seeded
HF-layout LLaVA checkpoint converted by both CLIs into bundles whose
arrays and config are equal, which ``get_score_model`` loads in both
packages to the same scores."""

import json
import os

import numpy as np
import pytest
import torch

from clip_embeds_tpu.cli import convert as jconvert
from clip_embeds_tpu.scores import build as jbuild
from clip_embeds_tpu.scores import registry as jregistry
from clip_embeds_tpu_torch.cli import convert as pconvert
from clip_embeds_tpu_torch.scores import registry as pregistry
from test_torch_llava import _hf_state_dict
from test_torch_vqa_score import TOL, _image, jax_tiny_cfg, toy_tokenize

ROUTED = (jregistry.LLAVA_MODELS + jregistry.LLAVA16_MODELS
          + jregistry.LLAVA_LLAMA_MODELS + jregistry.CLIP_T5_MODELS
          + jregistry.INSTRUCTBLIP_MODELS + jregistry.BLIP2_ITM_MODELS
          + jregistry.BLIP2_ITC_MODELS + jregistry.IMAGE_REWARD_MODELS)
# the converters each package's dispatch may reach, by module
_PORT = {"clip_embeds_tpu_torch.core.convert": (
             "convert_llava_state_dict", "convert_hf_clip_vision_state_dict",
             "convert_llama_state_dict", "convert_clip_t5_state_dict",
             "convert_instructblip_state_dict", "convert_blip2_state_dict",
             "convert_image_reward_state_dict"),
         "clip_embeds_tpu_torch.models.phi3": ("convert_phi3_state_dict",)}
_JAX = {"clip_embeds_tpu.core.torch_convert": (
            "convert_llava_state_dict", "convert_hf_clip_vision_state_dict",
            "convert_llama_state_dict", "convert_clip_t5_state_dict",
            "convert_instructblip_state_dict", "convert_blip2_state_dict"),
        "clip_embeds_tpu.models.phi3": ("convert_phi3_state_dict",),
        "clip_embeds_tpu.models.blip": ("convert_image_reward_state_dict",)}


def _record(monkeypatch, modules, calls):
    import importlib

    for mod, names in modules.items():
        m = importlib.import_module(mod)
        for name in names:
            monkeypatch.setattr(m, name, lambda *a, _n=name, **k:
                                calls.append(_n) or {})


@pytest.mark.parametrize("name", ROUTED)
def test_each_name_dispatches_the_converter_jax_does(monkeypatch, name):
    sd = {f"multi_modal_projector.linear_{i}.weight": torch.ones(4, 4)
          for i in (1, 2)}
    cfg = jbuild.default_model_config(name)
    ours, theirs = [], []
    _record(monkeypatch, _PORT, ours)
    _record(monkeypatch, _JAX, theirs)
    pconvert.convert_for_name(name, dict(sd), cfg)
    jconvert.convert_for_name(name, dict(sd), cfg)
    assert ours == theirs and ours


def test_unrouted_names_raise_as_in_jax():
    for fn in (pconvert.convert_for_name, jconvert.convert_for_name):
        with pytest.raises(KeyError, match="no converter route"):
            fn("gpt-4o", {}, None)


def test_state_dict_readers_match_jax(tmp_path):
    from safetensors.torch import save_file

    sd = _hf_state_dict(jax_tiny_cfg(), 3, new_layout=False)
    keys = sorted(sd)
    halves = (dict((k, sd[k]) for k in keys[::2]),
              dict((k, sd[k]) for k in keys[1::2]))
    torch.save({"state_dict": sd}, tmp_path / "ckpt.pt")
    (tmp_path / "bins").mkdir()
    (tmp_path / "safes").mkdir()
    for i, half in enumerate(halves):
        torch.save(half, tmp_path / "bins" / f"pytorch_model-0000{i}.bin")
        save_file({k: v.contiguous() for k, v in half.items()},
                  tmp_path / "safes" / f"model-0000{i}.safetensors")
    for src in ("ckpt.pt", "bins", "safes"):
        got = pconvert.load_state_dict(str(tmp_path / src))
        want = jconvert.load_state_dict(str(tmp_path / src))
        assert sorted(got) == sorted(want) == keys
        for k in keys:
            assert torch.equal(got[k], want[k]) and torch.equal(got[k],
                                                                sd[k]), k
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pconvert.load_state_dict(str(tmp_path / "empty"))


def test_cli_bundles_match_jax_and_load_in_both(tmp_path, capsys):
    name = "llava-v1.5-7b"
    jcfg = jax_tiny_cfg()
    torch.save(_hf_state_dict(jcfg, 5, new_layout=True),
               tmp_path / "hf.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(
        jbuild.config_to_dict(jcfg)))
    common = ["--name", name, "--checkpoint", str(tmp_path / "hf.pt"),
              "--config", str(tmp_path / "cfg.json")]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "jax")
    assert pconvert.main(common + ["--out", ours]) == 0
    assert "bundle written" in capsys.readouterr().out
    assert jconvert.main(common + ["--out", theirs]) == 0
    for f in ("config.json",):
        assert open(os.path.join(ours, f)).read() == \
            open(os.path.join(theirs, f)).read()
    a = np.load(os.path.join(ours, "params.npz"))
    b = np.load(os.path.join(theirs, "params.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    images, texts = [_image(3)], ["a cat on a mat"]
    got = pregistry.get_score_model(name, checkpoint=ours,
                                    tokenize=toy_tokenize,
                                    device="cpu")(images, texts)
    want = jregistry.get_score_model(name, checkpoint=ours,
                                     tokenize=toy_tokenize)(images, texts)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
