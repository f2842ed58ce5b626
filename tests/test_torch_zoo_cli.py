"""The zoo through the entry points, on the CPU against the JAX package:
``cli/embed.py`` writes the JAX CLI's image and text embeddings for a zoo
model (an EVA01 tower) and for a registry name with a native ViT, both
from one open_clip checkpoint at tiny widths (the names registered in both
packages for the test); ``cli/eval.py --scorer clip`` writes JAX's table
for the zoo model; ``--int8`` on a zoo tower's images fails in both.
``cli/train.py`` on the zoo towers is ``test_torch_zoo_train_cli.py``."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli.embed import main as jax_main
from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core import openclip_registry as jax_registry
from clip_embeds_tpu_torch.cli.embed import main
from clip_embeds_tpu_torch.core import config as port_config
from clip_embeds_tpu_torch.core import openclip_registry as port_registry
from clip_embeds_tpu_torch.core.factory import create_model

EVA = "tiny-eva01-cli"
NATIVE = "tiny-registry-vit"
# a registry entry in open_clip's JSON form, resolved by both registries
NATIVE_RAW = {"embed_dim": 32,
              "vision_cfg": {"image_size": 32, "layers": 2, "width": 32,
                             "patch_size": 16, "head_width": 16},
              "text_cfg": {"context_length": 16, "vocab_size": 49408,
                           "width": 32, "heads": 2, "layers": 1}}


def _eva_config(pkg):
    return pkg.CLIPConfig(
        embed_dim=32,
        vision=pkg.VisionConfig(tower="eva", image_size=32, patch_size=16,
                                width=32, layers=2, head_width=16,
                                mlp_ratio=2.0),
        text=pkg.TextConfig(context_length=16, width=32, heads=2,
                            layers=1))


@pytest.fixture
def names(monkeypatch):
    monkeypatch.setitem(port_config.MODEL_CONFIGS, EVA,
                        _eva_config(port_config))
    monkeypatch.setitem(jax_config.MODEL_CONFIGS, EVA,
                        _eva_config(jax_config))
    for reg in (port_registry, jax_registry):
        monkeypatch.setitem(reg._registry()["model_configs"], NATIVE,
                            NATIVE_RAW)


def _checkpoint(tmp_path, name):
    path = tmp_path / f"{name}.pt"
    torch.save(create_model(name, seed=3).state_dict(), path)
    return str(path)


def _images(root, n=6):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (40, 56, 3), np.uint8)).save(
            root / f"{i:02d}.jpg")


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("name", [EVA, NATIVE])
def test_embed_cli_matches_jax(names, tmp_path, capsys, name):
    ckpt = _checkpoint(tmp_path, name)
    _images(tmp_path / "img")
    (tmp_path / "t.txt").write_text("a cat\na dog on a mat\ntwo birds\n")
    common = ["--model", name, "--pretrained", ckpt, "--batch-size", "4",
              "--fp32"]
    for src in (["--input", str(tmp_path / "img")],
                ["--input-texts", str(tmp_path / "t.txt")]):
        ours, theirs = tmp_path / "ours.npy", tmp_path / "jax.npy"
        assert main(common + src + ["--output", str(ours), "--device",
                                    "cpu"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["route"] == "composable"
        assert jax_main(common + src + ["--output", str(theirs)] + (
            ["--no-data-parallel"] if "--input" in src else [])) == 0
        a, b = np.load(ours), np.load(theirs)
        assert a.shape == b.shape and a.shape[1] == 32
        if "--input" in src:  # the JAX CLI may decode natively
            assert _cos(a, b).min() >= 0.9999, _cos(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_int8_on_a_zoo_tower_fails_as_in_jax(names, tmp_path):
    ckpt = _checkpoint(tmp_path, EVA)
    _images(tmp_path / "img", n=2)
    argv = ["--model", EVA, "--pretrained", ckpt, "--input",
            str(tmp_path / "img"), "--int8", "--fp32", "--output",
            str(tmp_path / "o.npy")]
    with pytest.raises(NotImplementedError, match="'eva' vision tower"):
        main(argv + ["--device", "cpu"])
    # JAX quantises the block projections the tower does not read
    with pytest.raises(Exception, match='Could not find parameter named '
                       '"kernel"'):
        jax_main(argv + ["--no-data-parallel"])


def test_eval_cli_scores_a_zoo_model_as_jax(names, tmp_path, capsys):
    """cli/eval.py --scorer clip on the EVA01 model: the same What'sUp-A
    table and results-file text as JAX's CLI."""
    from clip_embeds_tpu.cli.eval import main as jax_eval
    from clip_embeds_tpu_torch.cli.eval import main as port_eval
    from torch_eval_fixtures import _make_whatsup

    _make_whatsup(tmp_path)
    common = ["--scorer", "clip", "--model", EVA, "--pretrained",
              _checkpoint(tmp_path, EVA), "--dataset", "a", "--root-dir",
              str(tmp_path), "--precision", "fp32", "--batch-size", "8"]
    ours, theirs = tmp_path / "ours.txt", tmp_path / "jax.txt"
    got = port_eval(common + ["--results-file", str(ours), "--device",
                              "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == jax_eval(common + ["--results-file", str(theirs)])
    assert ours.read_text() == theirs.read_text()
    assert info["route"] == "composable" and info["samples"] == 16
