"""The port's embed CLI against the JAX package's CLI (fp32, CPU), on one
checkpoint made from JAX params by the converter."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli.embed import main as jax_main
from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu_torch.cli.embed import (
    embed_image_batches,
    list_images,
    main,
)
from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params
from clip_embeds_tpu_torch.core.factory import create_model


def _mk_images(root, n=10):
    """The JPEG fixture of tests/test_embed_cli.py: n good images, a text
    file and one corrupt jpg."""
    os.makedirs(root / "sub", exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(
            rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
        ).save(root / "sub" / f"{i:02d}.jpg")
    (root / "sub" / "notes.txt").write_text("not an image")
    (root / "sub" / "bad.jpg").write_bytes(b"\xff\xd8broken")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    _, params = jax_create_model("test-tiny", seed=5)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save(state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
               path)
    return str(path)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def test_images_match_jax_cli(tmp_path, checkpoint, capsys):
    _mk_images(tmp_path)
    common = ["--model", "test-tiny", "--pretrained", checkpoint,
              "--input", str(tmp_path), "--batch-size", "4", "--fp32"]
    ours, theirs = tmp_path / "ours.npy", tmp_path / "jax.npy"
    assert main(common + ["--output", str(ours), "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["images"] == 10 and result["device"] == "cpu"
    assert jax_main(common + ["--output", str(theirs),
                              "--no-data-parallel"]) == 0
    a, b = np.load(ours), np.load(theirs)
    # 10 images in batches of 4: the tail batch of 2 is padded and sliced
    assert a.shape == b.shape == (10, 64) and a.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, rtol=1e-5)
    # the JAX CLI decodes natively, so pixels may differ slightly
    assert _cos(a, b).min() >= 0.9999, _cos(a, b)
    paths = json.load(open(str(ours) + ".paths.json"))
    assert paths == json.load(open(str(theirs) + ".paths.json"))
    assert len(paths) == 10 and not any("bad.jpg" in p for p in paths)


def test_texts_match_jax_cli(tmp_path, checkpoint):
    txt = tmp_path / "caps.txt"
    txt.write_text("a photo of a cat\na photo of a dog\nan aerial view\n")
    common = ["--model", "test-tiny", "--pretrained", checkpoint,
              "--input-texts", str(txt), "--batch-size", "2", "--fp32"]
    ours, theirs = tmp_path / "ours.npy", tmp_path / "jax.npy"
    assert main(common + ["--output", str(ours), "--device", "cpu"]) == 0
    assert jax_main(common + ["--output", str(theirs),
                              "--no-data-parallel"]) == 0
    a, b = np.load(ours), np.load(theirs)
    assert a.shape == b.shape == (3, 64)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)  # same tokens


def test_tail_padding_does_not_change_rows(checkpoint):
    model = create_model("test-tiny", pretrained=checkpoint)
    rng = np.random.default_rng(1)
    px = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    whole = embed_image_batches(model, [px], 8)
    split = embed_image_batches(model, [px[:3], px[3:]], 3)
    assert whole.shape == split.shape == (5, 64)
    np.testing.assert_allclose(whole, split, rtol=1e-5, atol=1e-6)


def test_cli_rejects_bad_inputs(tmp_path, checkpoint):
    out = str(tmp_path / "x.npy")
    assert main(["--model", "test-tiny", "--output", out]) == 1
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "a.jpg").write_bytes(b"\xff\xd8broken")
    assert main(["--model", "test-tiny", "--pretrained", checkpoint,
                 "--input", str(tmp_path / "bad"), "--output", out,
                 "--device", "cpu"]) == 1
    with pytest.raises(FileNotFoundError):
        create_model("test-tiny", pretrained=str(tmp_path / "missing.pt"))


def test_cli_runs_on_the_card_unless_asked(tmp_path, checkpoint,
                                           monkeypatch):
    """--device defaults to cuda; without a card the command exits with an
    error instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _mk_images(tmp_path)
    args = ["--model", "test-tiny", "--pretrained", checkpoint,
            "--input", str(tmp_path), "--output", str(tmp_path / "x.npy")]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(args)
    assert not (tmp_path / "x.npy").exists()
    assert main(args + ["--device", "cpu", "--fp32"]) == 0


def test_list_images_and_manifest(tmp_path):
    _mk_images(tmp_path)
    paths = list_images(str(tmp_path))
    assert len(paths) == 11  # 10 good + bad.jpg (skipped at decode)
    manifest = tmp_path / "list.txt"
    manifest.write_text("\n".join(paths[:3]))
    assert list_images(str(manifest)) == paths[:3]
