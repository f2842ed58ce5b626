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


def _skips(err):
    return sorted(ln for ln in err.splitlines() if ln.startswith("skip "))


def test_workers_rows_match_jax_cli(tmp_path, checkpoint, capsys):
    """--workers 2 through the prefetch loader: the JAX CLI's rows, the same
    manifest and the same skip of the corrupt file."""
    _mk_images(tmp_path)
    common = ["--model", "test-tiny", "--pretrained", checkpoint,
              "--input", str(tmp_path), "--batch-size", "4", "--fp32",
              "--workers", "2"]
    ours, theirs = tmp_path / "ours.npy", tmp_path / "jax.npy"
    assert main(common + ["--output", str(ours), "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert result["workers"] == 2 and result["decoder"] in ("native", "pil")
    assert jax_main(common + ["--output", str(theirs),
                              "--no-data-parallel"]) == 0
    assert _skips(err) == _skips(capsys.readouterr().err) == [
        f"skip {tmp_path / 'sub' / 'bad.jpg'}: undecodable"]
    a, b = np.load(ours), np.load(theirs)
    assert a.shape == b.shape == (10, 64)
    assert _cos(a, b).min() >= 0.9999, _cos(a, b)
    assert json.load(open(str(ours) + ".paths.json")) == \
        json.load(open(str(theirs) + ".paths.json"))


def _mk_photos(root, n=6):
    """Smooth fields with mild noise, large enough (240 x 320 against the
    32-pixel crop) that --fast-jpeg decodes at a reduced DCT scale."""
    root.mkdir(exist_ok=True)
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:240, 0:320].astype(np.float32)
    for i in range(n):
        f = rng.uniform(0.005, 0.03, (3, 2))
        img = np.stack([128 + 90 * np.sin(x * f[c, 0] + i)
                        + 30 * np.cos(y * f[c, 1]) for c in range(3)], -1)
        img += rng.normal(0, 4, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / f"{i}.jpg", quality=90)


def test_fast_jpeg_agrees_with_the_pil_path(tmp_path, checkpoint):
    """--fast-jpeg decodes at a reduced scale, so its rows differ from the
    PIL-exact path's by a little (row cosine >= 0.9999 here), and equal the
    JAX CLI's --fast-jpeg rows."""
    from clip_embeds_tpu_torch.native.build import load_library

    if load_library() is None:
        pytest.skip("native library unavailable (no g++ or image headers)")
    _mk_photos(tmp_path / "photos")
    common = ["--model", "test-tiny", "--pretrained", checkpoint, "--input",
              str(tmp_path / "photos"), "--batch-size", "4", "--fp32"]
    exact, fast, theirs = (tmp_path / f"{k}.npy"
                           for k in ("exact", "fast", "jax"))
    assert main(common + ["--output", str(exact), "--device", "cpu"]) == 0
    assert main(common + ["--output", str(fast), "--device", "cpu",
                          "--fast-jpeg"]) == 0
    assert jax_main(common + ["--output", str(theirs), "--fast-jpeg",
                              "--no-data-parallel"]) == 0
    a, b = np.load(exact), np.load(fast)
    assert a.shape == b.shape == (6, 64) and not np.array_equal(a, b)
    assert _cos(a, b).min() >= 0.9999, _cos(a, b)
    assert _cos(b, np.load(theirs)).min() >= 0.9999


def test_fast_jpeg_needs_the_native_library(tmp_path, checkpoint, capsys,
                                            monkeypatch):
    """Without the native library images decode with PIL and the JSON line
    says so; --fast-jpeg, whose pixels PIL cannot give, is an error."""
    from clip_embeds_tpu_torch.native import build

    monkeypatch.setattr(build, "load_library", lambda: None)
    _mk_images(tmp_path)
    args = ["--model", "test-tiny", "--pretrained", checkpoint, "--input",
            str(tmp_path), "--output", str(tmp_path / "x.npy"), "--device",
            "cpu", "--fp32", "--batch-size", "4"]
    assert main(args + ["--fast-jpeg"]) == 1
    assert "--fast-jpeg needs the native image library" in \
        capsys.readouterr().err
    assert not (tmp_path / "x.npy").exists()
    assert main(args) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["decoder"] == "pil" and result["images"] == 10
