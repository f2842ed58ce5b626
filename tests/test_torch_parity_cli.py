"""``cli/parity.py`` against the JAX package's on the CPU: the results-file
parser and the table diff on fixture tables, the reference transforms'
pixels (``_RefProcess`` for eval_clip.py, ``_PaclRefProcess`` for
eval_pacl.py / eval_sparc.py) on fixture images of several shapes, and the
port's side of the runbook (its ``cli/eval.py``) on the What'sUp fixture
giving the JAX side's table. Without the reference checkout, as here, the
command exits naming the path and reports no parity."""

import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli import parity as jparity
from clip_embeds_tpu_torch.cli import parity as pparity
from clip_embeds_tpu_torch.core.factory import create_model
from torch_eval_fixtures import _make_whatsup

RESULTS = """Dataset: controlled_images
Individual accuracy: 62.5
Pair accuracy: 25.0, set accuracy 12.5
left-right: 50.0
no number here: n/a
on-under: 75.0 (6/8)
Pair: 33.3333, Individual: 66.6667
"""


def test_results_files_parse_as_in_jax(tmp_path):
    path = tmp_path / "evaluation_results.txt"
    path.write_text(RESULTS)
    got = pparity.parse_results_file(str(path))
    assert got == jparity.parse_results_file(str(path))
    assert got["Pair"] == 33.3333 and got["on-under"] == 75.0


@pytest.mark.parametrize("tol", [1e-6, 0.5, 10.0])
def test_tables_diff_as_in_jax(tol):
    ref = {"Individual accuracy": 62.5, "Pair accuracy": 25.0,
           "left-right": 50.0, "only-ref": 1.0}
    port = {"Individual accuracy": 62.5, "Pair accuracy": 25.25,
            "left-right": 45.0, "only-port": 2.0}
    got = pparity.diff_tables(ref, port, tol)
    assert got == jparity.diff_tables(ref, port, tol)
    assert got["parity"] is (tol >= 5.0)
    assert pparity.diff_tables({}, {}, tol) == jparity.diff_tables({}, {},
                                                                   tol)


def _fixture_images():
    rng = np.random.default_rng(0)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
            for h, w in ((48, 64), (64, 48), (40, 40), (37, 91))]


@pytest.mark.parametrize("cls", ["_RefProcess", "_PaclRefProcess"])
def test_reference_transforms_match_jax(cls):
    ours = getattr(pparity, cls)(32, tokenizer=lambda c: [len(c)])
    theirs = getattr(jparity, cls)(32, tokenizer=lambda c: [len(c)])
    images = _fixture_images()
    for im in images:
        assert torch.equal(ours.preprocess_image(im),
                           theirs.preprocess_image(im))
    batch = ours.preprocess_image(images)
    assert batch.shape == (4, 3, 32, 32)
    assert torch.equal(batch, theirs.preprocess_image(images))
    assert ours.preprocess_text("a cat") == theirs.preprocess_text("a cat")


def _args(parse, root, ckpt, extra=()):
    return parse(["--model", "test-tiny", "--checkpoint", ckpt, "--dataset",
                  "a", "--root-dir", str(root)] + list(extra))


def test_port_side_table_equals_the_jax_side(tmp_path):
    _make_whatsup(tmp_path)
    ckpt = str(tmp_path / "tiny.pt")
    torch.save(create_model("test-tiny", seed=3).state_dict(), ckpt)
    (tmp_path / "ours").mkdir()
    (tmp_path / "jax").mkdir()
    got = pparity.run_port_driver(
        _args(pparity.parse_args, tmp_path, ckpt, ["--device", "cpu"]),
        str(tmp_path / "ours"))
    want = jparity.run_tpu_driver(_args(jparity.parse_args, tmp_path, ckpt),
                                  str(tmp_path / "jax"))
    assert got and got == want


def test_an_absent_reference_root_exits_naming_it(tmp_path, monkeypatch):
    missing = str(tmp_path / "no-reference")
    argv = ["--checkpoint", "x.pt", "--root-dir", str(tmp_path),
            "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        pparity.main(argv + ["--reference-root", missing])
    assert missing in str(exc.value.code) and "parity cannot be checked" \
        in str(exc.value.code)
    monkeypatch.setenv("CLIP_EMBEDS_REFERENCE_ROOT", missing)
    args = pparity.parse_args(argv)
    assert args.reference_root == missing and args.device == "cpu"
    with pytest.raises(SystemExit):
        pparity.main(argv)
