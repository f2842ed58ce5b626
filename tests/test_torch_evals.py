"""The port's evaluation drivers and metrics against the JAX package's
(CPU): the What'sUp, COCO / VG and MMVP drivers over a mock scorer give the
same dicts and results-file text, the annotation loaders the same samples,
and the metrics the same numbers, on fixtures built as in
tests/test_evals.py. The scorers are held in
tests/test_torch_eval_scorers.py, the eval CLI's tables in
tests/test_torch_eval_cli.py."""

import json
import os

import numpy as np
import pytest

from clip_embeds_tpu.evals import metrics as jax_metrics
from clip_embeds_tpu.evals import mmvp as jax_mmvp
from clip_embeds_tpu.evals import whatsup as jax_whatsup
from clip_embeds_tpu_torch.evals import metrics, mmvp, whatsup
from torch_eval_fixtures import _make_coco, _make_mmvp, _make_whatsup


class PatternScorer:
    """Deterministic mock: sample i correct iff i in correct_set."""

    def __init__(self, correct_set):
        self.correct_set = correct_set

    def score_batch(self, samples):
        out = []
        for i, (_, options) in enumerate(samples):
            scores = np.linspace(0.5, 0.1, len(options))
            if i not in self.correct_set:
                scores[0], scores[1] = scores[1], scores[0]
            out.append(scores)
        return out


PATTERNS = {"all": lambda n: set(range(n)), "first_pair": lambda n: {0, 1, 2, 3},
            "alternate": lambda n: set(range(0, n, 2)), "none": lambda n: set()}


# -- drivers with a mock scorer ------------------------------------------


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("four_option", [False, True])
def test_whatsup_driver_matches_jax(tmp_path, pattern, four_option):
    dataset = _make_whatsup(tmp_path, n_pairs=2)
    scorer = PatternScorer(PATTERNS[pattern](len(dataset)))
    ours, theirs = tmp_path / "ours.txt", tmp_path / "jax.txt"
    got = whatsup.eval_whatsup(scorer.score_batch, dataset, str(tmp_path),
                               four_option, str(ours))
    want = jax_whatsup.eval_whatsup(scorer.score_batch, dataset,
                                    str(tmp_path), four_option, str(theirs))
    assert got == want
    assert ours.read_text() == theirs.read_text()


@pytest.mark.parametrize("source", ["coco", "vg"])
def test_coco_vg_driver_matches_jax(tmp_path, source):
    dataset = _make_coco(tmp_path)
    scorer = PatternScorer({0, 1})
    ours, theirs = tmp_path / "ours.txt", tmp_path / "jax.txt"
    got = whatsup.eval_coco_vg(scorer.score_batch, dataset, str(tmp_path),
                               source, str(ours))
    want = jax_whatsup.eval_coco_vg(scorer.score_batch, dataset,
                                    str(tmp_path), source, str(theirs))
    assert got == want and got["individual_accuracy"] == 50.0
    assert ours.read_text() == theirs.read_text()


def _alternating_pair_score():
    """Mock t2i scorer: every other pair right, by the qid parity rule."""
    state = {"n": 0}

    def pair_score(images, texts):
        state["n"] += 1
        first = int(os.path.basename(images[0]).split(".")[0]) % 2 == 1
        m = np.array([[0.9, 0.1], [0.1, 0.9]])
        return m if first == (state["n"] % 2 == 1) else m[::-1]

    return pair_score


@pytest.mark.parametrize("name", ["mmvpvlm", "mmvp"])
def test_mmvp_driver_matches_jax(tmp_path, name):
    _make_mmvp(tmp_path, vlm=name == "mmvpvlm")
    ours, theirs = tmp_path / "ours.txt", tmp_path / "jax.txt"
    got = mmvp.eval_mmvp(_alternating_pair_score(), str(tmp_path), name,
                         str(ours))
    want = jax_mmvp.eval_mmvp(_alternating_pair_score(), str(tmp_path), name,
                              str(theirs))
    assert got == want
    assert abs(got["pair_accuracy"] - 68 * 100 / 135) < 1e-9
    assert ours.read_text() == theirs.read_text()
    csv_file = str(tmp_path / ("Questions.csv" if name == "mmvpvlm"
                               else "Questions-clip.csv"))
    assert mmvp.read_question_pairs(csv_file) == \
        jax_mmvp.read_question_pairs(csv_file)


@pytest.mark.parametrize("dataset", ["a", "a4", "b", "cocoone", "vgtwo"])
def test_load_annotation_matches_jax(tmp_path, dataset):
    files = {"a": "controlled_images_dataset.json",
             "a4": "controlled_images_dataset.json",
             "b": "controlled_clevr_dataset.json",
             "cocoone": "coco_qa_one_obj.json", "vgtwo": "vg_qa_two_obj.json"}
    (tmp_path / files[dataset]).write_text(json.dumps([[1, "x", "y"]]))
    assert whatsup.load_annotation(str(tmp_path), dataset) == \
        jax_whatsup.load_annotation(str(tmp_path), dataset)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    quads = [dict(zip(("q0_i0", "q0_i1", "q1_i0", "q1_i1"),
                      rng.integers(0, 2, 4).astype(float))) for _ in range(40)]
    assert metrics.get_scores(quads) == jax_metrics.get_scores(quads)
    assert metrics.get_scores([list(q.values()) for q in quads]) == \
        jax_metrics.get_scores(quads)
    s = rng.standard_normal((12, 2, 2))
    wino = metrics.winoground_scores(s)
    assert wino == jax_metrics.winoground_scores(s)
    assert metrics.winoground_accuracy(wino) == \
        jax_metrics.winoground_accuracy(wino)
    img, txt = rng.standard_normal((2, 15, 8))
    assert metrics.retrieval_metrics(img, txt) == \
        jax_metrics.retrieval_metrics(img, txt)
    logits, targets = rng.standard_normal((30, 10)), rng.integers(0, 10, 30)
    assert metrics.zero_shot_accuracy(logits, targets) == \
        jax_metrics.zero_shot_accuracy(logits, targets)
