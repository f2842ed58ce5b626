"""The port's evaluations, CLIPScorer, PACLScorer, SPARCScorer, CLIPScore
and eval CLI against the JAX package's (CPU, fp32, the test-tiny config
with one checkpoint made from JAX params, and PACL/SPARC heads saved by the
JAX package as .npz): the same dicts, the same results-file text, the same
scores within 1e-4, and identical tables from both CLIs on fixtures built
as in tests/test_evals.py."""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli.eval import main as jax_main
from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.core.factory import load_params as jax_load_params
from clip_embeds_tpu.core.factory import save_params_npz as jax_save_npz
from clip_embeds_tpu.evals import metrics as jax_metrics
from clip_embeds_tpu.evals import mmvp as jax_mmvp
from clip_embeds_tpu.evals import whatsup as jax_whatsup
from clip_embeds_tpu.models import heads as jax_heads
from clip_embeds_tpu.scores.score import CLIPScore as JaxCLIPScore
from clip_embeds_tpu.scores.score import Score as JaxScore
from clip_embeds_tpu.scores.scorers import CLIPScorer as JaxCLIPScorer
from clip_embeds_tpu.scores.scorers import PACLScorer as JaxPACLScorer
from clip_embeds_tpu.scores.scorers import SPARCScorer as JaxSPARCScorer
from clip_embeds_tpu_torch.cli.eval import build_scorer, main, parse_args
from clip_embeds_tpu_torch.core.convert import (
    head_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.evals import metrics, mmvp, whatsup
from clip_embeds_tpu_torch.models import heads
from clip_embeds_tpu_torch.scores.score import CLIPScore, Score
from clip_embeds_tpu_torch.scores.scorers import (
    CLIPScorer,
    PACLScorer,
    SPARCScorer,
)

KEYS = ["left", "right", "on", "under"]  # What'sUp A-style
OPPOSITE = {"left": "right", "right": "left", "on": "under", "under": "on",
            "above": "below", "below": "above"}


# -- fixtures, built as in tests/test_evals.py ---------------------------


def _make_whatsup(root, n_pairs=4):
    """What'sUp-A format: n_pairs object pairs x 4 images, the annotation
    file of --dataset a / a4."""
    img_dir = root / "controlled_images"
    img_dir.mkdir(exist_ok=True)
    dataset = []
    rng = np.random.default_rng(0)
    for p in range(n_pairs):
        o1, o2 = f"mug{p}", f"table{p}"
        for key in KEYS:
            name = f"{o1}_{key}_of_the_{o2}.jpeg"
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                            ).save(img_dir / name)
            gt = (f"A {o1} {key} of a {o2}" if key in ("left", "right")
                  else f"A {o1} {key} a {o2}")
            others = [k for k in KEYS if k not in (key, OPPOSITE[key])]
            dataset.append({
                "image_path": f"data/controlled_images/{name}",
                "caption_options": [gt, gt.replace(key, OPPOSITE[key])]
                + [gt.replace(key, o) for o in others],
            })
    with open(root / "controlled_images_dataset.json", "w") as fh:
        json.dump(dataset, fh)
    return dataset


def _make_coco(root):
    """COCO-spatial one-object format (coco_qa_one_obj.json)."""
    os.makedirs(root / "val2017", exist_ok=True)
    dataset = []
    rng = np.random.default_rng(1)
    for i, prep in enumerate(["left", "right", "above", "below"]):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(root / "val2017" / f"{str(i + 1).zfill(12)}.jpg")
        dataset.append([i + 1, f"A photo of a dog to the {prep} of a cat",
                        f"A photo of a dog to the {OPPOSITE[prep]} of a cat"])
    with open(root / "coco_qa_one_obj.json", "w") as fh:
        json.dump(dataset, fh)
    return dataset


def _make_mmvp(root, vlm=True, n_pairs=135):
    """MMVP-VLM (9 categories x 15 pairs, MLLM_VLM_Images/<category>/) or
    MMVP (MMVP_Images/, Questions-clip.csv) format."""
    cats = mmvp.MMVP_VLM_CATEGORIES
    img_dir = root / ("MLLM_VLM_Images" if vlm else "MMVP_Images")
    rows = [["qid", "type", "statement"]]
    rng = np.random.default_rng(2)
    qid = 1
    for p in range(n_pairs):
        cat = cats[p // 15] if vlm else "Unknown"
        folder = img_dir / cat if vlm else img_dir
        os.makedirs(folder, exist_ok=True)
        for _ in range(2):
            Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)
                            ).save(folder / f"{qid}.jpg")
            rows.append([str(qid), cat, f"statement number {qid}"])
            qid += 1
    name = "Questions.csv" if vlm else "Questions-clip.csv"
    with open(root / name, "w", newline="") as f:
        csv.writer(f).writerows(rows)


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


# -- the scorer and CLIPScore ----------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    _, params = jax_create_model("test-tiny", seed=5)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save(state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
               path)
    return str(path)


@pytest.fixture(scope="module")
def scorers(checkpoint):
    """(port, JAX) CLIPScorers over the same weights, fp32, batch 4."""
    model, params = jax_create_model("test-tiny", checkpoint)
    ours = CLIPScorer(create_model("test-tiny", checkpoint), batch_size=4)
    assert ours.route == "composable"
    return ours, JaxCLIPScorer(model, params, batch_size=4)


def _samples(tmp_path):
    dataset = _make_whatsup(tmp_path, n_pairs=2)
    return [(str(tmp_path / d["image_path"][5:]), d["caption_options"])
            for d in dataset]


@pytest.mark.parametrize("method", ["score_batch", "pair_score",
                                    "score_matrix"])
def test_clip_scorer_matches_jax(tmp_path, scorers, method):
    samples = _samples(tmp_path)  # 8 images in batches of 4 (+ a tail)
    images = [s[0] for s in samples][:7]
    texts = [s[1][0] for s in samples][:7]
    args = {"score_batch": (samples[:7],), "pair_score": (images[:2], texts[:2]),
            "score_matrix": (images, texts[:5])}[method]
    got, want = (getattr(s, method)(*args) for s in scorers)
    if method == "score_batch":
        assert [len(g) for g in got] == [len(w) for w in want] == [4] * 7
        got, want = np.stack(got), np.stack(want)
    assert got.shape == np.shape(want) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,batch,sizes", [(10, 4, [4, 4, 4]),
                                           (2, 64, [2]), (8, 8, [8])])
def test_batched_runs_one_size_per_call(n, batch, sizes):
    """Batches of min(batch, n) rows, the tail padded and sliced off; the
    rows are those of one unbatched call."""
    from clip_embeds_tpu_torch.scores.scorers import _batched

    items = np.random.default_rng(4).standard_normal((n, 3)).astype("f4")
    seen = []

    def encode(chunk):
        seen.append(len(chunk))
        return torch.from_numpy(chunk * 2).to(torch.bfloat16)

    out = _batched(encode, items, batch)
    assert seen == sizes and out.dtype == np.float32
    np.testing.assert_array_equal(
        out, torch.from_numpy(items * 2).to(torch.bfloat16).float().numpy())


def test_clip_score_matches_jax(tmp_path, checkpoint):
    samples = _samples(tmp_path)
    images = [s[0] for s in samples][:5]
    texts = [s[1][0] for s in samples][:3]
    model, params = jax_create_model("test-tiny", checkpoint)
    ours = CLIPScore(create_model("test-tiny", checkpoint), batch_size=4)
    theirs = JaxCLIPScore(model, params, batch_size=4)
    got, want = ours(images, texts), theirs(images, texts)
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    dataset = [{"images": images[i:i + 2], "texts": texts[:2]}
               for i in range(0, 4, 2)]
    got = ours.batch_forward(dataset, batch_size=1)
    want = theirs.batch_forward(dataset, batch_size=1)
    assert got.shape == want.shape == (2, 2, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# the PACL/SPARC heads: (scorer, CLI flags, JAX head kwargs)
HEAD_VARIANTS = {
    "pacl": ("pacl", [], {}),
    "pacl-rope-after": ("pacl", ["--rope", "after"], {"rope": "after"}),
    "sparc": ("sparc", [], {}),
    "sparc-local": ("sparc", ["--sparc-local"], {}),
}


@pytest.fixture(scope="module")
def head_npz(tmp_path_factory):
    """A PACL and a SPARC head for test-tiny (proj_dim = embed_dim, as the
    eval CLI builds them), initialised and saved by the JAX package, LN
    params moved off their init so that every parameter matters."""
    model, _ = jax_create_model("test-tiny", seed=5)
    cfg = model.cfg
    patches = np.zeros((1, cfg.vision.num_patches, cfg.vision.width), "f4")
    text = {"pacl": np.zeros((1, cfg.embed_dim), "f4"),
            "sparc": np.zeros((1, cfg.text.context_length, cfg.text.width),
                              "f4")}
    rng = np.random.default_rng(6)
    out = {}
    for kind, cls in (("pacl", jax_heads.PACLHead),
                      ("sparc", jax_heads.SPARCHead)):
        params = cls(proj_dim=cfg.embed_dim).init(
            jax.random.PRNGKey(7), patches, text[kind])["params"]
        params = jax.tree.map(
            lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
                np.shape(a)).astype("f4"), params)
        out[kind] = str(tmp_path_factory.mktemp("head") / f"{kind}.npz")
        jax_save_npz(params, out[kind])
    return out


def _head_scorers(checkpoint, head_npz, variant):
    """(port, JAX) scorers of a HEAD_VARIANTS entry over the same CLIP
    weights and head .npz, fp32, batch 4; the port's built by the eval
    CLI."""
    kind, flags, kw = HEAD_VARIANTS[variant]
    ours = build_scorer(parse_args([
        "--scorer", kind, "--model", "test-tiny", "--pretrained", checkpoint,
        "--model-path", head_npz[kind], "--precision", "fp32", "--device",
        "cpu", "--batch-size", "4", "--root-dir", "x"] + flags))
    model, params = jax_create_model("test-tiny", checkpoint)
    head_params = jax_load_params(head_npz[kind])
    if kind == "pacl":
        theirs = JaxPACLScorer(model, params, jax_heads.PACLHead(
            proj_dim=model.cfg.embed_dim, **kw), head_params, batch_size=4)
        assert isinstance(ours, PACLScorer) and ours.head.pooling == "uniform"
        assert ours.head.rope == kw.get("rope", "none")
        assert ours.per_pair == theirs.per_pair
    else:
        theirs = JaxSPARCScorer(model, params, jax_heads.SPARCHead(
            proj_dim=model.cfg.embed_dim), head_params, batch_size=4,
            local=variant == "sparc-local")
        assert isinstance(ours, SPARCScorer)
        assert (ours.local, ours.sigma) == (theirs.local, 1 / 625)
    assert ours.route == "composable"
    return ours, theirs


@pytest.mark.parametrize("method", ["score_batch", "pair_score"])
@pytest.mark.parametrize("variant", list(HEAD_VARIANTS))
def test_head_scorers_match_jax(tmp_path, checkpoint, head_npz, variant,
                                method):
    """PACLScorer (diagonal compare, the image tiled per option) and
    SPARCScorer (global and local) give JAX's scores within 1e-4."""
    scorers = _head_scorers(checkpoint, head_npz, variant)
    samples = _samples(tmp_path)[:5]  # 5 images: a batch of 4 and a tail
    args = {"score_batch": (samples,),
            "pair_score": ([s[0] for s in samples[:3]],
                           samples[0][1][:2])}[method]
    got, want = (getattr(s, method)(*args) for s in scorers)
    if method == "score_batch":
        assert [len(g) for g in got] == [len(w) for w in want] == [4] * 5
        got, want = np.stack(got), np.stack(want)
    assert got.shape == np.shape(want) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.ptp(got) > 1e-2  # the scores are not all alike


def test_pacl_scorer_takes_precomputed_text_embeddings(tmp_path,
                                                      checkpoint):
    """``text_encoder`` (texts -> embeddings, the LLM2CLIP-PACL variant's
    precomputed text side) replaces the CLIP text tower, as in JAX."""
    model, params = jax_create_model("test-tiny", checkpoint)
    cfg = model.cfg
    jhead = jax_heads.PACLHead(proj_dim=32, rope="after")
    params_h = jhead.init(jax.random.PRNGKey(8), np.zeros(
        (1, cfg.vision.num_patches, cfg.vision.width), "f4"),
        np.zeros((1, 24), "f4"))["params"]
    path = str(tmp_path / "llm_head.npz")
    jax_save_npz(params_h, path)
    head = heads.PACLHead(cfg.vision.width, 24, 32, rope="after")
    head.load_state_dict(head_state_dict_from_jax_params(
        jax_load_params(path)))

    def encode(texts):  # a fixed 24-wide embedding per text
        return np.stack([np.random.default_rng(len(t)).standard_normal(24)
                         .astype("f4") for t in texts])

    ours = PACLScorer(create_model("test-tiny", checkpoint), head,
                      batch_size=4, text_encoder=encode)
    theirs = JaxPACLScorer(model, params, jhead, params_h, batch_size=4,
                           text_encoder=encode)
    samples = _samples(tmp_path)[:3]
    got = np.stack(ours.score_batch(samples))
    want = np.stack(theirs.score_batch(samples))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _mock_forwards():
    """Pair, image-texts and group forwards whose score encodes the call."""
    def pair(images, texts):
        return np.array([len(i) + 10.0 * len(t) for i, t in zip(images, texts)])

    def image_texts(image, texts):
        return np.array([100.0 * len(image) + len(t) for t in texts])

    def groups(images, texts):
        return np.array([[1000.0 * len(i) + len(t) for t in ts]
                         for i, ts in zip(images, texts)])
    return pair, image_texts, groups


@pytest.mark.parametrize("kind", ["pair", "image_texts", "groups"])
def test_score_api_matches_jax(kind):
    pair, image_texts, groups = _mock_forwards()
    kw = {"pair": {}, "image_texts": {"image_texts_forward": image_texts},
          "groups": {"image_texts_forward": image_texts,
                     "groups_forward": groups, "group_size": 2}}[kind]
    ours, theirs = Score(pair, **kw), JaxScore(pair, **kw)
    images = ["a.jpg", "bb.jpg", "ccc.jpg"]
    texts = ["x", "yy", "zzzz"]
    np.testing.assert_array_equal(ours(images, texts), theirs(images, texts))
    np.testing.assert_array_equal(ours("a.jpg", "x"), theirs("a.jpg", "x"))
    dataset = [{"images": images[:2], "texts": texts[:2]},
               {"images": images[1:], "texts": texts[1:]}]
    np.testing.assert_array_equal(ours.batch_forward(dataset, batch_size=1),
                                  theirs.batch_forward(dataset, batch_size=1))


# -- the CLI -----------------------------------------------------------------


def _recording(fn, log):
    def wrapped(*args):
        out = fn(*args)
        log.append(np.asarray(out, np.float64))
        return out
    return wrapped


def _fp32_margin_and_diff(root, dataset, scorers):
    """The least margin of a decision under the port's fp32 scores, and the
    largest score difference between the two packages, on the fixture."""
    logs = ([], [])
    for scorer, log in zip(scorers, logs):
        if dataset in ("mmvp", "mmvpvlm"):
            mmvp.eval_mmvp(_recording(scorer.pair_score, log), root, dataset)
            continue
        batch = _recording(scorer.score_batch, log)
        data, _ = whatsup.load_annotation(root, dataset)
        if dataset.startswith("coco"):
            whatsup.eval_coco_vg(batch, data, root, "coco")
        else:
            whatsup.eval_whatsup(batch, data, root, dataset.endswith("4"))
    if dataset in ("mmvp", "mmvpvlm"):
        ours = np.stack(logs[0])
        margin = np.abs(ours[:, :, 0] - 0.5).min()
        diff = np.abs(ours - np.stack(logs[1])).max()
    else:
        ours, theirs = np.concatenate(logs[0]), np.concatenate(logs[1])
        # a sample is right when option 0 beats every other option scored:
        # its margin is the least lead where it is right, else the largest
        # deficit
        n_opt = 4 if dataset.endswith("4") else 2
        lead = ours[:, :1] - ours[:, 1:n_opt]
        margin = np.where((lead > 0).all(1), lead.min(1),
                          (-lead).max(1)).min()
        diff = np.abs(ours - theirs).max()
    return margin, diff


_FIXTURES = {"a": _make_whatsup, "a4": _make_whatsup, "cocoone": _make_coco,
             "mmvpvlm": lambda root: _make_mmvp(root, vlm=True),
             "mmvp": lambda root: _make_mmvp(root, vlm=False)}


@pytest.mark.parametrize("dataset", list(_FIXTURES))
def test_eval_cli_tables_match_jax(tmp_path, checkpoint, scorers, dataset,
                                   capsys):
    _FIXTURES[dataset](tmp_path)
    root = str(tmp_path)
    margin, diff = _fp32_margin_and_diff(root, dataset, scorers)
    # a table can only be held equal where no decision is a near-tie
    assert margin >= 10 * diff, (margin, diff)
    common = ["--scorer", "clip", "--model", "test-tiny", "--pretrained",
              checkpoint, "--dataset", dataset, "--root-dir", root,
              "--precision", "fp32", "--batch-size", "8"]
    ours, theirs = tmp_path / "ours.txt", tmp_path / "jax.txt"
    got = main(common + ["--results-file", str(ours), "--device", "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_main(common + ["--results-file", str(theirs)])
    assert got == want
    assert ours.read_text() == theirs.read_text()
    assert info["route"] == "composable" and info["device"] == "cpu"
    assert info["decoder"] in ("native", "pil") and info["samples"] > 0


@pytest.mark.parametrize("dataset", ["a", "a4", "mmvpvlm"])
@pytest.mark.parametrize("variant", ["pacl-rope-after", "sparc-local"])
def test_eval_cli_head_tables_match_jax(tmp_path, checkpoint, head_npz,
                                        variant, dataset, capsys):
    """--scorer pacl|sparc --model-path <a JAX head .npz> [--rope]
    [--sparc-local]: the same table and results-file text as JAX's CLI."""
    _FIXTURES[dataset](tmp_path)
    root = str(tmp_path)
    margin, diff = _fp32_margin_and_diff(
        root, dataset, _head_scorers(checkpoint, head_npz, variant))
    assert margin >= 10 * diff, (margin, diff)
    kind, flags, _ = HEAD_VARIANTS[variant]
    common = ["--scorer", kind, "--model", "test-tiny", "--pretrained",
              checkpoint, "--model-path", head_npz[kind], "--dataset",
              dataset, "--root-dir", root, "--precision", "fp32",
              "--batch-size", "8"] + flags
    ours, theirs = tmp_path / "ours.txt", tmp_path / "jax.txt"
    got = main(common + ["--results-file", str(ours), "--device", "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_main(common + ["--results-file", str(theirs)])
    assert got == want
    assert ours.read_text() == theirs.read_text()
    assert info["scorer"] == kind and info["route"] == "composable"


@pytest.mark.parametrize("argv,item", [
    (["--scorer", "siglip", "--model", "ViT-SO400M-14-SigLIP-384"], "10"),
    (["--scorer", "pacl"], "9"),
    (["--scorer", "sparc"], "9"), (["--scorer", "embedding"], "12"),
    (["--rope", "after"], "9"), (["--sparc-local"], "9")])
def test_unported_scorers_name_their_roadmap_item(tmp_path, capsys, argv,
                                                  item, checkpoint):
    """The scorers of ported ROADMAP.md items: those of item 9 (PACL/SPARC)
    and their flags parse and build their scorers; item 10's (SigLIP) exits
    as the JAX CLI does, for want of a sentencepiece vocabulary path
    (tests/test_torch_siglip.py holds both packages to it); item 12's
    (VLM2Vec) ``--scorer embedding`` raises the JAX CLI's
    NotImplementedError, the same message from both packages."""
    common = ["--root-dir", str(tmp_path)]
    if item == "10":
        with pytest.raises(SystemExit, match="SigLIP tokenizer needs "
                           "sentencepiece"):
            main(argv + common)
        return
    if item == "12":
        tiny = common + ["--model", "test-tiny", "--results-file",
                         str(tmp_path / "results.txt")]
        with pytest.raises(NotImplementedError) as want:
            jax_main(argv + tiny)
        with pytest.raises(NotImplementedError) as got:
            main(argv + tiny + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
        assert "construct scores.embedding_scorer.EmbeddingScorer" in str(
            got.value)
        return
    if "--scorer" not in argv:  # the head flags, with their scorer
        argv = argv + ["--scorer", "pacl" if "--rope" in argv else "sparc"]
    args = parse_args(argv + common + [
        "--model", "test-tiny", "--pretrained", checkpoint, "--device",
        "cpu", "--precision", "fp32"])
    scorer = build_scorer(args)
    assert isinstance(scorer, PACLScorer if args.scorer == "pacl"
                      else SPARCScorer)
    if args.scorer == "pacl":
        assert scorer.head.rope == args.rope and not scorer.head.training
    else:
        assert scorer.local == ("--sparc-local" in argv)


def test_eval_runs_on_the_card_unless_asked(tmp_path, checkpoint,
                                            monkeypatch):
    """--device defaults to cuda; without a card the command exits with an
    error instead of running on the CPU unasked."""
    assert parse_args(["--root-dir", "x"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _make_coco(tmp_path)
    args = ["--model", "test-tiny", "--pretrained", checkpoint, "--dataset",
            "cocoone", "--root-dir", str(tmp_path), "--results-file",
            str(tmp_path / "r.txt")]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(args)
    assert not (tmp_path / "r.txt").exists()
    assert main(args + ["--device", "cpu", "--precision", "fp32"])[
        "individual_accuracy"] in (0.0, 25.0, 50.0, 75.0, 100.0)
