"""Fixtures and helpers of the port's eval tests (tests/test_torch_evals.py,
tests/test_torch_eval_scorers.py, tests/test_torch_eval_cli.py): the
What'sUp / COCO / MMVP fixture files built as in tests/test_evals.py, the
test-tiny checkpoint made from JAX params, the (port, JAX) CLIPScorers over
it, and the PACL / SPARC heads saved by the JAX package as .npz."""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.core.factory import load_params as jax_load_params
from clip_embeds_tpu.core.factory import save_params_npz as jax_save_npz
from clip_embeds_tpu.models import heads as jax_heads
from clip_embeds_tpu.scores.scorers import CLIPScorer as JaxCLIPScorer
from clip_embeds_tpu.scores.scorers import PACLScorer as JaxPACLScorer
from clip_embeds_tpu.scores.scorers import SPARCScorer as JaxSPARCScorer
from clip_embeds_tpu_torch.cli.eval import build_scorer, parse_args
from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.evals import mmvp, whatsup
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


# -- the checkpoint, the CLIPScorers and the heads --------------------------


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


# -- the eval CLI tables -------------------------------------------------


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
