"""The entry points at 2 gloo ranks against the port's one-process runs
(fp32, CPU): ``cli/train.py`` through DDP and with ``--fsdp`` at the same
global ``--batch-size`` (also with distillation, ``--siglip``, hard texts,
``--lock-image``, the CSV loader and validation, whose results.jsonl rank
0 writes), an FSDP checkpoint written at 2 ranks resuming in
one process and a one-process checkpoint resuming at 2 ranks, and
``cli/train_vlm2vec.py --data_parallel 2`` at half the batch a device,
and ``--model_parallel 2 --data_parallel 1`` (JAX's 1 x 2 mesh of
replicas) at the whole batch a device.
The ranks' runs share one spawn (tests/torch_dist_fixtures.py).
Tolerances: losses rel 1e-5; parameters atol 1e-4, a tenth of the lr of
the 2 AdamW steps: Adam divides each gradient by its own running
magnitude, so where a gradient is near 0 the ranks' reduction order (the
SigLIP ring's above all, 1.9e-5 read here) moves an update by a share of
lr; Adam hides a gradient's scale, which tests/test_torch_parallel_train.py
holds to JAX's through SGD; a checkpoint equal bit for bit to the state it
was written from."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import torch_dist_fixtures as dfx
from clip_embeds_tpu_torch.cli import train as port_train
from clip_embeds_tpu_torch.cli import train_vlm2vec
from clip_embeds_tpu_torch.core import checkpoint as ckpt
from clip_embeds_tpu_torch.core.config import get_model_config

COMMON = ["--model", "test-tiny", "--dataset-type", "synthetic",
          "--precision", "fp32", "--batch-size", "8",
          "--train-num-samples", "16", "--lr", "1e-3", "--warmup", "1",
          "--wd", "0.1", "--log-every", "1", "--device", "cpu"]
V2V = ["--lora", "--lora_r", "4", "--no_bf16", "--max_steps", "2",
       "--grad_cache", "--gc_q_chunk_size", "1", "--logging_steps", "1",
       "--device", "cpu"]


def _write_val(root, n=16, size=40, seed=4):
    """A CSV of ``n`` PNGs and captions, for --val-data and the CSV
    loader (2 steps at batch 8)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "val"), exist_ok=True)
    lines = ["filepath\ttitle"]
    for i in range(n):
        path = os.path.join(root, "val", f"{i}.png")
        Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                     np.uint8)).save(path)
        lines.append(f"{path}\ta photo of thing {i}")
    with open(os.path.join(root, "val.tsv"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return os.path.join(root, "val.tsv")


def _routes(root, teacher, val):
    """Each route's flags at 2 ranks; the one-process run drops --fsdp
    (and logs elsewhere)."""
    return {
        "ddp": [],
        "fsdp": ["--fsdp"],
        "distill_ddp": ["--distill-model", "test-tiny",
                        "--distill-pretrained", teacher],
        "siglip_fsdp": ["--siglip", "--fsdp"],
        "hardtext_ddp": ["--usehardtext"],
        # each rank decodes its rows of the CSV's global batches
        "csv_ddp": ["--dataset-type", "csv", "--train-data", val],
        # the freeze labels and the decay split read FSDP's parameters by
        # their names as one process's
        "lock_image_fsdp": ["--fsdp", "--lock-image"],
        "val_fsdp": ["--fsdp", "--val-data", val, "--val-num-samples", "8",
                     "--report-to", "jsonl", "--name", "run"],
    }


def _one_process(argv, logs):
    """The port's CLI in this process: (state, the losses it logged)."""
    logger, records = logging.getLogger(), []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep()
    logger.addHandler(keep)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        state = port_train.main([a for a in argv if a != "--fsdp"]
                                + ["--logs", logs])
    finally:
        logger.removeHandler(keep)
        logger.setLevel(old)
    return state, [float(m.split(" loss ")[1].split()[0])
                   for m in records if " loss " in m and "step" in m]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs here, the 2-rank runs in one spawn."""
    root = tmp_path_factory.mktemp("cli")
    cfg = get_model_config("test-tiny")
    paths = {}
    for name, seed in (("start", 21), ("teacher", 22)):
        paths[name] = str(root / f"{name}.pt")
        torch.save(dfx.random_state_dict(cfg, seed=seed), paths[name])
    base = COMMON + ["--pretrained", paths["start"]]
    routes = _routes(str(root), paths["teacher"], _write_val(str(root)))
    one_dir, two_dir = str(root / "one"), str(root / "two")
    one = {label: _one_process(base + flags, str(root / "logs1"))
           for label, flags in routes.items()}
    _one_process(base + ["--checkpoint-dir", one_dir], str(root / "logs1"))
    v_one = train_vlm2vec.main(V2V + ["--per_device_train_batch_size", "4"])
    one_ckpt = os.path.join(one_dir, "epoch_1.pt")
    two_ckpt = os.path.join(two_dir, "epoch_1.pt")

    def resume(path, out, lr="1e-3"):
        return ["--checkpoint-dir", str(root / out), "--resume", path,
                "--epochs", "2", "--lr", lr]

    got = dfx.run_ranks(dfx.cli_runs_rank, 2, root / "ranks", [
        ("train", base + flags + ["--logs", str(root / "logs2")])
        for flags in routes.values()] + [
        ("train", base + ["--fsdp", "--checkpoint-dir", two_dir]),
        # the one-process checkpoint at 2 ranks: loaded (lr 0 keeps it),
        # then trained on
        ("train", base + ["--fsdp"] + resume(one_ckpt, "r0", "0")),
        ("train", base + ["--fsdp"] + resume(one_ckpt, "r1")),
        ("vlm2vec", V2V + ["--per_device_train_batch_size", "2",
                           "--data_parallel", "2"]),
        ("vlm2vec", V2V + ["--per_device_train_batch_size", "4",
                           "--model_parallel", "2", "--data_parallel", "1"]),
    ])
    # the 2-rank FSDP checkpoint in one process, and the one-process
    # checkpoint's own continuation
    loaded = port_train.main(base + resume(two_ckpt, "p0", "0"))
    resumed = port_train.main(base + resume(one_ckpt, "p1"))
    n = len(routes)
    return {"one": one, "labels": list(routes), "v_one": v_one,
            "ranks": [r[:n] for r in got], "more": [r[n:] for r in got],
            "loaded": loaded, "resumed": resumed, "root": root,
            "ckpts": (one_ckpt, two_ckpt)}


def _close(a, b, atol=1e-4):
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        torch.testing.assert_close(a[k], v, rtol=0, atol=atol, msg=k)


@pytest.mark.parametrize("label", list(_routes("", "", "")))
def test_train_cli_at_two_ranks_equals_one_process(runs, label):
    i = runs["labels"].index(label)
    r0, r1 = (r[i] for r in runs["ranks"])
    state, losses = runs["one"][label]
    assert r0["step"] == r1["step"] == state.step == 2
    # rank 0 logs the global batch's loss; the other ranks log nothing
    assert r0["losses"] == pytest.approx(losses, rel=1e-5)
    assert r1["losses"] == [] and r1["state_dict"] is None
    _close(r0["state_dict"], state.model.state_dict())
    if label == "val_fsdp":
        # rank 0 alone writes results.jsonl: the validation's numbers
        lines = [[json.loads(ln) for ln in open(
            runs["root"] / logs / "run" / "results.jsonl")]
            for logs in ("logs1", "logs2")]
        assert len(lines[1]) == len(lines[0]) == 1
        for k, v in lines[0][0].items():
            assert lines[1][0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_fsdp_checkpoint_resumes_in_one_process_and_back(runs):
    """The 2-rank FSDP checkpoint holds the whole state rank 0 gathered
    and loads bit for bit into one process; the one-process checkpoint
    loads bit for bit at 2 ranks under FSDP, and trains on there as in
    one process."""
    one_ckpt, two_ckpt = runs["ckpts"]
    fsdp, loaded2, resumed2 = runs["more"][0][:3]
    saved = ckpt.load(two_ckpt)
    assert saved["step"] == 1
    for k, v in fsdp["state_dict"].items():
        assert torch.equal(saved["state_dict"][k], v), k
    # at lr 0 a resumed run ends where it started
    for k, v in saved["state_dict"].items():
        assert torch.equal(runs["loaded"].model.state_dict()[k], v), k
    start = ckpt.load(one_ckpt)["state_dict"]
    for k, v in start.items():
        assert torch.equal(loaded2["state_dict"][k], v), k
    assert runs["resumed"].step == resumed2["step"] == 2
    _close(resumed2["state_dict"], runs["resumed"].model.state_dict())
    moved = sum(not torch.equal(resumed2["state_dict"][k], v)
                for k, v in start.items())
    assert moved > 0.9 * len(start)


def test_vlm2vec_data_parallel_equals_one_process(runs):
    """--data_parallel 2 at 2 a device is the global batch of 4 that one
    process trains: the losses, and the adapters after 2 AdamW steps."""
    state, report = runs["v_one"]
    for r in runs["more"]:
        got = r[3]
        assert got["report"]["losses"] == pytest.approx(report["losses"],
                                                        rel=1e-5)
        for k, ab in state.params.items():
            for n, t in ab.items():
                torch.testing.assert_close(got["adapters"][k][n], t,
                                           rtol=0, atol=1e-5, msg=(k, n))


def test_vlm2vec_model_parallel_equals_one_process(runs):
    """--model_parallel 2 --data_parallel 1 at 4 a device: JAX's 1 x 2
    mesh, whose model axis holds whole replicas, trains the global batch of
    4 that one process trains; both ranks draw the same rows and end with
    the one process's losses and adapters."""
    state, report = runs["v_one"]
    for r in runs["more"]:
        got = r[4]
        assert got["report"]["losses"] == pytest.approx(report["losses"],
                                                        rel=1e-5)
        for k, ab in state.params.items():
            for n, t in ab.items():
                torch.testing.assert_close(got["adapters"][k][n], t,
                                           rtol=0, atol=1e-5, msg=(k, n))
