"""The plain references against the port on tiny configurations on the CPU
(the same seeded weights on both sides), and each driver run end to end at
a tiny size through the harness, faults and all. Only this file and the
isolation test import the port; the references never do."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import check, harness
from port_bench.faults import FAULTS
from port_bench.inputs import image_batches, token_batches, train_batches
from port_bench.port import build_clip
from port_bench.reference import train as ref_train
from port_bench.reference.towers import encode_image, encode_text
from port_bench.tests import tiny
from port_bench.weights import make_weights

CPU = torch.device("cpu")
CELLS = [
    ("vitl336-images-b256", "vitl14_336_openai", "images_b256",
     "answer_altered"),
    ("vitl336-texts-b256", "vitl14_336_openai", "texts_b256",
     "answer_altered"),
    ("eva01g14-train-b64", "eva01_g14", "train_b64", "half_batch"),
    ("eva01g14-train-b64", "eva01_g14", "train_b64", "state_unchanged"),
    ("vitl336-lit-hardneg-b256", "vitl14_336_openai", "lit_hardneg_b256",
     "half_batch"),
    ("vitl336-lit-hardneg-b256", "vitl14_336_openai", "lit_hardneg_b256",
     "state_unchanged"),
    ("vitl336-images-b256", "vitl14_336_openai", "images_b256",
     "rows_permuted"),
    ("vitl336-images-b256", "vitl14_336_openai", "images_b256",
     "stale_batch"),
    ("vitl336-texts-b256", "vitl14_336_openai", "texts_b256",
     "rows_permuted"),
    ("vitl336-texts-b256", "vitl14_336_openai", "texts_b256",
     "stale_batch"),
]


def _fp32(traffic):
    """Tiny traffic computed in fp32 on the CPU: the plumbing is checked,
    not the card's rounding."""
    t = dict(traffic)
    if "dtype" in t:
        t["dtype"] = "float32"
    if "precision" in t:
        t["precision"] = "fp32"
    return t


@pytest.mark.parametrize("name", ["vitl14_336_openai", "eva01_g14"])
def test_towers_match_the_port(name):
    config = tiny.config(name)
    w = make_weights(config, 3, CPU, torch.float32)
    model = build_clip(config, w, CPU, torch.float32)
    images = image_batches(config, 1, 4, 3, "t", CPU)[0]
    ids = torch.from_numpy(token_batches(config, 1, 4, 3, 12, 3, "t")[0])
    with torch.no_grad():
        for port, ref in (
                (model.encode_image(images, normalize=True),
                 encode_image(w, config, images)),
                (model.encode_text(ids, normalize=True),
                 encode_text(w, config, ids))):
            torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-5)


def test_losses_match_the_port():
    from clip_embeds_tpu_torch.losses import clip_loss as port

    g = torch.Generator().manual_seed(0)
    img, txt, hard = (torch.nn.functional.normalize(
        torch.randn(n, 16, generator=g), dim=-1) for n in (6, 6, 3))
    scale = torch.tensor(14.3)
    torch.testing.assert_close(ref_train.clip_loss(img, txt, scale),
                               port.clip_loss(img, txt, scale))
    torch.testing.assert_close(
        ref_train.hard_text_loss(img, txt, hard, scale),
        port.clip_loss_hard_text(img, txt, hard, scale))


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(4, 3, generator=g),
              "b.bias": torch.randn(3, generator=g)}
    mine = {k: v.clone() for k, v in params.items()}
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt = torch.optim.AdamW(
        [{"params": [theirs["w"]], "weight_decay": 0.1},
         {"params": [theirs["b.bias"]], "weight_decay": 0.0}],
        lr=1e-3, betas=(0.9, 0.98), eps=1e-6)
    ref = ref_train.AdamW(mine, 1e-3, 0.9, 0.98, 1e-6, 0.1)
    for t in range(3):
        grads = {k: torch.randn(v.shape, generator=g)
                 for k, v in params.items()}
        lr = 1e-3 * (t + 1)
        for k, p in theirs.items():
            p.grad = grads[k].clone()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        ref.step(grads, lr)
    for k in params:
        torch.testing.assert_close(mine[k], theirs[k].detach())


def test_training_reference_follows_the_port_in_fp32():
    config, traffic = tiny.config("eva01_g14"), _fp32(tiny.traffic(
        "train_b64"))
    b = harness.Bench("eva01g14-train-b64", config, traffic, {}, 5, 0.1,
                      False, CPU, time.perf_counter())
    from port_bench.drivers import train_clip

    state, step_fn, model = train_clip.build_state(b)
    pool = train_batches(config, traffic, 5, CPU)
    losses = [float(step_fn(state, pool[k])["loss"]) for k in range(3)]
    ref = train_clip.reference(b, "fp32")
    assert losses == pytest.approx(ref["losses"], abs=1e-5)


@pytest.mark.parametrize("cell,config,traffic,fault", CELLS)
def test_driver_end_to_end_and_fault(cell, config, traffic, fault, capsys):
    """A run prints a well-formed last line and is correct; the same run
    with ``fault`` planted under the timed path is not."""
    cfg, tr = tiny.config(config), _fp32(tiny.traffic(traffic))
    info = {}
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.2, False, CPU,
                         time.perf_counter(), config=cfg, traffic=tr,
                         info=info)
    harness.report(r, info)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True, last["checks"]
    bench = harness.benchmark()
    mine = [m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]
    assert sorted(last["metrics"]) == sorted(mine)
    assert all(v["value"] > 0 for v in last["metrics"].values())
    assert sorted(last["checks"]) == sorted(
        harness.read_json("limits", cell + ".json")["limits"])
    with FAULTS[fault]():
        bad = harness.run_cell(cell, 2 ** 31 + 11, 0.2, False, CPU,
                               time.perf_counter(), config=cfg, traffic=tr)
    assert bad["correct"] is False, bad["checks"]


@pytest.mark.parametrize("cell,config,traffic",
                         [c[:3] for c in CELLS[:3]] + [CELLS[4][:3]])
def test_traced_run_reads_its_metrics_or_none(cell, config, traffic):
    """A traced run on the CPU has no device work: the device readers
    return nothing, the host ones their numbers."""
    r = harness.run_cell(cell, 7, 0.2, True, CPU, time.perf_counter(),
                         config=tiny.config(config),
                         traffic=_fp32(tiny.traffic(traffic)))
    assert r["correct"] is True
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert not any(k.endswith("roofline") or k.startswith(("device_idle",
                                                            "mfu"))
                   for k in r["metrics"])
    assert len(r["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell,config,traffic",
                         [c[:3] for c in CELLS[:3]] + [CELLS[4][:3]])
def test_controls_run(cell, config, traffic):
    cfg, tr = tiny.config(config), tiny.traffic(traffic)
    b = harness.Bench(cell, cfg, tr, {}, 9, 0.1, False, CPU,
                      time.perf_counter())
    driver = harness.load_file("drivers", tr["kind"])
    kinds = ["int8", "fp8"] if tr["kind"].startswith("embed") else ["fp8"]
    for kind in kinds:
        out = driver.control(b, kind)
        assert all(v == v for v in out.values() if isinstance(v, float))


def test_run_refuses_without_a_card():
    root = harness.ROOT
    p = subprocess.run(
        [sys.executable, os.path.join(root, "port_bench", "run.py"),
         "--workload", "vitl336-images-b256", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_run_refuses_without_the_port(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    the run prints no result and fails."""
    root = harness.ROOT
    subprocess.run(["cp", "-r", os.path.join(root, "port_bench"),
                    os.path.join(root, "BENCHMARK.json"), str(tmp_path)],
                   check=True)
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "vitl336-images-b256", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_leaf_views_split_the_packed_bias():
    config = tiny.config("eva01_g14")
    model = build_clip(config, make_weights(config, 1, CPU, torch.float32),
                       CPU, torch.float32)
    views = check.leaf_views(model)
    key = "visual.trunk.blocks.0.attn.v_bias"
    p, off, shape = views[key]
    torch.testing.assert_close(check.view(p.detach(), off, shape),
                               model.state_dict()[key])
    norms = check.norms({"a.attn.in_proj_bias": torch.ones(6)})
    assert sorted(norms) == ["a.attn.in_proj_bias[k]",
                             "a.attn.in_proj_bias[q]",
                             "a.attn.in_proj_bias[v]"]


def test_inputs_keep_the_work_across_seeds():
    config = tiny.config("vitl14_336_openai")
    a = token_batches(config, 2, 8, 3, 12, 1, "t")
    b = token_batches(config, 2, 8, 3, 12, 2 ** 40 + 3, "t")
    eot = config["text"]["eot_id"]
    lengths = lambda bs: [sorted((x == eot).argmax(1).tolist()) for x in bs]
    assert lengths(a) == lengths(b)
    assert not all((x == y).all() for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vitl336-images-b256",
                                  "vitl336-texts-b256",
                                  "eva01g14-train-b64",
                                  "vitl336-lit-hardneg-b256"])
def test_control_fails_at_the_cells_size(cell, card):
    """On the card, at the cell's own size: the control (the port's --int8
    path for the embedding cells, the reference in float8 for training)
    breaks a limit on three seeds."""
    spec = next(w for w in harness.benchmark()["workloads"]
                if w["name"] == cell)
    config = harness.read_json("configs", spec["config"] + ".json")
    traffic = harness.read_json("traffic", spec["traffic"] + ".json")
    limits = harness.read_json("limits", cell + ".json")["limits"]
    driver = harness.load_file("drivers", traffic["kind"])
    for seed in (3000000001, 3000000002, 3000000003):
        b = harness.Bench(cell, config, traffic, limits, seed, 3.0, False,
                          card, time.perf_counter())
        out = driver.control(b)
        assert any(out[k] > lim for k, lim in limits.items()), out
        torch.cuda.empty_cache()


def test_embedding_checks_hold_every_row_to_its_pool_row():
    """Row j is judged against pool row j % P, in chunks, over a pool
    cycled two and a half times; one row of another input shows."""
    g = torch.Generator().manual_seed(0)
    ref = torch.nn.functional.normalize(torch.randn(6, 5, generator=g),
                                        dim=-1)
    out = ref.repeat(3, 1)[:15].numpy().copy()
    sound = check.embedding_checks(out, ref, chunk=4)
    assert sound["worst_1mcos"] < 1e-12 and sound["mean_error"] < 1e-7
    out[7] = ref[2].numpy()
    assert check.embedding_checks(out, ref, chunk=4)["worst_1mcos"] > 1e-2
