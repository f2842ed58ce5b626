"""The rest of the CLIP training loop against the JAX package (fp32, CPU,
test-tiny): the distillation step, the metrics logger, the remote mirror,
asynchronous checkpoints, and one training CLI run in each package with
validation, ImageNet zero-shot, results.jsonl, async saves and the mirror;
and the JAX CLI's zero-shot key fault beside the port's run."""

import io
import json
import logging
import os
import sys
import tarfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli import train as jax_train
from clip_embeds_tpu.cli.train import main as jax_main
from clip_embeds_tpu.core import logging_utils as jax_logging
from clip_embeds_tpu.core import remote_sync as jax_remote_sync
from clip_embeds_tpu.core.config import get_model_config as jax_config
from clip_embeds_tpu.core.torch_convert import convert_clip_state_dict
from clip_embeds_tpu.evals import zero_shot as jax_zs
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu.train import optim as jax_optim
from clip_embeds_tpu.train import steps as jax_steps
from clip_embeds_tpu_torch.cli import train as port_train
from clip_embeds_tpu_torch.core import checkpoint as ckpt
from clip_embeds_tpu_torch.core import logging_utils, remote_sync
from clip_embeds_tpu_torch.core.config import get_model_config
from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.data.synthetic import synthetic_batches
from clip_embeds_tpu_torch.evals import zero_shot
from clip_embeds_tpu_torch.models.clip import CLIP
from clip_embeds_tpu_torch.train import optim, schedules
from clip_embeds_tpu_torch.train.steps import (
    TrainState, make_distill_train_step)


def _random_sd(seed, std=0.05):
    """A test-tiny open_clip state dict, every entry random (LN gains near
    1, the logit scale at ln(1 / 0.07))."""
    model = CLIP(get_model_config("test-tiny"))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = std * rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith("weight") and ".ln" in "." + k and v.ndim == 1:
            a += 1.0
        sd[k] = torch.from_numpy(np.asarray(a, np.float32))
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


def _tiny(sd):
    model = create_model("test-tiny", train=True)
    model.load_state_dict(sd)
    return model


def test_distill_step_matches_jax():
    """One AdamW step (lr 1e-3, wd 0.1) of a random student against a
    teacher from another seed: the losses and every updated parameter as
    JAX's make_distill_train_step gives them, within 1e-5 in fp32; the
    teacher untouched and without gradients."""
    sd, tsd = _random_sd(2), _random_sd(9)
    model, teacher = _tiny(sd), _tiny(tsd).requires_grad_(False)
    state = TrainState(model, optim.adamw(model, 1e-3, weight_decay=0.1),
                       schedules.const_lr(1e-3))
    batch = next(synthetic_batches(8, 32, 77, seed=1))
    metrics = make_distill_train_step(model, teacher)(state, {
        k: torch.from_numpy(v).long() if v.dtype == np.int32
        else torch.from_numpy(v) for k, v in batch.items()})

    jmodel = JaxCLIP(jax_config("test-tiny"))
    jstate = jax_steps.TrainState.create(
        jax.tree.map(jnp.asarray, convert_clip_state_dict(sd)),
        jax_optim.adamw(1e-3, weight_decay=0.1))
    jstep = jax.jit(jax_steps.make_distill_train_step(jmodel, jmodel))
    jstate, jm = jstep(jstate, jax.tree.map(
        jnp.asarray, convert_clip_state_dict(tsd)),
        jax.tree.map(jnp.asarray, batch))
    for k in ("loss", "contrastive_loss", "distill_loss", "i2t_acc",
              "logit_scale"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), abs=1e-5), k
    assert float(metrics["distill_loss"]) > 0
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        assert not torch.equal(v, sd[k]), k
    for k, p in teacher.named_parameters():
        assert p.grad is None and torch.equal(p, tsd[k]), k


def test_metrics_logger_writes_jax_lines(tmp_path, caplog, monkeypatch):
    # wandb may not import, whatever is installed: no run reaches a server
    monkeypatch.setitem(sys.modules, "wandb", None)
    evals = [({"image_to_text_R@1": np.float32(0.25), "num_samples": 16,
               "clip_val_loss": 3.0503159761428833}, 1),
             ({"imagenet-zeroshot-val-top1": 0.5}, 2)]
    with caplog.at_level(logging.WARNING):
        for mod, d in ((logging_utils, "port"), (jax_logging, "jax")):
            log = mod.MetricsLogger(log_dir=str(tmp_path / d),
                                    report_to=["jsonl", "wandb"])
            for metrics, epoch in evals:
                log.log_eval(metrics, epoch)
            log.log({"loss": 1.5}, step=3)
    lines = [(tmp_path / d / "results.jsonl").read_text()
             for d in ("port", "jax")]
    assert lines[0] == lines[1]
    assert [json.loads(x)["epoch"] for x in lines[0].splitlines()] == [1, 2]
    # the sink that does not import, skipped with JAX's warning, twice
    assert caplog.text.count("wandb unavailable; skipping") == 2


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_remote_sync_mirrors_skips_tmp_and_syncs_at_stop(tmp_path):
    src, dst = tmp_path / "ckpt", tmp_path / "mirror"
    (src / "sub").mkdir(parents=True)
    (src / "epoch_1.pt").write_bytes(b"one")
    (src / "sub" / "results.jsonl").write_text("{}\n")
    # a save in flight: checkpoint.save writes .tmp_* and renames it whole
    (src / ".tmp_abc.pt").write_bytes(b"half")
    assert remote_sync.sync_once(str(src), str(dst))
    assert _tree(dst) == {"epoch_1.pt": b"one", "sub/results.jsonl": b"{}\n"}
    # JAX's pass publishes the half-written file (it skips orbax's dirs)
    assert jax_remote_sync.sync_once(str(src), str(tmp_path / "jax"))
    assert ".tmp_abc.pt" in _tree(tmp_path / "jax")

    # a newer file is copied again; the thread's passes, then the last one
    (src / "epoch_1.pt").write_bytes(b"uno")
    os.utime(src / "epoch_1.pt", (time.time() + 5,) * 2)
    syncer = remote_sync.RemoteSync(str(src), str(dst), every_seconds=0.02)
    syncer.start()
    deadline = time.time() + 10
    while _tree(dst).get("epoch_1.pt") != b"uno" and time.time() < deadline:
        time.sleep(0.02)
    assert _tree(dst)["epoch_1.pt"] == b"uno"
    syncer.stop()
    # the final pass alone: no periodic pass runs within the test
    (src / "epoch_2.pt").write_bytes(b"two")
    syncer = remote_sync.RemoteSync(str(src), str(dst), every_seconds=3600)
    syncer.start()
    syncer.stop(final_sync=True)
    assert _tree(dst) == {"epoch_1.pt": b"uno", "epoch_2.pt": b"two",
                          "sub/results.jsonl": b"{}\n"}
    assert not syncer._thread.is_alive()


def test_async_save_gives_the_blocking_file(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    a = ckpt.save(str(tmp_path / "a"), {"state_dict": sd, "step": 2}, 2)
    b = ckpt.save(str(tmp_path / "b"), {"state_dict": sd, "step": 2}, 2,
                  blocking=False)
    ckpt.wait_for_saves()
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_async_save_snapshots_before_it_returns(tmp_path):
    """An in-place update right after save returns (AdamW's) does not
    reach the file."""
    w = torch.zeros(1 << 20)
    path = ckpt.save(str(tmp_path), {"state_dict": {"w": w}, "step": 1}, 1,
                     blocking=False)
    w.add_(1.0)
    ckpt.wait_for_saves()
    assert torch.equal(ckpt.load(path)["state_dict"]["w"],
                       torch.zeros(1 << 20))


def test_async_saves_stay_in_order_and_raise(tmp_path, monkeypatch):
    """Each save starts after the previous async one committed; an error
    of the writer is raised by wait_for_saves, or by the next save, and
    leaves no file."""
    spans, real = [], ckpt._write

    def slow(*args):
        t0 = time.perf_counter()
        time.sleep(0.2)
        real(*args)
        spans.append((t0, time.perf_counter(), threading.current_thread()))

    monkeypatch.setattr(ckpt, "_write", slow)
    state = {"state_dict": {"w": torch.ones(3)}, "step": 1}
    for step in (1, 2):
        ckpt.save(str(tmp_path), dict(state, step=step), step, blocking=False)
    ckpt.save(str(tmp_path), dict(state, step=3), 3)  # blocking: flushes
    assert [s[0] >= p[1] for p, s in zip(spans, spans[1:])] == [True, True]
    assert spans[2][2] is threading.current_thread()
    assert sorted(os.listdir(tmp_path)) == [f"epoch_{i}.pt" for i in (1, 2, 3)]

    monkeypatch.setattr(ckpt, "_write", real)
    bad = {"state_dict": {"w": torch.ones(3)}, "step": lambda: 4}
    d = tmp_path / "bad"
    ckpt.save(str(d), bad, 4, blocking=False)
    with pytest.raises(Exception, match="pickle|lambda"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # raised once
    ckpt.save(str(d), bad, 5, blocking=False)
    with pytest.raises(Exception, match="pickle|lambda"):
        ckpt.save(str(d), state, 6)
    assert os.listdir(d) == []


def test_teacher_of_other_geometry_exits_naming_both():
    with pytest.raises(SystemExit, match="ViT-B-32.*test-tiny"):
        port_train.main(["--model", "test-tiny", "--device", "cpu",
                         "--distill-model", "ViT-B-32",
                         "--distill-pretrained", "openai"])


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """A TSV of 20 pairs (40-56 px JPEGs), an ImageFolder of 2 classes x 2
    JPEGs, and a random test-tiny checkpoint."""
    root = tmp_path_factory.mktemp("loop")
    rng = np.random.default_rng(5)
    rows = ["filepath\ttitle"]
    for i in range(20):
        path = root / "img" / f"{i:03d}.jpg"
        path.parent.mkdir(exist_ok=True)
        h, w = (int(x) for x in rng.integers(40, 57, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(path)
        rows.append(f"{path}\ta photo of thing {i % 7}")
    (root / "data.tsv").write_text("\n".join(rows) + "\n")
    for c in range(2):
        for j in range(2):
            path = root / "inet" / f"n{c:08d}" / f"{j}.jpg"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (40, 40, 3),
                                         np.uint8)).save(path)
    # the first 13 pairs as a tar shard, one member undecodable
    with tarfile.open(root / "val-000.tar", "w") as tf:
        for i, row in enumerate(rows[1:14]):
            path, caption = row.split("\t")
            with open(path, "rb") as fh:
                blob = b"undecodable" if i == 4 else fh.read()
            for ext, data in (("jpg", blob), ("txt", caption.encode())):
                info = tarfile.TarInfo(f"{i:04d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    torch.save(_random_sd(11), root / "tiny.pt")
    return root


@pytest.mark.parametrize("val", ["data.tsv", "val-000.tar"])
def test_val_batches_equal_jax(fixtures, val):
    """The held-out batches, in order with a short last batch, bit-equal
    to the JAX CLI's (TSV: 20 pairs in 8 + 8 + 4; tar: 12 decodable in 8
    + 4)."""
    argv = ["--model", "test-tiny", "--batch-size", "8", "--val-data",
            str(fixtures / val)]
    got = list(port_train.build_val_batches(
        port_train.parse_args(argv), get_model_config("test-tiny")))
    want = list(jax_train.build_val_batches(
        jax_train.parse_args(argv), jax_config("test-tiny")))
    assert [len(b["images"]) for b in got] == (
        [8, 8, 4] if val.endswith("tsv") else [8, 4])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _argv(root, out):
    return ["--model", "test-tiny", "--pretrained", str(root / "tiny.pt"),
            "--precision", "fp32", "--batch-size", "8", "--lr", "1e-3",
            "--warmup", "1", "--log-every", "1", "--dataset-type", "csv",
            "--train-data", str(root / "data.tsv"), "--epochs", "2",
            "--val-data", str(root / "data.tsv"), "--val-num-samples", "12",
            "--imagenet-val", str(root / "inet"),
            "--report-to", "jsonl", "--logs", str(out / "logs"),
            "--name", "run", "--checkpoint-dir", str(out / "ckpt"),
            "--async-checkpoints", "--delete-previous-checkpoint",
            "--remote-sync", str(out / "mirror"),
            "--remote-sync-frequency", "1"]


# the metadata under both key sets: the JAX CLI reads 'classnames' and
# 'templates', the port the shipped file's names
_META = {"classnames": ["cat", "dog"], "IMAGENET_CLASSNAMES": ["cat", "dog"],
         "templates": ["a photo of a {c}.", "art of the {c}."],
         "OPENAI_IMAGENET_TEMPLATES": ["a photo of a {c}.",
                                      "art of the {c}."]}


def _results(out):
    with open(out / "logs" / "run" / "results.jsonl") as fh:
        return [json.loads(line) for line in fh]


def test_cli_evals_match_jax(fixtures, tmp_path, monkeypatch):
    """Two epochs in each CLI: validation after each (12 of the 20 pairs:
    the batch that reaches 12 is the last, 16 pairs), zero-shot after the
    second (--zeroshot-frequency 2), the results.jsonl lines equal within
    1e-4; the port's async checkpoints pruned to the last and mirrored
    byte-equal, no .tmp_* file."""
    for mod in (zero_shot, jax_zs):
        monkeypatch.setattr(mod, "load_imagenet_metadata", lambda: _META)
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    state = port_train.main(_argv(fixtures, port_out) + ["--device", "cpu"])
    jstate = jax_main(_argv(fixtures, jax_out))
    assert state.step == int(jstate.step) == 4
    got, want = _results(port_out), _results(jax_out)
    assert [sorted(x) for x in got] == [sorted(x) for x in want]
    assert [x["epoch"] for x in got] == [1, 2, 2]
    assert got[0]["num_samples"] == 16.0
    assert "imagenet-zeroshot-val-top1" in got[2]
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=1e-4), k
    assert os.listdir(port_out / "ckpt") == ["epoch_2.pt"]
    mirror = _tree(port_out / "mirror")
    assert mirror["epoch_2.pt"] == _tree(port_out / "ckpt")["epoch_2.pt"]
    assert not [n for n in mirror if ".tmp_" in n]
    saved = ckpt.load(str(port_out / "ckpt" / "epoch_2.pt"))
    assert saved["step"] == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["state_dict"][k], v), k


def test_jax_zero_shot_key_fault_beside_the_port(fixtures, tmp_path,
                                                 monkeypatch):
    """On the shipped metadata the JAX CLI raises KeyError('classnames')
    at the zero-shot pass after the epoch; the port reads the shipped keys
    (here the file cut to its first 2 classes and 2 templates, same
    names). The epoch has no step (20 pairs at batch 32), so neither CLI
    compiles or runs a train step to get there."""
    argv = ["--model", "test-tiny", "--pretrained",
            str(fixtures / "tiny.pt"), "--precision", "fp32",
            "--batch-size", "32", "--dataset-type", "csv", "--train-data",
            str(fixtures / "data.tsv"), "--imagenet-val",
            str(fixtures / "inet"), "--report-to", "jsonl", "--name", "run"]
    with pytest.raises(KeyError, match="classnames"):
        jax_main(argv + ["--logs", str(tmp_path / "jax" / "logs")])
    shipped = zero_shot.load_imagenet_metadata()
    monkeypatch.setattr(zero_shot, "load_imagenet_metadata",
                        lambda: {k: v[:2] for k, v in shipped.items()})
    state = port_train.main(argv + ["--logs", str(tmp_path / "port" /
                                             "logs"), "--device", "cpu"])
    assert state.step == 0
    (line,) = _results(tmp_path / "port")
    assert line["epoch"] == 1 and 0 <= line[
        "imagenet-zeroshot-val-top1"] <= line["imagenet-zeroshot-val-top5"]
