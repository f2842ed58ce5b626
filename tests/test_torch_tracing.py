"""The port's recorder (``core/tracing.py``): off without a profiler (no
span, no counter, no CUDA event), and under a CPU ``torch.profiler``
session the span tree of a train step and of the embedding entry, their
sequence numbers, ``h2d_bytes``, the kernel wrappers' launch counts, the
``record_function`` ranges on the profiler's clock and self time. Marked
``cuda``: the same clock and the copy's device time against the profiler's
device rows on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_tracing.py``)."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clip_embeds_tpu_torch.cli.embed import (
    _to_device,
    embed_image_batches,
    embed_text_batches,
)
from clip_embeds_tpu_torch.core import tracing
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.ops import flash_attention as fa
from clip_embeds_tpu_torch.train import optim, schedules
from clip_embeds_tpu_torch.train.steps import TrainState, make_clip_train_step

SPAN_NAMES = {"train.step", "train.forward", "train.backward",
              "train.update", "tower.image", "tower.text", "embed.call",
              "embed.loop", "embed.batch", "embed.h2d", "embed.fetch"}


def _batch(device, b=4, hard=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = lambda n: torch.randint(1, 1000, (n, 77), generator=g)
    return {"images": torch.randn(b, 32, 32, 3, generator=g).to(device),
            "texts": ids(b).to(device), "hard_texts": ids(hard).to(device)}


def _train(steps=2, device="cpu"):
    """``steps`` hard-negative train steps of the tiny CLIP (two text
    tower calls a step: captions and hard negatives)."""
    model = create_model("test-tiny", seed=0, device=device).train()
    state = TrainState(model, optim.adamw(model, 1e-4),
                       schedules.cosine_lr(1e-4, 1, 10))
    step = make_clip_train_step(model, use_hard_text=True)
    for k in range(steps):
        step(state, _batch(device, seed=k))
    return model


def _embed_texts(model, n_batches=3, b=4):
    rng = np.random.default_rng(0)
    batches = [rng.integers(1, 1000, (b, 77)).astype(np.int32)
               for _ in range(n_batches - 1)]
    batches.append(rng.integers(1, 1000, (b - 1, 77)).astype(np.int32))
    out = embed_text_batches(model, batches, b)
    return batches, out


@pytest.fixture
def recorder():
    tracing.reset()
    yield tracing
    tracing.reset()


def _no_launch_counters(counters):
    return {k: v for k, v in counters.items()
            if not k.startswith("launches.")}


def test_off_records_nothing_and_makes_no_cuda_call(recorder, monkeypatch):
    """Without a profiler no span or counter is recorded, and no CUDA
    event or allocator reading is made, even where CUDA is in use."""
    model = _train(1)      # built before the card is pretended
    calls = []

    class Event:
        def __init__(self, *a, **k):
            calls.append("Event")

    def memory_stats(*a, **k):
        calls.append("memory_stats")
        return {}

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    assert not torch._C._autograd._profiler_enabled()
    state = TrainState(model, optim.adamw(model, 1e-4),
                       schedules.cosine_lr(1e-4, 1, 10))
    make_clip_train_step(model, use_hard_text=True)(state, _batch("cpu"))
    _embed_texts(model.eval())
    assert tracing.span("a") is tracing.span("b", seq=3, mallocs=True)
    snap = tracing.snapshot()
    assert calls == []
    assert snap["paths"] == {} and snap["spans"] == []
    assert _no_launch_counters(snap["counters"]) == {}


def test_train_step_span_tree(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        _train(2)
    snap = tracing.snapshot()
    p = snap["paths"]
    expect = {"train.step": 2, "train.step/train.forward": 2,
              "train.step/train.forward/tower.image": 2,
              "train.step/train.forward/tower.text": 4,
              "train.step/train.backward": 2,
              "train.step/train.update": 2}
    assert {k: v["count"] for k, v in p.items()} == expect
    assert all(v["device_s"] is None for v in p.values())   # no card
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["train.step"] * 2
    assert [r["seq"] for r in roots] == [0, 1]
    for s in spans:
        if s["parent"] is None:
            continue
        parent = by_id[s["parent"]]
        assert s["path"] == parent["path"] + "/" + s["name"]
        assert s["seq"] == parent["seq"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]


@pytest.mark.parametrize("kind", ["texts", "images"])
def test_embed_span_tree_and_h2d_bytes(recorder, kind):
    model = create_model("test-tiny", seed=0).eval()
    rng = np.random.default_rng(1)
    if kind == "texts":
        batches = [rng.integers(1, 1000, (4, 77)).astype(np.int32)
                   for _ in range(2)] + \
            [rng.integers(1, 1000, (3, 77)).astype(np.int32)]
        entry, tower = embed_text_batches, "tower.text"
    else:
        batches = [rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
                   for _ in range(2)] + \
            [rng.standard_normal((3, 32, 32, 3)).astype(np.float32)]
        entry, tower = embed_image_batches, "tower.image"
    with profile(activities=[ProfilerActivity.CPU]):
        out = entry(model, batches, 4)
    assert out.shape == (11, 64)
    snap = tracing.snapshot()
    b = "embed.call/embed.loop/embed.batch"
    expect = {"embed.call": 1, "embed.call/embed.loop": 1, b: 3,
              b + "/embed.h2d": 3, f"{b}/{tower}": 3,
              "embed.call/embed.fetch": 1}
    assert {k: v["count"] for k, v in snap["paths"].items()} == expect
    batch_spans = [s for s in snap["spans"] if s["name"] == "embed.batch"]
    assert [s["seq"] for s in batch_spans] == [0, 1, 2]
    assert [s["attrs"]["rows"] for s in batch_spans] == [4, 4, 3]
    # every batch is padded to the batch size before it goes to the device
    padded = sum(4 * x[0].nbytes for x in batches)
    assert snap["counters"]["h2d_bytes"] == padded
    assert snap["paths"][b + "/embed.h2d"]["counters"] == \
        {"h2d_bytes": padded}
    assert {k for k in snap["counters"] if k.startswith("launches.")} == {
        "launches.flash_attention", "launches.flash_attention_bwd",
        "launches.fused_block", "launches.fused_block_residuals",
        "launches.fused_block_int8", "launches.int8_linear"}


def test_launches_count_from_the_last_reset(recorder, monkeypatch):
    monkeypatch.setattr(fa.flash_attention, "launches",
                        fa.flash_attention.launches + 5)
    tracing.reset()
    monkeypatch.setattr(fa.flash_attention, "launches",
                        fa.flash_attention.launches + 3)
    c = tracing.snapshot()["counters"]
    assert c["launches.flash_attention"] == 3
    assert c["launches.flash_attention_bwd"] == 0


def test_record_function_ranges_on_the_profilers_clock(recorder):
    """Each span opens a ``record_function`` range of its name, which the
    profiler's events hold on the same epoch clock as the span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model = _train(1)
        _embed_texts(model.eval())
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in SPAN_NAMES:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = tracing.snapshot()["spans"]
    assert set(ranges) == {s["name"] for s in spans} == SPAN_NAMES
    slack = 1_000_000   # 1 ms: the two clocks are one epoch clock
    for s in spans:
        assert any(a - slack <= s["start_ns"] and s["end_ns"] <= b + slack
                   for a, b in ranges[s["name"]]), s


def test_self_time_is_duration_less_children(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            time.sleep(0.01)
            for _ in range(2):
                with tracing.span("inner"):
                    time.sleep(0.005)
                    with tracing.span("leaf"):
                        time.sleep(0.002)
    p = tracing.snapshot()["paths"]
    o, i, leaf = p["outer"], p["outer/inner"], p["outer/inner/leaf"]
    assert i["count"] == 2 and leaf["count"] == 2
    assert o["self_host_s"] == o["host_s"] - i["host_s"]
    assert i["self_host_s"] == i["host_s"] - leaf["host_s"]
    assert leaf["self_host_s"] == leaf["host_s"]
    assert o["self_host_s"] >= 0.01 and i["self_host_s"] >= 0.01


def test_counters_go_to_the_innermost_span(recorder):
    tracing.count("h2d_bytes", 7)       # off: not counted
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("x", 1)
        with tracing.span("a"):
            tracing.count("x", 2)
            with tracing.span("b"):
                tracing.count("x", 3)
    snap = tracing.snapshot()
    assert _no_launch_counters(snap["counters"]) == {"x": 6}
    assert snap["paths"]["a"]["counters"] == {"x": 2}
    assert snap["paths"]["a/b"]["counters"] == {"x": 3}
    tracing.reset()
    snap = tracing.snapshot()
    assert snap["paths"] == {} and \
        _no_launch_counters(snap["counters"]) == {}


def test_device_seconds_and_mallocs_from_the_events(recorder, monkeypatch):
    """Where CUDA is in use a span reads its device time from two timing
    events only when a snapshot is taken, and ``mallocs=True`` counts the
    allocator's ``cudaMalloc`` calls and retries over the span (here a
    stand-in card whose events read a step clock)."""
    clock = [0.0]
    mallocs = [10]
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None
            made.append(self)

        def record(self, stream=None):
            clock[0] += 1.0
            self.t = clock[0]

        def query(self):
            return True

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3          # ms

    def memory_stats(device=None):
        mallocs[0] += 4
        return {"num_device_alloc": mallocs[0], "num_alloc_retries": 1}

    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
        with tracing.span("outer", mallocs=True):       # events at 1, 6
            with tracing.span("inner"):                 # events at 2, 3
                pass
            with tracing.span("inner"):                 # events at 4, 5
                pass
        monkeypatch.undo()
    assert len(made) == 6
    p = tracing.snapshot()["paths"]
    assert p["outer"]["device_s"] == 5.0
    assert p["outer/inner"]["device_s"] == 2.0
    assert p["outer"]["self_device_s"] == 3.0
    # one allocator reading at entry and one at exit: 4 mallocs between
    assert p["outer"]["counters"] == {"cuda_mallocs": 4, "alloc_retries": 0}
    assert p["outer/inner"]["counters"] == {}


# ----------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spans' device time and the "
                    "profiler's device rows)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_spans_share_the_profilers_clock(recorder, cuda):
    """On the card: each ``train.update`` span's host interval holds the
    runtime calls that launched that step's AdamW (multi-tensor-apply)
    kernels, and ``embed.h2d``'s device time is the profiler's HtoD time
    within 10%."""
    _train(1, cuda)                       # warm: the kernels load
    torch.cuda.synchronize()
    tracing.reset()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _train(3, cuda)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    kernels = {e.correlation_id() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "multi_tensor_apply" in e.name()}
    launches = [e.start_ns() for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU
                and e.correlation_id() in kernels
                and e.name().startswith(("cudaLaunchKernel", "cuLaunch"))]
    assert kernels and len(launches) == len(kernels)
    snap = tracing.snapshot()
    updates = [(s["start_ns"], s["end_ns"], s["seq"])
               for s in snap["spans"] if s["name"] == "train.update"]
    assert [u[2] for u in updates] == [0, 1, 2]
    per_update = [sum(a <= t <= b for t in launches) for a, b, _ in updates]
    assert sum(per_update) == len(launches) and min(per_update) > 0
    p = snap["paths"]
    step = p["train.step"]["device_s"]
    parts = sum(p[f"train.step/train.{k}"]["device_s"]
                for k in ("forward", "backward", "update"))
    assert 0 < parts <= step

    # three 25 MB copies, each queued behind work already on the stream,
    # as in a run whose host stays ahead of the card (on an idle stream
    # the span also holds the host's submit time, ~0.1 ms a copy)
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((2048, 32, 32, 3)).astype(np.float32)
               for _ in range(3)]
    _to_device(batches[0], cuda)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=acts) as prof:
        for x in batches:
            torch.cuda._sleep(100_000_000)    # ~50 ms
            with tracing.span("embed.batch"):
                _to_device(x, cuda)
        torch.cuda.synchronize()
    htod = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "HtoD" in e.name()) * 1e-9
    snap = tracing.snapshot()
    h2d = snap["paths"]["embed.batch/embed.h2d"]
    assert h2d["count"] == 3
    assert snap["counters"]["h2d_bytes"] == sum(x.nbytes for x in batches)
    assert abs(h2d["device_s"] - htod) <= 0.1 * htod, (h2d["device_s"], htod)
