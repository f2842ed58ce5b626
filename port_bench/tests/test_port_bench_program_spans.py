"""The readers of the program's spans and counters (``program_spans.py``)
on a synthetic snapshot: each returns its defined number, and None where
its span or counter is missing or the program has no recorder."""

import sys

import pytest

from port_bench import program_spans
from port_bench.harness import benchmark, load_file


def _path(count, device_s, counters=None):
    return {"count": count, "host_s": 1.0, "device_s": device_s,
            "self_host_s": 0.5, "self_device_s": None,
            "counters": counters or {}}


def _snapshot():
    step = "train.step"
    fwd = step + "/train.forward"
    call = "embed.call"
    return {
        "paths": {
            step: _path(4, 2.0, {"cuda_mallocs": 3}),
            fwd: _path(4, 1.0),
            fwd + "/tower.image": _path(4, 0.6),
            fwd + "/tower.text": _path(8, 0.32),
            step + "/train.backward": _path(4, 0.8),
            step + "/train.update": _path(4, 0.16),
            call: _path(1, 10.0),
            call + "/embed.loop": _path(1, 9.0, {"cuda_mallocs": 50,
                                                  "alloc_retries": 0}),
            call + "/embed.loop/embed.batch": _path(200, 8.9),
            call + "/embed.loop/embed.batch/embed.h2d": _path(
                200, 1.2, {"h2d_bytes": 200 * 346816512}),
            call + "/embed.fetch": _path(1, 0.45, {"cuda_mallocs": 2}),
        },
        "spans": [],
        "counters": {"h2d_bytes": 200 * 346816512, "cuda_mallocs": 55},
    }


SUMMARY = {"memcpy": {"HtoD": [200, 1.4]}}
COUNTS = {"window_s": 45.0, "steps": 4, "batches": 200}

EXPECT = {
    "image_tower_ms_per_step.train": 0.6 / 4 * 1e3,
    "text_tower_ms_per_step.train": 0.32 / 4 * 1e3,
    "backward_ms_per_step.train": 0.8 / 4 * 1e3,
    "update_ms_per_step.train": 0.16 / 4 * 1e3,
    "fetch_share.embed": 0.45 / 45.0 * 100.0,
    "cuda_mallocs_per_1k_batches.embed": 50 * 1000.0 / 200,
    "h2d_gb_per_s.embed": 200 * 346816512 / 1.4 / 1e9,
}

# what each reader needs: the path (or counter) whose absence gives None
NEEDS = {
    "image_tower_ms_per_step.train": ["train.step",
                                      "train.step/train.forward/tower.image"],
    "text_tower_ms_per_step.train": ["train.step",
                                     "train.step/train.forward/tower.text"],
    "backward_ms_per_step.train": ["train.step",
                                   "train.step/train.backward"],
    "update_ms_per_step.train": ["train.step", "train.step/train.update"],
    "fetch_share.embed": ["embed.call/embed.fetch"],
    "cuda_mallocs_per_1k_batches.embed": [
        "embed.call/embed.loop", "embed.call/embed.loop/embed.batch"],
    "h2d_gb_per_s.embed": ["counter:h2d_bytes"],
}


def _read(name, snap, summary=SUMMARY, counts=COUNTS, monkeypatch=None):
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    return load_file("metrics", name).read(summary, counts, {}, {})


def test_every_program_metric_has_a_case():
    ours = {m["name"] for m in benchmark()["per_layer"]
            if m["source"] in ("program_span", "program_counter")}
    assert ours == set(EXPECT) == set(NEEDS)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_returns_its_number(name, monkeypatch):
    assert _read(name, _snapshot(), monkeypatch=monkeypatch) == \
        pytest.approx(EXPECT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_none_without_its_span(name, monkeypatch):
    for need in NEEDS[name]:
        snap = _snapshot()
        if need.startswith("counter:"):
            del snap["counters"][need.split(":")[1]]
        else:
            del snap["paths"][need]
        assert _read(name, snap, monkeypatch=monkeypatch) is None, need


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_none_without_device_time_or_a_recorder(name, monkeypatch):
    """No device seconds (a run on the CPU) or no recorder at all (a
    checkout from before it): None, never an error."""
    snap = _snapshot()
    for p in snap["paths"].values():
        p["device_s"] = None
    if name.startswith("cuda_mallocs"):
        del snap["paths"]["embed.call/embed.loop"]["counters"]["cuda_mallocs"]
    if name.startswith("h2d_gb"):
        assert _read(name, snap, {"memcpy": {}},
                     monkeypatch=monkeypatch) is None
    else:
        assert _read(name, snap, monkeypatch=monkeypatch) is None
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "clip_embeds_tpu_torch.core.tracing",
                        None)
    assert program_spans.snapshot() is None
    assert load_file("metrics", name).read(SUMMARY, COUNTS, {}, {}) is None


def test_snapshot_is_the_programs(monkeypatch):
    from clip_embeds_tpu_torch.core import tracing

    tracing.reset()
    snap = program_spans.snapshot()
    assert snap["paths"] == {} and "launches.fused_block" in snap["counters"]
