"""The program's own spans and counters (``clip_embeds_tpu_torch/core/
tracing.py``), for the readers whose ``source`` is ``program_span`` or
``program_counter``. The program records them while a torch profiler runs,
which in a traced run is the window alone; they are read once the window
has closed and been synchronised. Where the program has no recorder (a
checkout from before it), every function here returns None, and so do the
readers."""

from __future__ import annotations

from typing import Dict, Optional


def snapshot() -> Optional[Dict]:
    """The recorder's snapshot, or None without a recorder."""
    try:
        from clip_embeds_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def path(snap: Optional[Dict], name: str) -> Optional[Dict]:
    """The statistics of the span path ``name``, or None."""
    return None if snap is None else snap["paths"].get(name)


def device_s(snap: Optional[Dict], name: str) -> Optional[float]:
    """Device seconds of every span of path ``name``, or None."""
    p = path(snap, name)
    return None if p is None else p["device_s"]


def ms_per_step(name: str) -> Optional[float]:
    """Device ms of the train-step phase at path ``name``, over the
    ``train.step`` spans."""
    snap = snapshot()
    steps, sec = path(snap, "train.step"), device_s(snap, name)
    if steps is None or sec is None:
        return None
    return sec / steps["count"] * 1e3
