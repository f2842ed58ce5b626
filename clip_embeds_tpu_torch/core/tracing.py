"""The port's spans and counters: what the program was doing, by phase, on
the clock a torch profiler's events use.

The recorder is on exactly while a torch profiler session is active (any
``torch.profiler.profile`` or ``torch.autograd.profiler.profile``, such as
``cli/profile.py --trace``); there is no other switch. Off, :func:`span`
costs one check and returns a shared no-op context, and :func:`count` does
nothing: no allocation, no event, no CUDA call.

On, a span records its name, host start and end from ``time.time_ns()``
(the epoch clock the profiler stamps its events with, so a span joins the
device rows of the same session), its parent from a per-thread stack, and a
sequence number (a step or batch index: the span's own ``seq``, else its
parent's). Where CUDA is initialised it also records two timing events on
the current stream, read only by :func:`snapshot` (after the caller's
synchronize), so the hot path never waits for the device. Each span opens a
``torch.profiler.record_function`` range of its name, so a Chrome trace
shows the spans above the kernels they launched. A span opened with
``mallocs=True`` counts the ``cudaMalloc`` calls and allocation retries the
caching allocator made while it was open (``cuda_mallocs``,
``alloc_retries``).

The spans, by path from the root:

- ``train.step`` (``seq``: the update count) > ``train.forward``,
  ``train.backward``, ``train.update`` (``train/steps.py``; the update is
  ``TrainState.apply_gradients``);
- ``tower.image``, ``tower.text``: one tower's forward (``models/clip.py``,
  and the fused fp and int8 routes of ``models/serving.py``);
- ``embed.call`` > ``embed.loop`` > ``embed.batch`` (``seq``: the batch) >
  ``embed.h2d``, and ``embed.call`` > ``embed.fetch`` (``cli/embed.py``).

Counters: ``h2d_bytes`` (each batch's bytes handed to the device by
``cli/embed.py``), ``cuda_mallocs`` and ``alloc_retries`` (on
``embed.loop``, ``embed.fetch`` and ``train.step``), and in a snapshot the
kernel wrappers' own ``.launches`` counters as ``launches.<op>``.

A span opened on another thread (the autograd engine's, say) starts a root
of its own there.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The context :func:`span` returns while no profiler runs."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _launches() -> Dict[str, int]:
    """The kernel wrappers' own always-on launch counters."""
    from ..ops import flash_attention as fa
    from ..ops import fused_block as fb

    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "fused_block": fb.fused_block.launches,
            "fused_block_residuals": fb.fused_block_residuals.launches,
            "fused_block_int8": fb.fused_block_int8.launches,
            "int8_linear": fb.int8_linear.launches}


def _malloc_stats() -> Optional[Dict[str, int]]:
    """The caching allocator's ``cudaMalloc`` calls and retries so far on
    the current card, or None where CUDA is not in use (or this PyTorch
    does not count them)."""
    if not torch.cuda.is_initialized():
        return None
    s = torch.cuda.memory_stats()
    if "num_device_alloc" not in s:
        return None
    return {"cuda_mallocs": s["num_device_alloc"],
            "alloc_retries": s.get("num_alloc_retries", 0)}


class _Span:
    __slots__ = ("name", "attrs", "mallocs", "id", "parent", "path", "seq",
                 "start_ns", "end_ns", "counters", "_events", "_device_s",
                 "_range", "_mem")

    def __init__(self, name: str, seq: Optional[int], mallocs: bool,
                 attrs: Dict[str, Any]):
        self.name, self.seq, self.mallocs, self.attrs = (name, seq, mallocs,
                                                         attrs)
        self.counters: Dict[str, int] = {}
        self._events = None
        self._device_s: Optional[float] = None

    def __enter__(self) -> "_Span":
        stack = _RECORDER.stack()
        parent = stack[-1] if stack else None
        self.id = next(_RECORDER.ids)
        self.parent = parent.id if parent else None
        self.path = f"{parent.path}/{self.name}" if parent else self.name
        if self.seq is None and parent is not None:
            self.seq = parent.seq
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._mem = _malloc_stats() if self.mallocs else None
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, None)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events = (self._events[0], end)
        if self._mem is not None:
            now = _malloc_stats()
            for k, v in now.items():
                self.counters[k] = self.counters.get(k, 0) + v - self._mem[k]
                _RECORDER.add(k, v - self._mem[k])
        _RECORDER.stack().pop()
        self._range.__exit__(*exc)
        _RECORDER.finished.append(self)
        return False

    def device_s(self) -> Optional[float]:
        """Seconds between the span's two events on the device (None
        without them); the events are dropped once read."""
        if self._events is not None:
            start, end = self._events
            if not end.query():
                torch.cuda.synchronize()
            self._device_s = start.elapsed_time(end) * 1e-3
            self._events = None
        return self._device_s


class _Recorder:
    """The process's spans and counters (the profiler is process-wide
    too)."""

    def __init__(self):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.finished: List[_Span] = []
        self.counters: Dict[str, int] = {}
        self.launches0: Optional[Dict[str, int]] = None

    def stack(self) -> List[_Span]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n


_RECORDER = _Recorder()


def span(name: str, seq: Optional[int] = None, mallocs: bool = False,
         **attrs: Any):
    """A context that records the phase ``name`` while a profiler runs
    (else a shared no-op). ``seq``: its sequence number (children inherit
    it); ``mallocs``: count the allocator's ``cudaMalloc`` calls and
    retries inside it; ``attrs``: kept with the span."""
    if not _enabled():
        return _OFF
    return _Span(name, seq, mallocs, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``, and to the innermost open span's,
    while a profiler runs."""
    if not _enabled():
        return
    _RECORDER.add(name, n)
    stack = _RECORDER.stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n


def reset() -> None:
    """Forget the recorded spans and counters; the launch counts of later
    snapshots start from here."""
    with _RECORDER.lock:
        _RECORDER.finished = []
        _RECORDER.counters = {}
        _RECORDER.launches0 = _launches()


def snapshot() -> Dict[str, Any]:
    """What was recorded since the last :func:`reset` (or the start).
    Synchronises the device if a span's last event has not completed.

    - ``paths``: for each span path (names from the root down,
      ``train.step/train.forward/tower.image``): ``count``, ``host_s``,
      ``device_s`` (None where no span of the path has events),
      ``self_host_s`` and ``self_device_s`` (the duration less what the
      direct child spans cover), and ``counters`` counted inside it;
    - ``spans``: each finished span, in the order opened: ``id``, ``name``,
      ``path``, ``parent`` (an ``id``), ``seq``, ``start_ns``, ``end_ns``
      (``time.time_ns()``), ``device_s``, ``attrs``;
    - ``counters``: every counter, with ``launches.<op>`` for the kernel
      wrappers' launches since the last reset."""
    spans = sorted(_RECORDER.finished, key=lambda s: s.id)
    paths: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        p = paths.setdefault(s.path, {"count": 0, "host_s": 0.0,
                                      "device_s": None, "counters": {}})
        p["count"] += 1
        p["host_s"] += (s.end_ns - s.start_ns) * 1e-9
        dev = s.device_s()
        if dev is not None:
            p["device_s"] = (p["device_s"] or 0.0) + dev
        for k, v in s.counters.items():
            p["counters"][k] = p["counters"].get(k, 0) + v
    for path, p in paths.items():
        kids = [q for k, q in paths.items()
                if k.rpartition("/")[0] == path]
        p["self_host_s"] = p["host_s"] - sum(q["host_s"] for q in kids)
        p["self_device_s"] = (
            None if p["device_s"] is None else
            p["device_s"] - sum(q["device_s"] or 0.0 for q in kids))
    counters = dict(_RECORDER.counters)
    base = _RECORDER.launches0 or {}
    for k, v in _launches().items():
        counters[f"launches.{k}"] = v - base.get(k, 0)
    return {
        "paths": paths,
        "spans": [{"id": s.id, "name": s.name, "path": s.path,
                   "parent": s.parent, "seq": s.seq, "start_ns": s.start_ns,
                   "end_ns": s.end_ns, "device_s": s.device_s(),
                   "attrs": s.attrs} for s in spans],
        "counters": counters,
    }
