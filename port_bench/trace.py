"""The traced run's reading of the profiler: the device's activity over the
measured window, reduced in memory to a summary that the per-layer metrics
read. Only device activity (kernels, copies, sets) and the CUDA runtime
calls that launched it are recorded, not every host operator: at a text
cell's hundreds of thousands of launches a full host trace takes minutes
to collect. No trace file is written.

The summary holds, over the window (host clock, nanoseconds since the
epoch, which the profiler's timestamps share): ``window_s``; ``busy_s``,
the union of the device's kernel, copy and set intervals; ``kernels``,
name -> [count, device seconds]; ``memcpy``, kind ('HtoD', 'DtoH', 'DtoD',
'Memset') -> [count, device seconds]; and the ``breakdown``: the ten
device operations that took most time and the ten longest idle gaps of
the device, each named by the CUDA runtime call the host was in at its
middle ('host' where it was in none: Python or the framework).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

_MEMCPY = re.compile(r"Memcpy (\w+)")


def _kind(e, device_cls) -> str:
    """'runtime' (a CUDA runtime or driver call), 'kernel', 'memcpy',
    'memset', or '' (anything else), from the event's ``activity_type``
    where PyTorch has it, else from its device and name."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return {"cuda_runtime": "runtime", "cuda_driver": "runtime",
                "kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}.get(str(at()), "")
    name = e.name()
    if e.device_type() == device_cls.CUDA:
        if getattr(e, "is_user_annotation", lambda: False)():
            return ""
        if name.startswith("Memcpy"):
            return "memcpy"
        if name.startswith("Memset"):
            return "memset"
        return "kernel"
    if name.startswith(("cuda", "cuLaunch", "cuMemcpy", "cuMemset")):
        return "runtime"
    return ""


def summarize(results, window: Tuple[int, int]) -> Dict:
    """The summary of a finished profile's kineto results over
    ``window`` = (start, end) in nanoseconds since the epoch."""
    from torch.autograd import DeviceType

    w0, w1 = window
    kernels: Dict[str, List[float]] = {}
    memcpy: Dict[str, List[float]] = {}
    iv: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for e in results.events():
        kind = _kind(e, DeviceType)
        if not kind:
            continue
        s = e.start_ns()
        t = s + e.duration_ns()
        if kind == "runtime":
            host.append((s, t, e.name()))
            continue
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        iv.append((s, t))
        name = e.name()
        if kind == "memcpy":
            m = _MEMCPY.match(name)
            c = memcpy.setdefault(m.group(1) if m else name, [0, 0.0])
        elif kind == "memset":
            c = memcpy.setdefault("Memset", [0, 0.0])
        else:
            c = kernels.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (t - s) * 1e-9
    busy, gaps = _union(iv, w0, w1)
    ops = [(n, c[1]) for n, c in kernels.items()]
    ops += [(f"Memcpy {k}", c[1]) for k, c in memcpy.items()]
    ops = sorted(ops, key=lambda x: -x[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy,
        "kernels": kernels,
        "memcpy": memcpy,
        "breakdown": {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": _name_gaps(gaps, host),
        },
    }


def _union(iv: List[Tuple[int, int]], w0: int, w1: int):
    """(busy seconds, [(gap start, gap end)]) of the intervals over
    [w0, w1]."""
    if not iv:
        return 0.0, [(w0, w1)]
    a = np.array(sorted(iv), dtype=np.int64)
    ends = np.maximum.accumulate(a[:, 1])
    new = np.empty(len(a), dtype=bool)
    new[0] = True
    new[1:] = a[1:, 0] > ends[:-1]
    starts = a[new, 0]
    # the end of each merged run is the running max just before the next
    idx = np.flatnonzero(new)
    run_ends = np.append(ends[idx[1:] - 1], ends[-1])
    busy = float((run_ends - starts).sum()) * 1e-9
    gaps = [(w0, int(starts[0]))] + list(zip(run_ends[:-1].tolist(),
                                             starts[1:].tolist()))
    gaps.append((int(run_ends[-1]), w1))
    return busy, [(s, t) for s, t in gaps if t > s]


def _name_gaps(gaps, host, n: int = 10) -> List[list]:
    """The ``n`` longest gaps, each [the runtime call the host was in at
    its middle, or 'host', seconds]."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    out = []
    for s, t in longest:
        mid = (s + t) // 2
        inside = np.flatnonzero((hs <= mid) & (he >= mid)) if len(host) \
            else []
        name = (host[inside[np.argmin(he[inside] - hs[inside])]][2]
                if len(inside) else "host")
        out.append([name, (t - s) * 1e-9])
    return out
