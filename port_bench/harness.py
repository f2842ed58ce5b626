"""One run of one cell: find its pieces by name, hand the driver a
:class:`Bench`, read the per-layer metrics, judge ``correct`` and build the
result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the traffic's ``kind`` names
its driver (``drivers/<kind>.py``), each per-layer metric its reader
(``metrics/<name>.py``) and the cell its limits (``limits/<cell>.json``).
Adding a cell, a mix, a kind or a metric adds files; none is edited.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "clip_embeds_tpu")


def read_json(*parts: str) -> Dict:
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark (names may hold
    dots, so it is loaded by path)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``clip_embeds_tpu_torch`` is not ``clip_embeds_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Bench:
    """What a driver gets: the cell's configuration, traffic and limits,
    the run's arguments, the device and the clock the set-up started on."""

    def __init__(self, cell: str, config: Dict, traffic: Dict, limits: Dict,
                 seed: int, seconds: float, trace: bool,
                 device: torch.device, t0: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits, self.seed, self.seconds = limits, seed, seconds
        self.trace, self.device, self.t0 = trace, device, t0
        self.on_card = device.type == "cuda"
        self.summary: Optional[Dict] = None
        self.marks: List[list] = []

    def mark(self, phase: str) -> None:
        """Seconds since the process started, at the end of a set-up
        phase (printed on an earlier line)."""
        self.marks.append([phase, now() - self.t0])

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return (int(torch.cuda.max_memory_allocated(self.device))
                if self.on_card else 0)

    def free(self) -> None:
        """Return the freed program state's memory before the reference
        runs."""
        import gc

        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def window(self):
        """The measured window; in a traced run under the profiler, whose
        summary (``trace.py``) lands in ``self.summary`` when the window
        closes. The profiler records the device's activity and the CUDA
        runtime calls, not every host operator."""
        from torch.autograd.profiler import profile

        from .trace import summarize

        if not self.trace:
            yield
            return
        prof = profile(use_kineto=True, use_cpu=not self.on_card,
                       record_shapes=False,
                       use_device="cuda" if self.on_card else None)
        prof.__enter__()
        try:
            w0 = time.time_ns()
            yield
            self.sync()
            w1 = time.time_ns()
        finally:
            t0 = now()
            prof.__exit__(None, None, None)
            t1 = now()
        self.summary = summarize(prof.kineto_results, (w0, w1))
        self.marks.append(["trace_stop_s", t1 - t0])
        self.marks.append(["trace_summary_s", now() - t1])


def judge(checks: Dict[str, List[float]]) -> bool:
    """Every compared number within its limit (and a number at all)."""
    return all(v == v and v <= lim for v, lim in checks.values())


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float,
             config: Optional[Dict] = None,
             traffic: Optional[Dict] = None,
             info: Optional[Dict] = None) -> Dict[str, Any]:
    """Run ``cell`` once and return its result line as a dict.
    ``config`` / ``traffic`` replace the cell's files (the tests' tiny
    sizes on the CPU); ``info`` receives the set-up phases and the
    driver's counts."""
    bench = benchmark()
    spec = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if spec is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    config = config or read_json("configs", spec["config"] + ".json")
    traffic = traffic or read_json("traffic", spec["traffic"] + ".json")
    limits = read_json("limits", cell + ".json")["limits"]
    b = Bench(cell, config, traffic, limits, seed, seconds, trace, device, t0)
    driver = load_file("drivers", traffic["kind"])
    out = driver.run(b)
    if info is not None:
        info.update(setup_phases=b.marks, counts=out["counts"],
                    readings=out["checks"])

    def mine(m: Dict) -> bool:
        return "workloads" not in m or cell in m["workloads"]

    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in filter(mine, bench["end_to_end"]):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in filter(mine, bench["per_layer"]):
            value = load_file("metrics", m["name"]).read(
                b.summary, out["counts"], config, traffic) \
                if b.summary is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the numbers with a limit are compared; the others go on the earlier
    # line
    checks = {k: [float(v), float(b.limits[k])]
              for k, v in out["checks"].items() if k in b.limits}
    missing = set(b.limits) - set(out["checks"])
    if missing:
        raise RuntimeError(f"{cell}: no reading of {sorted(missing)}")
    device_info = {
        "platform": "gpu" if b.on_card else "cpu",
        "kind": (torch.cuda.get_device_name(device) if b.on_card
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    result: Dict[str, Any] = {
        "correct": judge(checks) and out["failed"] == 0,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": device_info,
    }
    if trace and b.summary is not None:
        device_info["busy_s"] = b.summary["busy_s"]
        device_info["window_s"] = b.summary["window_s"]
        result["breakdown"] = b.summary["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def report(result: Dict[str, Any], extra: Dict[str, Any]) -> None:
    """Print ``extra`` on an earlier line, each compared number beside its
    limit as the last lines on stderr, and the result as the last line of
    stdout."""
    print(json.dumps(extra), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def now() -> float:
    return time.perf_counter()
