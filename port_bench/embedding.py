"""What the two embedding drivers share: one call of ``cli/embed.py``'s
entry over a pool of batches staged on the host, cycled until the deadline
(the window runs from the first batch offered to the call's return, which
ends with the program's single fetch of every embedding), and the check of
every returned row against the fp32 reference's embedding of the pool row
it came from; and the controls, judged the same way.

A driver gives its entry (``embed_image_batches`` / ``embed_text_batches``),
its route, ``pool_of(bench)`` (the host batches) and ``reference(bench,
pool, mm)`` (the reference's rows of the whole pool, in pool order, on the
device, every product through ``mm``)."""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from port_bench import check
from port_bench.harness import Bench, now
from port_bench.port import build_clip
from port_bench.reference.precision import MATMULS
from port_bench.weights import make_weights


def offer(pool: List[np.ndarray], deadline: float, counts: Dict):
    """Cycle ``pool`` until ``deadline`` (at least one batch)."""
    i = 0
    while i == 0 or now() < deadline:
        counts["batches"] += 1
        counts["items"] += len(pool[i % len(pool)])
        yield pool[i % len(pool)]
        i += 1


def run(bench: Bench, entry: Callable, route_of: Callable,
        pool_of: Callable, reference: Callable) -> Dict:
    """One run of an embedding cell: set-up (the model on the seeded
    weights, the route, the pool, the warm-up calls), the window, then the
    check of every returned row."""
    t, cfg = bench.traffic, bench.config
    dtype = getattr(torch, t["dtype"])
    bench.mark("imports")
    model = build_clip(cfg, make_weights(cfg, bench.seed, bench.device,
                                         dtype), bench.device, dtype)
    bench.mark("weights_and_model")
    route = route_of(model)
    if bench.on_card and route != t["route"]:
        raise RuntimeError(f"route {route!r}, the cell asks for "
                           f"{t['route']!r}")
    pool = pool_of(bench)
    bench.mark("pool")
    b = t["batch"]
    for _ in range(t["warmup_calls"]):
        entry(model, pool[:2], b)
    bench.sync()
    bench.mark("warmup")
    setup_s = now() - bench.t0
    counts = {"batches": 0, "items": 0}
    bench.reset_peak()
    with bench.window():
        t_start = now()
        out = entry(model, offer(pool, t_start + bench.seconds, counts), b)
        t_end = now()
    window_s = t_end - t_start
    peak = bench.peak_bytes()
    del model
    bench.free()
    returned = int(out.shape[0])
    counts.update(window_s=window_s, returned=returned)
    return {
        "metrics": {"setup_s": setup_s,
                    "embed_items_per_s": returned / window_s},
        "counts": counts,
        "checks": check.embedding_checks(out, reference(bench, pool)),
        "attempted": counts["items"],
        "failed": counts["items"] - returned,
        "memory_peak_bytes": peak,
    }


def control(bench: Bench, kind: str, entry: Callable, pool_of: Callable,
            reference: Callable) -> Dict:
    """A control over the whole pool at the cell's batch, judged as a run
    is. 'int8': the port's own lower precision, ``--int8`` (W8A8,
    quantised from the same weights held in fp32, bf16 compute, activation
    scales calibrated on the first batch); 'fp8': the reference in the
    port's place with its products in float8 (``reference/precision.py``)."""
    pool = pool_of(bench)
    if kind == "fp8":
        low = reference(bench, pool, MATMULS["fp8"]).float().cpu().numpy()
        return check.embedding_checks(low, reference(bench, pool))
    if kind != "int8":
        raise ValueError(f"no control {kind!r}")
    t, cfg = bench.traffic, bench.config
    dtype = getattr(torch, t["dtype"])
    model = build_clip(cfg, {k: v.float() for k, v in make_weights(
        cfg, bench.seed, bench.device, dtype).items()}, bench.device,
        torch.float32)
    out = entry(model, pool, t["batch"], int8=True, dtype=dtype)
    del model
    bench.free()
    return check.embedding_checks(out, reference(bench, pool))
