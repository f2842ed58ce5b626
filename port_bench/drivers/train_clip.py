"""CLIP training as ``cli/train.py`` trains: the state built as ``_train``
builds it (fp32 master weights computing in the traffic's precision,
composable blocks, ``--grad-checkpointing`` and ``--lock-image`` where the
traffic says, ``train/optim.py adamw`` with the CLI's defaults, the cosine
schedule with warm-up) and the step of ``train/steps.py
make_clip_train_step`` (InfoNCE, or the hard-negative loss with
``--usehardtext``), fed from a pool of seeded batches on the card.

Set-up drives that one state through its first steps with the window's own
call and feed: three checked steps (each loss, the first gradient as
AdamW's first moment holds it, and each leaf's change after the three) and
a few more to warm up. The window then steps until the deadline, recording
a CUDA event at each step boundary without waiting, and closes with one
synchronize. After the window the state is freed and the fp32 reference
follows the same three steps from the same weights and batches."""

from __future__ import annotations

import statistics

import numpy as np
import torch

from port_bench import check
from port_bench.harness import Bench, now
from port_bench.inputs import train_batches
from port_bench.port import build_clip
from port_bench.reference.precision import MATMULS
from port_bench.reference.train import train_steps
from port_bench.weights import make_weights


class StepClock:
    """Step boundaries: CUDA events on the current stream on the card (no
    wait), the host clock after a synchronize elsewhere."""

    def __init__(self, on_card: bool):
        self.on_card, self.marks = on_card, []

    def mark(self) -> None:
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(now())

    def intervals_ms(self):
        m = self.marks
        if self.on_card:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def build_state(bench: Bench):
    """(state, step function, model) as ``cli/train.py _train`` builds
    them."""
    from clip_embeds_tpu_torch.train import freeze, optim, schedules, steps

    t, cfg = bench.traffic, bench.config
    compute = torch.bfloat16 if t["precision"] == "bf16" else torch.float32
    model = build_clip(cfg, make_weights(cfg, bench.seed, bench.device,
                                         torch.float32),
                       bench.device, torch.float32, train=True,
                       remat=bool(t["grad_checkpointing"]),
                       block_impl="composable", compute_dtype=compute)
    if t["lock_image"]:
        freeze.apply_freeze(model, freeze.tower_freeze_labels(
            model, model.cfg, lock_image=True))
    opt = optim.adamw(model, t["lr"], t["beta1"], t["beta2"], t["eps"],
                      t["wd"])
    sched = schedules.cosine_lr(t["lr"], t["warmup"], t["total_steps"])
    state = steps.TrainState(model, opt, sched, None)
    step_fn = steps.make_clip_train_step(
        model, use_hard_text=t.get("hard_texts", 0) > 0, seed=bench.seed)
    return state, step_fn, model


def run(bench: Bench) -> dict:
    t = bench.traffic
    bench.mark("imports")
    state, step_fn, model = build_state(bench)
    bench.mark("weights_and_state")
    pool = train_batches(bench.config, t, bench.seed, bench.device)
    bench.mark("pool")
    views = check.leaf_views(model)
    p0 = {id(p): p.detach().clone() for p in model.parameters()}
    losses, grad = [], {}
    n_checked = t["checked_steps"]
    for k in range(n_checked):
        losses.append(float(step_fn(state, pool[k % len(pool)])["loss"]))
        if k == 0:
            moments = {id(p): s["exp_avg"] / (1 - t["beta1"])
                       for p, s in state.optimizer.state.items()}
            grad = check.leaf_norms(views, moments, views)
            del moments
    bench.mark("checked_steps")
    delta = {id(p): p.detach() - p0[id(p)] for p in model.parameters()}
    change = check.leaf_norms(views, delta, views)
    del delta, p0
    i = n_checked
    for _ in range(t["warm_steps"]):
        step_fn(state, pool[i % len(pool)])
        i += 1
    bench.sync()
    bench.mark("warm_steps")
    setup_s = now() - bench.t0
    bench.free()
    bench.reset_peak()
    clock = StepClock(bench.on_card)
    dispatch = []
    with bench.window():
        t_start = now()
        deadline = t_start + bench.seconds
        clock.mark()
        while now() < deadline or not dispatch:
            d0 = now()
            step_fn(state, pool[i % len(pool)])
            dispatch.append(now() - d0)
            if not bench.on_card:
                bench.sync()
            clock.mark()
            i += 1
        bench.sync()
        t_end = now()
    window_s = t_end - t_start
    peak = bench.peak_bytes()
    step_ms = clock.intervals_ms()
    n_steps = len(dispatch)
    del state, step_fn, model, pool, views
    bench.free()
    ref = reference(bench, "fp32")
    counts = {"steps": n_steps, "window_s": window_s,
              "samples": n_steps * t["batch"],
              "dispatch_s": float(np.sum(dispatch)),
              "step_ms_median": statistics.median(step_ms)}
    port = {"losses": losses, "grad": grad, "change": change}
    return {
        "metrics": {"setup_s": setup_s,
                    "train_samples_per_s": n_steps * t["batch"] / window_s,
                    "train_step_ms_p90": float(np.percentile(step_ms, 90))},
        "counts": counts,
        "checks": check.train_checks(port, ref),
        "attempted": n_steps,
        "failed": 0,
        "memory_peak_bytes": peak,
    }


def reference(bench: Bench, precision: str) -> dict:
    """The reference's readings of the checked steps: each loss, each
    leaf's first gradient norm, each leaf's change after them; every
    product of the towers in ``precision`` ('fp32', or the control's
    'fp8')."""
    t = bench.traffic
    n = t["checked_steps"]
    params = make_weights(bench.config, bench.seed, bench.device,
                          torch.float32)
    pool = train_batches(bench.config, t, bench.seed, bench.device)
    batches = [pool[k % len(pool)] for k in range(n)]
    del pool
    p0 = {k: v.clone() for k, v in params.items()}
    with check.fp32_reference():
        out = train_steps(params, bench.config, t, batches,
                          t["ref_chunk"], mm=MATMULS[precision])
    grad = check.norms(out["first_grads"])
    change = check.norms({k: params[k] - p0[k] for k in params})
    return {"losses": out["losses"], "grad": grad, "change": change}


def control(bench: Bench, kind: str = "fp8") -> dict:
    """The control: the reference in the port's place, its tower products
    in float8 (the precision below the configuration's bf16), judged
    against the fp32 reference as a run is."""
    low = reference(bench, "fp8")
    bench.free()
    return check.train_checks(low, reference(bench, "fp32"))
