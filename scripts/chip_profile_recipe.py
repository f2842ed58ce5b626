#!/usr/bin/env python3
"""Where a step of the source's CLIP fine-tune recipe spends its time, and
what FLIP patch dropout saves, on one NVIDIA GPU:

    python3 scripts/chip_profile_recipe.py

On ViT-L/14-336 (seed 0, fp32 masters, bf16 compute) and phase 12's
datamix fixture of chip_smoke.py (written from its seed into a temporary
directory), for each of the recipe's routes (composable, fused-train-res)
with the image tower locked and hard texts on:

- the recipe's loop as cli/train.py runs it (next() of the datamix
  iterator, the copy to the card, the step, the loss read back): two
  warm-up steps, then two steps under torch.profiler, with the device time
  by kernel group, the window's wall time, the idle share and the host's
  seconds in next();
- the same step on one batch already on the card, by CUDA events over 3
  steps after 1 warm-up: the device-bound rate.

Then phase 6's unlocked step (synthetic b32 on the card, CUDA events) on
each block route with and without --force-patch-dropout 0.5, in turns in
this one process. Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
from chip_profile_train import report  # noqa: E402


def event_ms(step, state, batch, iters=3):
    """Mean ms of ``step(state, batch)`` by CUDA events after 1 warm-up."""
    step(state, batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def recipe(root, gpu):
    from torch.profiler import ProfilerActivity, profile

    from clip_embeds_tpu_torch.cli import train as train_cli
    from clip_embeds_tpu_torch.train.freeze import (
        apply_freeze, tower_freeze_labels)
    from clip_embeds_tpu_torch.train.optim import adamw
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState, make_clip_train_step)

    args = train_cli.parse_args([
        "--model", cs.MODEL, "--batch-size", str(cs.TRAIN_BATCH), "--seed",
        "0", "--lock-image", "--usehardtext", "--augfiles",
        f"{root}/leftright.json", "--dataset-type", "datamix",
        "--train-data", f"{root}/ann.json", "--lcs-root", f"{root}/lcs",
        "--datamix-root", f"{root}/datamix"])
    device = torch.device("cuda")
    for route in cs.RECIPE_ROUTES:
        model = cs.route_model(route)
        apply_freeze(model, tower_freeze_labels(model, model.cfg,
                                                lock_image=True))
        state = TrainState(model, adamw(model, 1e-5), const_lr(1e-5))
        step = make_clip_train_step(model, use_hard_text=True)
        batches, _ = train_cli.build_data(args, model.cfg)

        def loop_step():
            t = time.perf_counter()
            batch = next(batches)
            host = time.perf_counter() - t
            float(step(state, train_cli._to_device(batch, device))["loss"])
            return host

        for _ in range(2):
            loop_step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            host = loop_step() + loop_step()
            wall = time.perf_counter() - t0
        report(f"recipe {route} b{cs.TRAIN_BATCH}, 2 steps of the loop "
               f"(host {host * 1e3:.1f} ms in next())", prof, wall, gpu)
        batch = train_cli._to_device(next(iter(train_cli.build_data(
            args, model.cfg)[0])), device)
        ms = event_ms(step, state, batch)
        print(f"[recipe] {route} b{cs.TRAIN_BATCH} step on a batch on the "
              f"card: {ms:.2f} ms, {cs.TRAIN_BATCH / ms * 1e3:.1f} "
              f"samples/s (CUDA events) on {gpu}")
        del model, state, step, batches, batch
        torch.cuda.empty_cache()


def patch_dropout(gpu):
    from clip_embeds_tpu_torch.core import factory
    from clip_embeds_tpu_torch.train.optim import adamw
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState, make_clip_train_step)

    batch = cs.train_batch(cs.TRAIN_BATCH, seed=2)
    base = {k: v.cpu() for k, v in cs.route_model(
        "composable").state_dict().items()}
    for route in cs.ROUTES:
        times = {}
        for drop in (None, cs.PATCH_DROP, cs.PATCH_DROP, None):
            # the seed-0 weights, drawn once
            with cs.patched(factory, "init_params",
                            lambda model, seed=0: model.load_state_dict(base)):
                model = factory.create_model(
                    cs.MODEL, pretrained="openai", seed=0,
                    dtype=torch.float32, device="cuda", block_impl=route,
                    compute_dtype=torch.bfloat16, force_patch_dropout=drop,
                    train=True)
            state = TrainState(model, adamw(model, 1e-5), const_lr(1e-5))
            torch.cuda.reset_peak_memory_stats()
            ms = event_ms(make_clip_train_step(model), state, batch)
            times.setdefault(drop, []).append(
                (ms, torch.cuda.max_memory_allocated() / 2 ** 30))
            del model, state
            torch.cuda.empty_cache()
        (a, pa), (b, pb) = (min(times[None]), min(times[cs.PATCH_DROP]))
        print(f"[patch dropout] {route} b{cs.TRAIN_BATCH}: "
              f"{a:.2f} ms (peak {pa:.2f} GiB) without, {b:.2f} ms (peak "
              f"{pb:.2f} GiB) at {cs.PATCH_DROP}: {b / a:.3f}x; all "
              f"{times} on {gpu}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_recipe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    with tempfile.TemporaryDirectory() as root:
        cs.write_recipe_fixtures(root, cs.RECIPE_SEED)
        recipe(root, gpu)
    patch_dropout(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
