#!/usr/bin/env python3
"""Where one PACL/SPARC head-training step's time goes on one NVIDIA GPU:

    python3 scripts/chip_profile_heads.py [batch]

ViT-L/14-336 (OpenAI config, seeded random fp32 weights, frozen) feeds a
head at ``--proj-dim`` 768 in fp32, as ``cli/train_pacl.py`` trains it
(default batch 64), with the step that ``train_pacl.build_trainer``
assembles for the CLI. For each objective and frozen-tower route (PACL:
composable fp32, fused, int8; SPARC: fused) it times on the host the
synthetic batch the CLI draws and its copy to the card, times one step
(the tower's features, then the head's forward, backward and Adam update)
by CUDA events over 3 steps after 2 warm-up ones, and profiles one step
with torch.profiler: device time summed by kernel name and grouped, the
step's wall time and idle share (1 - device time / wall time). Exits with
code 2 without a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from chip_profile_train import report  # noqa: E402

ROUTES = (("pacl", "composable"), ("pacl", "fused"), ("pacl", "int8"),
          ("sparc", "fused"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_heads: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from clip_embeds_tpu_torch.cli import train_pacl
    from clip_embeds_tpu_torch.cli.train import _to_device
    from clip_embeds_tpu_torch.core.factory import create_model

    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else cs.HEAD_BATCH
    gpu = cs.gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = create_model(cs.MODEL, pretrained="openai", seed=0,
                         device="cuda").requires_grad_(False)
    cfg, cuda = model.cfg, torch.device("cuda")
    for objective, route in ROUTES:
        args = train_pacl.parse_args([
            "--objective", objective, "--frozen-tower", route, "--synthetic",
            "--batch-size", str(batch_size), "--proj-dim",
            str(cfg.embed_dim)])
        t0 = time.perf_counter()
        batch = next(train_pacl._synthetic_batches(
            args, cfg.vision.image_size, cfg.text.context_length))
        draw_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        batch = _to_device(batch, cuda)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        tower_fn, state, step = train_pacl.build_trainer(args, model, route,
                                                         batch)

        def one_step():
            return step(state, tower_fn(batch), batch)

        for _ in range(2):
            one_step()
        ms = cs.cuda_ms(one_step, iters=3, warmup=0)
        label = f"{objective} {route} b{batch_size}"
        print(f"[heads] {label}: synthetic batch drawn in {draw_ms:.1f} ms "
              f"on the host, copied in {copy_ms:.1f} ms; step {ms:.2f} ms "
              f"by CUDA events ({batch_size / ms * 1e3:.1f} samples/s "
              f"without the host's batch) on {gpu}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(label, prof, wall, gpu)
        del state, step, tower_fn, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
