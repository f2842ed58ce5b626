#!/usr/bin/env python3
"""Where one serving call's device time goes, per route, on one NVIDIA GPU:

    python3 scripts/chip_profile_serving.py

Builds ViT-L/14-336 (OpenAI config, seeded random weights) in bf16 and in
fp32 (the --int8 routes read it, as the CLI does), then for each of
chip_smoke.py's phase-5 serving routes (images b32 composable + flash and
fused_encode_image, texts b256 fused_encode_text, and the --int8 twins)
runs one warm-up call and profiles one call with torch.profiler: device
time summed by kernel name and grouped, wall time, idle share, top kernels;
then times the route as chip_smoke.py's phase 5 does (CUDA events over 5
calls after 1 warm-up) for its items per second. Exits with code 2 without
a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from scripts.chip_profile_train import report  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from clip_embeds_tpu_torch.core.factory import create_model

    gpu = cs.gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, ref = (create_model(cs.MODEL, pretrained="openai", seed=0,
                               dtype=dt, device="cuda")
                  for dt in (torch.bfloat16, torch.float32))
    rng = np.random.default_rng(0)
    images, texts = cs.synthetic_requests(rng, model.cfg)
    with torch.inference_mode():
        for name, (count, fn) in cs.serving_routes(model, ref, images, texts,
                                                   rng).items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(f"{name} (batch {count})", prof, wall, gpu)
            ms = cs.cuda_ms(fn, iters=5, warmup=1)
            print(f"[throughput] {name}: {count / ms * 1e3:.1f} (batch "
                  f"{count}, {ms:.2f} ms) on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
