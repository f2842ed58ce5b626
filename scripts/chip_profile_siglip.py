#!/usr/bin/env python3
"""Where one SigLIP serving call's device time goes, per route, on one
NVIDIA GPU:

    python3 scripts/chip_profile_siglip.py

Builds ViT-SO400M-14-SigLIP-384 (27 + 27 layers, seeded random weights) in
fp32 and bf16 as chip_smoke.py's phase 9 does, calibrates the int8 towers
on the first requests, then for each of phase 9's serving routes (images
b32 through fused_encode_image_siglip, the composable tower with the flash
kernel and the int8 twin; texts b256 through fused_encode_text_siglip and
its int8 twin) runs one warm-up call and profiles one call with
torch.profiler: device time summed by kernel name and grouped, wall time,
idle share, top kernels; then times the route as phase 9 does (CUDA
events over 3 calls after 1 warm-up). Exits with code 2 without a CUDA
device.
"""

from __future__ import annotations

import copy
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from scripts.chip_profile_train import report  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_siglip: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from clip_embeds_tpu_torch.core.openclip_registry import (
        resolve_siglip_config)
    from clip_embeds_tpu_torch.models.serving import (
        prepare_int8_siglip_text_tower, prepare_int8_siglip_tower)
    from clip_embeds_tpu_torch.models.siglip import cast_siglip, create_siglip

    gpu = cs.gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resolve_siglip_config(cs.SIGLIP_MODEL)
    ref = create_siglip(cfg, seed=0, device="cuda")
    model = cast_siglip(copy.deepcopy(ref), torch.bfloat16)
    px, ids = cs.siglip_requests(cfg)
    with torch.inference_mode():
        q_img = prepare_int8_siglip_tower(ref, px[:cs.SIGLIP_CALIB],
                                          torch.bfloat16)
        q_txt = prepare_int8_siglip_text_tower(ref, ids[:cs.SIGLIP_CALIB],
                                               torch.bfloat16)
        routes = cs.siglip_routes(model, ref, px, ids, q_img, q_txt)
        for name, (count, fn, _) in routes.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(f"siglip {name} (batch {count})", prof, wall, gpu)
            ms = cs.cuda_ms(fn, iters=3, warmup=1)
            print(f"[throughput] siglip {name}: {count / ms * 1e3:.1f} "
                  f"(batch {count}, {ms:.2f} ms) on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
