#!/usr/bin/env python3
"""The open_clip tower zoo on one NVIDIA GPU, apart from the rest of
chip_smoke.py:

    python3 scripts/chip_probe_zoo.py [--kernels-only]

Builds the kernels, runs phase 3's cases at phase 17's new shapes
(chip_smoke.zoo_kernel_cases: the attention forward at EVA01-g-14's b32
tower call, 32x16x257x88, and fused_block / fused_block_int8 at
ViT-H-14-378's b4 image request, 4x736x1280, head dim 80) under
chip_smoke.py's limits, with their times, bounds and the library call;
then, unless ``--kernels-only``, phase 17 (chip_smoke.check_zoo): every
zoo family at its published widths and depth against its plain fp32 path,
with launch counts, row cosines, img/s and each part's seconds. It prints
the card's name and power limit first. Exits with code 2 without a CUDA
device.
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_probe_zoo: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8, fused_block_residuals)

    gpu = cs.gpu_line()
    print(f"[device] {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        cs.run_kernel_cases(cs.zoo_kernel_cases(
            np.random.default_rng(cs.ZOO_SEED)))
    if "--kernels-only" in argv:
        return 0
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "fused_block": fused_block,
                "fused_block_residuals": fused_block_residuals,
                "fused_block_int8": fused_block_int8}
    t0 = time.perf_counter()
    cs.check_zoo(counters, gpu)
    print(f"[phase 17] {time.perf_counter() - t0:.1f} s on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
