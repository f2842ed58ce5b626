#!/usr/bin/env python3
"""Training on the zoo towers and the last entry points on one NVIDIA GPU,
apart from the rest of chip_smoke.py:

    python3 scripts/chip_probe_zoo_train.py [--kernels-only] [--pad-probe]

Builds the kernels, runs phase 3's cases at phases 17 and 18's shapes
(chip_smoke.zoo_kernel_cases: the attention forward and backward at
EVA01-g-14's b32 train step, 32x16x257x88, the backward padding head dim
88 to its 128-wide kernel, and fused_block / fused_block_int8 at
ViT-H-14-378's b4 image request) under chip_smoke.py's limits, with their
times, bounds and the library call. ``--pad-probe`` adds the backward at
head dims 72, 80, 88 and 96 over 32x16x257 beside head dims 64 and 128
(the cost of the padding: ms against the bound at the true head dim).
Then, unless ``--kernels-only``, phase 18 (chip_smoke.check_zoo_training):
EVA01-g-14 through cli/train.py on both routes with exact launches,
samples/s, the peak and the block gradients; one step of each other
family; EVA02-E-14 locked, and out of memory unlocked; cli/profile.py with
traces; the export round trip; jax_preprocess on the card. It prints the
card's name and power limit first. Exits with code 2 without a CUDA
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
        print("chip_probe_zoo_train: no CUDA device", file=sys.stderr)
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
        if "--pad-probe" in argv:
            cases = [((32, 16, 257, hd), False, 2e-5)
                     for hd in (64, 72, 80, 88, 96, 128)]
            cs.run_kernel_cases([
                c for c in cs.flash_train_cases(
                    np.random.default_rng(cs.Z18_SEED), cases)
                if c[0].startswith("flash_attention_bwd")])
    if "--kernels-only" in argv:
        return 0
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "fused_block": fused_block,
                "fused_block_residuals": fused_block_residuals,
                "fused_block_int8": fused_block_int8}
    t0 = time.perf_counter()
    cs.check_zoo_training(counters, gpu)
    print(f"[phase 18] {time.perf_counter() - t0:.1f} s on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
