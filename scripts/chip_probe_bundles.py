#!/usr/bin/env python3
"""The zoo towers' bundles in the JAX layout on one NVIDIA GPU, apart from
the rest of chip_smoke.py:

    python3 scripts/chip_probe_bundles.py [family ...]

Builds the kernels, then runs phase 20 (chip_smoke.check_zoo_bundles) on
the families named, or on all of chip_smoke.Z20_FAMILIES: each bundle
written and loaded on the card, the fp32 image embeddings against the
original's, the bf16 text rows through fused_encode_text bit-equal with
exact fused_block launches, create_model from the bundle's .npz, the
seconds and GiB. It prints the card's name and power limit first. Exits
with code 2 without a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_probe_bundles: no CUDA device", file=sys.stderr)
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
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "fused_block": fused_block,
                "fused_block_residuals": fused_block_residuals,
                "fused_block_int8": fused_block_int8}
    t0 = time.perf_counter()
    cs.check_zoo_bundles(counters, gpu, tuple(argv) or cs.Z20_FAMILIES)
    print(f"[phase 20] {time.perf_counter() - t0:.1f} s on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
