#!/usr/bin/env python3
"""Where one ViT-L/14-336 train step's device time goes, per block route,
on one NVIDIA GPU:

    python3 scripts/chip_profile_train.py [batch]

For each route (composable, fused-train, fused-train-res) it runs two
warm-up steps of the port's train step (fp32 masters, bf16 compute, one
synthetic batch on the card, default 32), then profiles one step with
torch.profiler and prints the device time summed by kernel name (the top
entries, grouped as our attention forward / backward, our GEMM, our
LayerNorm, cuBLAS GEMMs and the rest), the wall time of the step, and the
idle share (1 - device time / wall time). Exits with code 2 without a
CUDA device.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

# kernel name fragments -> group
_GROUPS = (
    ("attention_bwd", "our attention backward (#5)"),
    ("attention_kernel", "our attention forward (#4)"),
    ("gemm_s8_kernel", "our int8 GEMM (#3)"),
    ("layernorm_s8_kernel", "our int8 LayerNorm and quantise (#3)"),
    ("quantize_s8_kernel", "our int8 LayerNorm and quantise (#3)"),
    ("gemm_kernel", "our GEMM (#1/#2)"),
    ("layernorm_kernel", "our LayerNorm (#1/#2)"),
    ("gemm", "cuBLAS GEMM"),
    ("cutlass", "cuBLAS GEMM"),
    ("sm90_xmma", "cuBLAS GEMM"),
    ("nvjet", "cuBLAS GEMM"),
    ("softmax", "PyTorch softmax (text attention)"),
    ("layer_norm", "PyTorch LayerNorm"),
    ("multi_tensor", "AdamW (foreach kernels)"),
)


def group(name: str) -> str:
    low = name.lower()
    for frag, label in _GROUPS:
        if frag in low:
            return label
    return "elementwise and other"


def report(label: str, prof, wall: float, gpu: str) -> None:
    """Print the device time of a profiled window summed by kernel name and
    grouped, beside the window's wall time (``wall``, seconds) and idle
    share, and the top kernels."""
    from torch.autograd import DeviceType

    by_name = defaultdict(float)
    for ev in prof.key_averages():
        # kernels only: an operator's row, and a user annotation on the
        # device timeline (Optimizer.step), repeat their kernels'
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and "#" not in ev.key
                and ev.key != "Command Buffer Full"):
            by_name[ev.key] += ev.self_device_time_total / 1e3  # ms
    total = sum(by_name.values())
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[group(name)] += ms
    parts = ", ".join(f"{g} {ms:.2f} ms ({100 * ms / total:.1f}%)"
                      for g, ms in sorted(groups.items(),
                                          key=lambda kv: -kv[1]))
    print(f"[profile] {label}: device {total:.2f} ms, wall "
          f"{wall * 1e3:.2f} ms, idle share {1 - total / (wall * 1e3):.3f}; "
          f"{parts} on {gpu}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"[profile] {label} top kernels: " + "; ".join(
        f"{name[:90]} {ms:.2f} ms" for name, ms in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_train: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from clip_embeds_tpu_torch.train.optim import adamw
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState, make_clip_train_step)

    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else cs.TRAIN_BATCH
    gpu = cs.gpu_line()
    batch = cs.train_batch(batch_size, seed=2)
    for route in cs.ROUTES:
        model = cs.route_model(route)
        state = TrainState(model, adamw(model, 1e-5), const_lr(1e-5))
        step = make_clip_train_step(model)
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{route} b{batch_size}", prof, wall, gpu)
        del model, state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
