#!/usr/bin/env python3
"""Times of the attention kernels (#4 forward, #5 backward) of the checkout
this script sits in, on one NVIDIA GPU:

    python3 scripts/chip_attention_times.py [label]

At chip_smoke.py's FLASH_CASES shapes, for the kernel wrapper and for
torch's scaled_dot_product_attention (forward, and its backward through
autograd): the time per call as chip_smoke.py takes it (CUDA events over
back-to-back calls after a warm-up, host work included), repeated, and the
device time of the kernels alone (torch.profiler, summed over the calls).
Run it from two checkouts in turns (A, B, B, A) to compare them on one card.
Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

ITERS, REPEATS = 50, 5


def device_ms(fn, iters=ITERS):
    """Kernel time per call on the device, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_attention_times: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops.flash_attention import (
        _flash_forward, flash_attention, flash_attention_bwd)

    label = sys.argv[1] if len(sys.argv) > 1 else "this checkout"
    gpu = cs.gpu_line()
    rng = np.random.default_rng(0)
    for shape, causal, _ in cs.FLASH_CASES:
        q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(4))
        with torch.no_grad():
            o, lse = _flash_forward(q, k, v, causal, with_lse=True)
        with torch.enable_grad():
            lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        calls = {
            "flash_attention": lambda: flash_attention(q, k, v, causal),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal),
            "flash_attention_bwd": lambda: flash_attention_bwd(
                q, k, v, o, g, lse, causal),
            "sdpa_bwd": lambda: torch.autograd.grad(
                lo, (lq, lk, lv), g, retain_graph=True),
        }
        name = f"{'x'.join(map(str, shape))} causal={causal}"
        for what, fn in calls.items():
            with torch.no_grad() if "bwd" not in what else torch.enable_grad():
                per_call = [cs.cuda_ms(fn) for _ in range(REPEATS)]
                dev = device_ms(fn)
            print(f"[times] {label} {what} {name}: per call "
                  f"{' '.join(f'{t:.4f}' for t in per_call)} ms (CUDA "
                  f"events, 10 calls each), device {dev:.4f} ms on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
