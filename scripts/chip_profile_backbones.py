#!/usr/bin/env python3
"""Where the device time of VLM2Vec's other backbones goes, on one NVIDIA
GPU:

    python3 scripts/chip_profile_backbones.py [family ...]

(families: phi3.5-v, llava-next, qwen2-vl-7b, qwen2.5-vl-7b; all by
default). Builds each family as chip_smoke.py's phase 14 does (seeded
weights on the card, its b4 requests; Qwen2-VL also with the W8A8 trunk)
and profiles one warm call of the image query rows' ``embed_last_token``
(the masked trunk) and of the unmasked ``forward`` with torch.profiler:
device time summed by kernel name and grouped (the plain attention's fp32
logits GEMM and softmax apart from the bf16 projections), wall time,
idle share, top kernels. Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from scripts import chip_profile_train as pt  # noqa: E402

_train_group = pt.group


def group(name: str) -> str:
    low = name.lower()
    if ("gemm" in low or "gemv" in low) and (
            "f32f32" in low or "sgemm" in low or "tf32" in low):
        return "cuBLAS fp32 GEMM (plain attention logits)"
    if "softmax" in low:
        return "PyTorch softmax (plain attention)"
    if "memcpy" in low:
        return "device-to-device copies"
    return _train_group(name)


def profile_call(label, fn, gpu):
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    pt.report(label, prof, wall, gpu)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_backbones: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk

    torch.backends.cuda.matmul.allow_tf32 = False
    pt.group = group  # report() groups by this module's names
    gpu = cs.gpu_line()
    labels = sys.argv[1:]
    for label, build, make_family, int8 in cs.vb_models():
        if labels and label not in labels:
            continue
        model = build()
        routes = {"bf16": model}
        if int8:
            routes["int8"] = quantize_llava_trunk(model, "dynamic")
        calls, inputs, _ = make_family(model)
        on = cs.vb_to_device(inputs, torch.bfloat16)
        image = next(k for k in calls if k.startswith("image rows"))
        for route, m in routes.items():
            for name in (image, "forward"):
                fn = calls[name][0]
                profile_call(f"{label} {route} {name} b{cs.VB_BATCH}",
                             lambda: fn(m, on), gpu)
        del model, routes, on
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
