#!/usr/bin/env python3
"""Where VLM2Vec's device time goes on LLaVA-1.5-7B, on one NVIDIA GPU:

    python3 scripts/chip_profile_vlm2vec.py [train batch, default 16]

Builds LLaVA-1.5-7B as chip_smoke.py's phase 10 does (seeded random
weights on the card) and its W8A8 twin, then profiles with
torch.profiler one warm call of each of: ``embed_mixed`` on a b16 mixed
batch of the synthetic route, bf16 and W8A8; one train step of the mixed
step at the given batch on each of phase 11's routes (the bf16 base with
materialized adapters, no remat; the W8A8 trunk with the side-path,
remat; GradCache chunks as chip_smoke.V2V_CHUNK), LoRA r16 alpha 64 on
the CLI's default targets. Device time summed by kernel name and grouped,
wall time, idle share, top kernels, and the operators that take the
most host time. Exits with code 2 without a CUDA
device.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from scripts.chip_profile_train import report  # noqa: E402


def profiled(label, fn, gpu, grad=False):
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(not grad):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report(label, prof, wall, gpu)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"[profile] {label} top host time: " + "; ".join(
        f"{e.key[:60]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in top[:10]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_vlm2vec: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.cli.train_vlm2vec import (
        _synthetic_mixed_batches, to_device)
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.models import lora
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.train.optim import adamw_over
    from clip_embeds_tpu_torch.train.vlm2vec import (
        Vlm2VecState, make_vlm2vec_mixed_train_step)

    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    gpu = cs.gpu_line()
    model = init_llava(LlavaConfig(), seed=cs.LLAVA_SEED, device="cuda",
                       dtype=torch.bfloat16)
    qmodel = cs.model_view(quantize_llava_trunk(model), quant_llm="dynamic",
                           lora_rank=cs.V2V_RANK,
                           lora_alpha=float(cs.V2V_ALPHA), remat=True)
    size = model.cfg.vision.image_size
    mix = to_device(next(_synthetic_mixed_batches(16, size, cs.V2V_SEED)),
                    "cuda", torch.bfloat16)
    args = [mix[k] for k in ("qry_ids", "qry_pixels", "qry_image_valid",
                             "qry_mask")]
    for label, m in (("bf16", model), ("int8", qmodel)):
        profiled(f"vlm2vec embed_mixed b16 {label}",
                 lambda: m.embed_mixed(*args), gpu)
    batch = to_device(next(_synthetic_mixed_batches(batch_size, size,
                                                    cs.V2V_SEED)),
                      "cuda", torch.bfloat16)
    for label, m in (("bf16", model), ("quant_base", qmodel)):
        tree = cs.v2v_adapters(model)
        tensors = list(lora.lora_tensors(tree))
        for t in tensors:
            t.requires_grad_()
        state = Vlm2VecState(model=m, optimizer=adamw_over(tensors),
                             schedule=lambda s: 2e-5, params=tree)
        chunks = batch_size // cs.V2V_CHUNK[label]
        step = make_vlm2vec_mixed_train_step(
            m, lora_alpha=float(cs.V2V_ALPHA), grad_cache_chunks=chunks)
        profiled(f"vlm2vec train step {label} b{batch_size} ({chunks} "
                 f"chunks)", lambda: step(state, batch), gpu, grad=True)
        del state, step, tree, tensors
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
