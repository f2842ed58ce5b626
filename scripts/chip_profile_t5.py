#!/usr/bin/env python3
"""Where CLIP-FlanT5-XXL VQAScore's device time goes, bf16 and W8A8, on one
NVIDIA GPU:

    python3 scripts/chip_profile_t5.py

Builds CLIP-FlanT5-XXL as chip_smoke.py's phase 13 does (seeded random
weights on the card, its T5 word-hash tokenizer, 8 What'sUp-A images x 4
texts), then, in bf16 and after quantize_clip_t5_trunk in W8A8, profiles
one warm call of T5VQAScorer.forward_groups (host preprocessing
included; one tower call, four b8 T5 passes) with torch.profiler: device
time summed by kernel name and grouped (the T5 attention's fp32 logits
and P.V apart from the bf16 projections), wall time, idle share, top
kernels. Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import os
import sys
import tempfile
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
        return "cuBLAS fp32 GEMM (T5 attention logits)"
    if "softmax" in low:
        return "PyTorch softmax (T5 and Q-Former attention)"
    return _train_group(name)


def profile_call(label, scorer, images, texts, gpu):
    from torch.profiler import ProfilerActivity, profile

    def fn():
        return scorer.forward_groups(images, [list(texts)] * len(images))

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    pt.report(f"clip-flant5-xxl {label} forward_groups {len(images)}x"
              f"{len(texts)}", prof, wall, gpu)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_t5: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.core.factory import init_score_model
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation
    from clip_embeds_tpu_torch.models.clip_t5 import CLIPT5
    from clip_embeds_tpu_torch.models.quant import quantize_clip_t5_trunk
    from clip_embeds_tpu_torch.scores.build import default_model_config
    from clip_embeds_tpu_torch.scores.vqa_score import T5VQAScorer

    torch.backends.cuda.matmul.allow_tf32 = False
    pt.group = group  # report() groups by this module's names
    gpu = cs.gpu_line()
    cfg = default_model_config("clip-flant5-xxl")
    tok = cs.t5_word_tokenizer(cs.T5_SEED, cfg.t5.vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "whatsup")
        cs.write_whatsup(root, 7)
        data, _ = load_annotation(root, "a")
        images = [os.path.join(root, d["image_path"][5:])
                  for d in data[:cs.T5_GROUP]]
        texts = data[0]["caption_options"][:cs.T5_TEXTS]
        with torch.device("meta"):
            model = CLIPT5(cfg)
        model = init_score_model(model, cs.T5_SEED, "cuda", torch.bfloat16)
        profile_call("bf16", T5VQAScorer(model, tok), images, texts, gpu)
        qmodel = quantize_clip_t5_trunk(model)
        del model
        torch.cuda.empty_cache()
        profile_call("int8", T5VQAScorer(qmodel, tok), images, texts, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
