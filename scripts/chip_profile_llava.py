#!/usr/bin/env python3
"""Where LLaVA-1.5-7B VQAScore's device time goes, bf16 and W8A8, on one
NVIDIA GPU:

    python3 scripts/chip_profile_llava.py

Builds LLaVA-1.5-7B as chip_smoke.py's phase 10 does (seeded random
weights on the card, its word-hash tokenizer, 8 What'sUp-A images x 4
texts), then, in bf16 and after quantize_llava_trunk in W8A8, profiles one
warm call of each of: the prefill at k = 1 and k = 8 images
(Llava.prefill), and the k-group path (VQAScorer.forward_groups, host
preprocessing included) with torch.profiler: device time summed by kernel
name and grouped, wall time, idle share, top kernels. Exits with code 2
without a CUDA device.
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
from scripts.chip_profile_train import report  # noqa: E402


def profile_calls(label, scorer, images, texts, gpu):
    from torch.profiler import ProfilerActivity, profile

    calls = {}
    for k in (1, cs.LLAVA_GROUP):
        batch = scorer.pack_groups(images[:k], [list(texts)] * k)[2]
        ids = scorer._tensor(batch["prefix_ids"])
        valid = scorer._tensor(batch["prefix_valid"])
        px = scorer._pixels(batch["images"])
        calls[f"prefill k={k}"] = (
            lambda ids=ids, px=px, valid=valid:
            scorer.model.prefill(ids, px, valid))
    calls[f"forward_groups {len(images)}x{len(texts)}"] = (
        lambda: scorer.forward_groups(images, [list(texts)] * len(images)))
    for name, fn in calls.items():
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        report(f"llava {label} {name}", prof, wall, gpu)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile_llava: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.scores.vqa_score import VQAScorer

    gpu = cs.gpu_line()
    cfg = LlavaConfig()
    tok = cs.word_tokenizer(cs.LLAVA_SEED, cfg.llama.vocab_size)
    kw = dict(bos_token_id=1, pad_token_id=0)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "whatsup")
        cs.write_whatsup(root, 7)
        data, _ = load_annotation(root, "a")
        images = [os.path.join(root, d["image_path"][5:])
                  for d in data[:cs.LLAVA_GROUP]]
        texts = data[0]["caption_options"][:cs.LLAVA_TEXTS]
        model = init_llava(cfg, seed=cs.LLAVA_SEED, device="cuda",
                           dtype=torch.bfloat16)
        profile_calls("bf16", VQAScorer(model, tok, **kw), images, texts,
                      gpu)
        qmodel = quantize_llava_trunk(model)
        del model
        torch.cuda.empty_cache()
        profile_calls("int8", VQAScorer(qmodel, tok, **kw), images, texts,
                      gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
