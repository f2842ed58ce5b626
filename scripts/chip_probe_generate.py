#!/usr/bin/env python3
"""Readings and fault probes behind the limits of chip_smoke.py's phase 16
(generation and CoCa) and of its phase-3 cases at phase 16's shapes, on one
NVIDIA GPU:

    python3 scripts/chip_probe_generate.py

1. The attention forward at chip_smoke.GEN_FLASH_CASES and the forward and
   backward at GEN_FLASH_TRAIN_CASES (CoCa ViT-L/14's 257 rows, head dim
   64): mean |diff| of the kernel against its plain version beside two
   faults, each the plain version with the fault against the plain
   version: the logits scaled by 1/sqrt(128) in place of 1/sqrt(64), and
   the last partial Q tile left out (its outputs zero; in the backward,
   its rows' upstream gradient zero, so dK and dV lose its share).
2. int8_linear at GEN_INT8_LINEAR_CASES (check_int8_linear: 1 and 8 rows,
   bit-equal to qdot or it raises).
3. Phase 16 whole (gen_llava on a seeded LLaVA-1.5-7B and its W8A8 twin,
   gen_coca on coca_ViT-L-14) with every limit opened, so that it prints
   each sound reading: the largest top-2 margin at which a decoded token
   differs from the teacher-forced argmax (bf16, W8A8 with dynamic
   scales, and W8A8 with static scales), the cut's cosines and where
   bf16 and fp32 part, W8A8 against bf16, the CoCa cosines and gradient
   agreement, launches, tokens/s, captions/s, samples/s, peak memory.
4. Faults beside the sound readings: greedy decoding with each step fed
   at RoPE position n + step + 1 (the JAX package's greedy_generate)
   against the teacher-forced argmax (the largest margin of a differing
   step), bf16, W8A8 with dynamic scales and W8A8 with static scales
   calibrated as phase 16 calibrates them; CoCa's text tower with the
   CLS row's pad mask dropped (pads visible to the latent), its text
   latents' least row cosine against the sound fp32 tower.
5. Where a warm greedy call's time goes, bf16 and W8A8 at b1 and b8:
   one call of llava_greedy_generate under torch.profiler, its device
   time summed by kernel group beside its wall time and idle share.

Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def attention_faults(gpu):
    from clip_embeds_tpu_torch.ops.flash_attention import (
        _flash_forward, flash_attention, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_reference)

    rng = np.random.default_rng(cs.GEN_SEED)
    for shape, causal, limit in (cs.GEN_FLASH_CASES
                                 + cs.GEN_FLASH_TRAIN_CASES):
        q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(4))
        hd, n = shape[-1], shape[-2]
        tail = (n // 128) * 128
        with torch.no_grad():
            want = flash_attention_reference(q, k, v, causal).float()
            got = flash_attention(q, k, v, causal).float()
            scaled = flash_attention_reference(
                q * (hd / 128) ** 0.5, k, v, causal).float()
            dropped = want.clone()
            dropped[:, :, tail:] = 0
            read = {"sound": (got - want).abs().mean().item(),
                    "logits at 1/sqrt(128)":
                        (scaled - want).abs().mean().item(),
                    "last Q tile dropped":
                        (dropped - want).abs().mean().item()}
            print(f"[probe] attention forward {'x'.join(map(str, shape))}: "
                  f"mean |diff| {read} (limit {limit}) on {gpu}")
            if shape[0] < 32:
                continue
            o, lse = _flash_forward(q, k, v, causal, with_lse=True)
            bwd = flash_attention_bwd(q, k, v, o, g, lse, causal)
            ref = flash_attention_bwd_reference(q, k, v, o, g, causal)
            g_cut = g.clone()
            g_cut[:, :, tail:] = 0
            cut = flash_attention_bwd_reference(q, k, v, o, g_cut, causal)
            scaled = flash_attention_bwd_reference(
                q * (hd / 128) ** 0.5, k, v, o, g, causal)

            def worst(a, b):
                return max((x.float() - y.float()).abs().mean().item()
                           for x, y in zip(a, b))

            read = {"sound": worst(bwd, ref),
                    "logits at 1/sqrt(128)": worst(scaled, ref),
                    "last Q tile left out": worst(cut, ref)}
            print(f"[probe] attention backward {'x'.join(map(str, shape))}:"
                  f" the worst output's mean |diff| {read} (limit {limit}) "
                  f"on {gpu}")


@contextlib.contextmanager
def opened_limits():
    names = {"GEN_MARGIN": 1e9, "GEN_INT8_MARGIN": 1e9,
             "GEN_STATIC_MARGIN": 1e9, "GEN_FP32_MARGIN": 1e9,
             "GEN_FP32_COS": -1.0,
             "COCA_MARGIN": 1e9, "COCA_COS": -1.0, "GRAD_COS_MIN": -1.0,
             "GRAD_TENSOR_COS_MIN": -1.0, "GRAD_COS_BELOW_WITNESS": 1e9}
    saved = {k: getattr(cs, k) for k in names}
    for k, v in names.items():
        setattr(cs, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(cs, k, v)


def counters():
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8, fused_block_residuals)

    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "fused_block": fused_block,
            "fused_block_residuals": fused_block_residuals,
            "fused_block_int8": fused_block_int8}


@torch.inference_mode()
def shifted_greedy(model, ids, px, steps):
    """models/generate.py llava_greedy_generate with each decode step fed
    at RoPE position n + step + 1, one past its cache slot (the JAX
    package's greedy_generate)."""
    from clip_embeds_tpu_torch.models.generate import init_cache

    lm = model.language_model
    embeds = model.merge(ids, model.encode_images(px))
    b, n = embeds.shape[:2]
    cache = init_cache(lm, b, n + steps)
    hidden, cache = lm.trunk(embeds, None, torch.arange(
        n, device=ids.device).expand(b, n), cache=cache)
    token = lm.logits(hidden[:, -1]).argmax(-1)
    out = [token]
    for step in range(steps - 1):
        pos = torch.full((b, 1), n + step + 1, device=ids.device)
        hidden, cache = lm.trunk(lm.embed(token[:, None]), None, pos,
                                 cache=cache)
        token = lm.logits(hidden[:, -1]).argmax(-1)
        out.append(token)
    return torch.stack(out, 1)


def position_fault(models, gpu):
    """The largest margin of a differing step with the position fault, on
    seeded pixels: bf16, W8A8 (dynamic scales), and W8A8 with static
    scales calibrated on its own teacher-forced forward over the sound
    W8A8 tokens, as phase 16 calibrates them."""
    from clip_embeds_tpu_torch.models.generate import llava_greedy_generate

    b = max(cs.GEN_BATCHES)
    qmodel = models["W8A8"]
    ids = cs.gen_prompts(b, qmodel.cfg.llama.vocab_size, cs.GEN_SEED)
    px = torch.randn(b, qmodel.cfg.vision.image_size,
                     qmodel.cfg.vision.image_size, 3, device="cuda",
                     dtype=torch.bfloat16,
                     generator=torch.Generator("cuda").manual_seed(0))

    def read(route, model):
        toks = shifted_greedy(model, ids, px, cs.GEN_NEW_TOKENS)
        logits = cs.teacher_forced(model, ids, px, toks)
        _, _, worst = cs.forced_agreement("position fault", toks, logits,
                                          1e9)
        print(f"[probe] {route} decode steps at position n + step + 1 "
              f"(JAX's fault): the largest margin of a differing step "
              f"{worst:.4f} (sound: phase 16's reading) on {gpu}")

    for route, model in models.items():
        read(route, model)
    with torch.inference_mode():
        sound = llava_greedy_generate(qmodel, ids, px, cs.GEN_NEW_TOKENS)
    with cs.static_scales(qmodel, lambda: cs.teacher_forced(
            qmodel, ids, px, sound)):
        read("W8A8 static", qmodel)


def profile_generate(models, gpu):
    """One warm llava_greedy_generate call a route and batch under
    torch.profiler: device time by kernel group, wall, idle share."""
    from torch.profiler import ProfilerActivity, profile

    from clip_embeds_tpu_torch.models.generate import llava_greedy_generate
    from scripts.chip_profile_train import report

    for b in cs.GEN_BATCHES:
        for route, model in models.items():
            ids = cs.gen_prompts(b, model.cfg.llama.vocab_size, cs.GEN_SEED)
            px = torch.randn(b, model.cfg.vision.image_size,
                             model.cfg.vision.image_size, 3, device="cuda",
                             dtype=torch.bfloat16,
                             generator=torch.Generator("cuda").manual_seed(0))

            def fn():
                return llava_greedy_generate(model, ids, px,
                                             cs.GEN_NEW_TOKENS)

            with torch.inference_mode():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            report(f"generate {route} b{b}, {cs.GEN_NEW_TOKENS} new tokens",
                   prof, wall, gpu)


def coca_mask_fault(gpu):
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.data.synthetic import synthetic_batches
    from clip_embeds_tpu_torch.models import coca

    ref = create_model(cs.COCA_MODEL, seed=cs.COCA_SEED, device="cuda")
    model = cs.cast_copy(ref, torch.bfloat16)
    texts = torch.from_numpy(next(synthetic_batches(
        cs.COCA_TEXTS, 224, ref.cfg.text.context_length,
        seed=cs.COCA_SEED))["texts"]).long().cuda()
    with torch.inference_mode():
        want = ref.encode_text(texts)
        sound = model.encode_text(texts).float()
        real = coca.text_attention_mask
        with cs.patched(coca, "text_attention_mask",
                        lambda ids, pad: real(ids, -1)):
            fault = model.encode_text(texts).float()
    read = {name: float(torch.nn.functional.cosine_similarity(
        x, want, dim=-1).min()) for name, x in (("sound", sound),
                                                ("pad mask dropped", fault))}
    print(f"[probe] CoCa text latents, least row cosine against plain "
          f"fp32: {read} (limit {cs.COCA_COS}) on {gpu}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_generate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.gpu_line()
    print(f"[probe] {gpu}")
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    _build.library()
    attention_faults(gpu)
    with torch.no_grad():
        cs.check_int8_linear(gpu, cs.GEN_INT8_LINEAR_CASES, seed=cs.GEN_SEED)
    model = init_llava(LlavaConfig(), seed=cs.LLAVA_SEED, device="cuda",
                       dtype=torch.bfloat16)
    qmodel = quantize_llava_trunk(model)
    with opened_limits():
        cs.gen_llava(model, qmodel, dict(counters(), int8_linear=int8_linear),
                     gpu)
    position_fault({"bf16": model, "W8A8": qmodel}, gpu)
    profile_generate({"bf16": model, "W8A8": qmodel}, gpu)
    del model, qmodel
    torch.cuda.empty_cache()
    with opened_limits():
        cs.gen_coca(counters(), gpu)
    coca_mask_fault(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
