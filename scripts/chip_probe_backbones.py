#!/usr/bin/env python3
"""Fault probes behind the limits of chip_smoke.py's phase 14 (VLM2Vec's
other backbones) and its phase-3 shapes, on one NVIDIA GPU:

    python3 scripts/chip_probe_backbones.py [family ...]

(families: phi3.5-v, llava-next, qwen2-vl-7b, qwen2.5-vl-7b; all by
default)

1. The attention forward at chip_smoke.VB_FLASH_CASES (Phi-3's causal
   trunk at hd 96 over 2555 rows, Phi-3-V's 68-crop tower call), mean
   |diff| over all rows: the sound reading (kernel against its plain
   version) beside three faults, each the plain version with the fault
   against the plain version: the causal mask left out, the logits scaled
   by 1/sqrt(128) (the head dim padded to 128 and the scale taken from
   it), and the last partial Q tile left unwritten (zeros).
2. Each family of phase 14 (seeded, as there) with its limits opened:
   every reading phase 14 holds (launches exact), then on the trunk cut
   to VB_PLAIN_LAYERS layers one fault each against the plain fp32 path:
   Phi-3-V's ``glb_GN`` and ``sub_GN`` swapped, LLaVA-NeXT's positions
   taken as 0..N-1 over the holes (not cumsum(mask) - 1), Qwen2-VL's
   M-RoPE off (row 0 of the positions on 1-D RoPE), Qwen2.5-VL's window
   attention off (every block full); and the W8A8 Qwen2-VL trunk with
   each projection's activation codes at a quarter of their range (scale
   x4) against bf16.
3. Each family's mixed batch with a fault that only a batch can show,
   against its rows each run alone (sound): the image features rolled by
   one row (each image row reads another row's image), the embedding
   pooled at the wrong index of a padded row (the last column; in
   LLaVA-NeXT ``sum(mask) - 1``, blind to the holes), and in LLaVA-NeXT
   the feature-valid mask ignored (the text rows take image slots).

Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
        flash_attention, flash_attention_reference)

    rng = np.random.default_rng(cs.VB_SEED)
    for shape, causal, limit in cs.VB_FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
        n, hd = shape[2], shape[3]
        with torch.inference_mode():
            want = flash_attention_reference(q, k, v, causal).float()
            got = flash_attention(q, k, v, causal).float()
            open_mask = flash_attention_reference(q, k, v, False).float()
            scaled = flash_attention_reference(
                q * (128 / hd) ** -0.5, k, v, causal).float()
        dropped = want.clone()
        dropped[:, :, n // 128 * 128:] = 0
        read = {"sound": (got - want).abs().mean().item(),
                "logits at 1/sqrt(128)": (scaled - want).abs().mean().item(),
                "last Q tile dropped": (dropped - want).abs().mean().item()}
        if causal:
            read["no causal mask"] = (open_mask - want).abs().mean().item()
        print(f"[probe] attention {'x'.join(map(str, shape))} causal="
              f"{causal}: mean |diff| {read}, max |diff| sound "
              f"{(got - want).abs().max().item():.4g} (limit {limit}) on "
              f"{gpu}")
        del q, k, v, want, got, open_mask, scaled, dropped
        torch.cuda.empty_cache()


@contextlib.contextmanager
def arange_positions():
    """LLaVA-NeXT's merge with positions 0..N-1 over the holes (a fault)."""
    from clip_embeds_tpu_torch.models.llava_next import LlavaNext

    real = LlavaNext.merge

    def merge(self, *a, **kw):
        embeds, mask, positions = real(self, *a, **kw)
        return embeds, mask, torch.arange(
            mask.shape[1], device=mask.device).expand_as(positions)

    LlavaNext.merge = merge
    try:
        yield
    finally:
        LlavaNext.merge = real


@contextlib.contextmanager
def quarter_codes():
    """Every int8 projection's activation scale x4 (a fault)."""
    from clip_embeds_tpu_torch.models import quant

    real = quant.int8_linear
    quant.int8_linear = lambda x, a, *r: real(x, a * 4, *r)
    try:
        yield
    finally:
        quant.int8_linear = real


@contextlib.contextmanager
def patched(*sites):
    """Each (owner, name, f(real) -> replacement) in ``sites`` patched."""
    reals = [(owner, name, getattr(owner, name)) for owner, name, _ in sites]
    for (owner, name, make), (_, _, real) in zip(sites, reals):
        setattr(owner, name, make(real))
    try:
        yield
    finally:
        for owner, name, real in reals:
            setattr(owner, name, real)


def rolled_features():
    """Every image row's features taken from the row before it (a fault)."""
    from clip_embeds_tpu_torch.models import llava_next, phi3_v, qwen2_vl

    def place(real):
        return lambda mask, feats, embeds: real(mask, feats.roll(1, 0),
                                                embeds)

    return patched(
        (phi3_v, "place_in_order", place),
        (qwen2_vl, "place_in_order", place),
        (llava_next.LlavaNext, "pack",
         lambda real: lambda self, *a: real(self, *a).roll(1, 0)))


def wrong_pool(label):
    """The pooled index of each row moved (a fault): the last column of
    the padded row; LLaVA-NeXT's at ``sum(mask) - 1`` (blind to holes)."""
    from clip_embeds_tpu_torch.models import (
        llama, llava_next, phi3_v, qwen2_vl)

    seen = {}

    def trunk(real):
        def run(self, embeds, mask=None, *a, **kw):
            seen["hidden"] = hidden = real(self, embeds, mask, *a, **kw)
            seen["mask"] = mask
            return hidden
        return run

    def norm(real):
        def pool(_):
            hidden, mask = seen["hidden"], seen["mask"]
            rows = torch.arange(hidden.shape[0], device=hidden.device)
            last = (mask.int().sum(1) - 1 if label.startswith("llava")
                    else torch.full_like(rows, hidden.shape[1] - 1))
            return real(hidden[rows, last])
        return pool

    return patched((llama.LlamaForCausalLM, "trunk", trunk),
                   *((m, "l2_normalize", norm)
                     for m in (llava_next, phi3_v, qwen2_vl)))


def all_valid():
    """LLaVA-NeXT's merge with every feature slot valid (a fault)."""
    from clip_embeds_tpu_torch.models.llava_next import LlavaNext

    return patched((LlavaNext, "merge", lambda real: lambda self, ids,
                    packed, valid, *a: real(self, ids, packed,
                                            torch.ones_like(valid), *a)))


def mixed_faults(label, model, family, on, gpu):
    """The least row cosine of the mixed batch under each batch fault
    against its rows run alone (sound)."""
    calls, _, split = family
    faults = {"image features rolled a row": rolled_features,
              "pooled at the wrong index": lambda: wrong_pool(label)}
    if label.startswith("llava"):
        faults["feature-valid mask ignored"] = all_valid
    fn = calls["mixed"][0]
    with torch.inference_mode():
        alone = split(model, on).float().cpu().numpy()
        read = {}
        for name, ctx in faults.items():
            with ctx():
                got = fn(model, on).float().cpu().numpy()
            read[name] = float(cs.row_cos(got, alone).min())
    print(f"[probe] {label} mixed batch under a fault: least row cosine "
          f"against its rows alone {read} (limit {SPLIT_COS}) on {gpu}")


def fault_view(label, cut):
    """The cut with its family's fault (model views: the weights shared),
    and the context to run it in (a factory: one context a call)."""
    cfg = cut.cfg
    if label.startswith("phi"):
        view = cs.model_view(cut)
        emb = view.vision_embed
        emb.glb_GN, emb.sub_GN = emb.sub_GN, emb.glb_GN
        return "glb_GN / sub_GN swapped", view, contextlib.nullcontext
    if label.startswith("llava"):
        return "positions 0..N-1", cut, arange_positions
    if label.startswith("qwen2.5"):
        v = dataclasses.replace(cfg.vision, fullatt_block_indexes=tuple(
            range(cfg.vision.depth)))
        return ("window attention off",
                cs.model_view(cut, dataclasses.replace(cfg, vision=v)),
                contextlib.nullcontext)
    t = dataclasses.replace(cfg.text, mrope_section=None)
    return ("M-RoPE off", cs.model_view(cut, dataclasses.replace(cfg, text=t)),
            contextlib.nullcontext)


SPLIT_COS = cs.VB_SPLIT_COS  # phase 14's limit, before it is opened


def family_faults(gpu, labels):
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops.flash_attention import flash_attention
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    counters = {"flash_attention": flash_attention,
                "int8_linear": int8_linear}
    cs.VB_SPLIT_COS = cs.VB_FP32_COS = cs.VB_INT8_COS = -1.0
    for label, build, make_family, int8 in cs.vb_models():
        if labels and label not in labels:
            continue
        t0 = time.perf_counter()
        model = build()
        qmodel = quantize_llava_trunk(model, "dynamic") if int8 else None
        cs.vb_family_run(label, model, make_family, counters, gpu, qmodel)
        calls, inputs, _ = family = make_family(model)
        on = cs.vb_to_device(inputs, torch.bfloat16)
        mixed_faults(label, model, family, on, gpu)
        on32 = cs.vb_to_device(inputs, torch.float32)
        cut = cs.model_view(model, cs.cut_config(model.cfg,
                                                 cs.VB_PLAIN_LAYERS))
        ref = cs.cast_copy(cut, torch.float32)
        name, view, ctx = fault_view(label, cut)
        image = next(k for k in calls if k.startswith("image rows"))
        read = {}
        for call in (image, "forward"):
            fn = calls[call][0]
            with torch.inference_mode():
                plain = fn(ref, on32).float().cpu().numpy()
                with ctx():
                    got = fn(view, on).float().cpu().numpy()
            read[call] = float(cs.row_cos(got, plain).min())
        print(f"[probe] {label} {name}: least row cosine against plain "
              f"fp32 on the {cs.VB_PLAIN_LAYERS}-layer cut {read} on {gpu}")
        del cut, ref, view
        if qmodel is not None:
            read = {}
            for call in ("image rows", "text rows"):
                fn = calls[call][0]
                with torch.inference_mode():
                    want = fn(model, on).float().cpu().numpy()
                    with quarter_codes():
                        got = fn(qmodel, on).float().cpu().numpy()
                read[call] = float(cs.row_cos(got, want).min())
            print(f"[probe] {label} W8A8 codes at a quarter of their range:"
                  f" least row cosine against bf16 {read} on {gpu}")
        del model, qmodel, family, on, on32
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[probe] {label}: {time.perf_counter() - t0:.1f} s on {gpu}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_backbones: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops import _build

    gpu = cs.gpu_line()
    print(f"[device] {gpu} | torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    attention_faults(gpu)
    family_faults(gpu, sys.argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
