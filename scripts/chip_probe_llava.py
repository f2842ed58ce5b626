#!/usr/bin/env python3
"""Fault probes behind the limits of chip_smoke.py's LLaVA checks, on one
NVIDIA GPU:

    python3 scripts/chip_probe_llava.py

1. The attention forward at the causal prefill's shapes
   (chip_smoke.LLAVA_FLASH_CASES: [1|8, 32, 639, 128], a partial last Q
   tile), mean |diff| over all rows: the sound reading (kernel against its
   plain version) beside two faults, each read as the plain version with
   the fault against the plain version: the causal mask left out, and the
   last partial Q tile (rows 512..638) left unwritten (zeros).
2. ``nvcc -Xptxas -v`` of csrc/attention.cu: registers, spills and shared
   memory of each tile head dim (the 128 one runs the prefill).
3. LLaVA-1.5-7B (seeded, as chip_smoke phase 10) through forward_groups on
   chip_smoke.LLAVA_PLAIN_IMAGES images x LLAVA_TEXTS texts: max |delta
   log score| against the plain fp32 path for the bf16 kernel route, the
   bf16 no-kernel witness, and the kernel route with the prefill's causal
   mask left out (a fault); then the W8A8 trunk against the bf16 kernel
   route, sound and with each projection's activation codes at a quarter
   of their range (a fault: scale x4, about 5 bits).

Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def attention_faults(gpu):
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    rng = np.random.default_rng(10)
    for shape, causal, limit in cs.LLAVA_FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
        with torch.inference_mode():
            want = flash_attention_reference(q, k, v, causal).float()
            got = flash_attention(q, k, v, causal).float()
            open_mask = flash_attention_reference(q, k, v, False).float()
        dropped = want.clone()
        dropped[:, :, 512:] = 0  # the last Q tile of 128 rows
        read = {"sound": (got - want).abs().mean().item(),
                "no causal mask": (open_mask - want).abs().mean().item(),
                "last Q tile dropped": (dropped - want).abs().mean().item()}
        print(f"[probe] attention {'x'.join(map(str, shape))} causal: mean "
              f"|diff| {read} (limit {limit}) on {gpu}")


def ptxas_report():
    from clip_embeds_tpu_torch.ops import _build

    src = os.path.join(_build.CSRC_DIR, "attention.cu")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             "--resource-usage", "-c",
             "-o", os.path.join(tmp, "a.o"), src],
            capture_output=True, text=True)
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    print("[probe] ptxas -v csrc/attention.cu:\n" + "\n".join(lines))
    if proc.returncode:
        raise RuntimeError(proc.stderr)


def llava_faults(gpu):
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation
    from clip_embeds_tpu_torch.models import quant
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops import flash_attention as fa
    from clip_embeds_tpu_torch.scores.vqa_score import VQAScorer

    cfg = LlavaConfig()
    tok = cs.word_tokenizer(cs.LLAVA_SEED, cfg.llama.vocab_size)
    kw = dict(bos_token_id=1, pad_token_id=0)
    model = init_llava(cfg, seed=cs.LLAVA_SEED, device="cuda",
                       dtype=torch.bfloat16)
    ref = cs.cast_copy(model, torch.float32)
    ours, plain = VQAScorer(model, tok, **kw), VQAScorer(ref, tok, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "whatsup")
        cs.write_whatsup(root, 7)
        data, _ = load_annotation(root, "a")
        k = cs.LLAVA_PLAIN_IMAGES
        images = [os.path.join(root, d["image_path"][5:]) for d in data[:k]]
        texts = data[0]["caption_options"][:cs.LLAVA_TEXTS]
        batch = ours.pack_groups(images, [list(texts)] * k)[2]
        want = plain._group_scores(batch)
        read = {"kernel": cs.log_diff(ours._group_scores(batch), want)}
        with cs.plain_attention():
            read["witness"] = cs.log_diff(ours._group_scores(batch), want)
        real = fa.flash_attention

        def open_mask(q, k, v, causal=False):
            return real(q, k, v, False)

        open_mask.launches = 0  # _flash_forward counts on the module name
        with cs.patched(fa, "flash_attention", open_mask):
            read["no causal mask"] = cs.log_diff(ours._group_scores(batch),
                                                 want)
        print(f"[probe] LLaVA-1.5-7B forward_groups, {k} images x "
              f"{len(texts)} texts, max |d log score| against plain fp32: "
              f"{read} on {gpu}")
        del ref, plain
        bf16 = ours._group_scores(batch)
        qours = VQAScorer(quantize_llava_trunk(model), tok, **kw)
        read = {"int8": cs.log_diff(qours._group_scores(batch), bf16)}
        lin = quant.int8_linear
        with cs.patched(quant, "int8_linear",
                        lambda x, a, *rest: lin(x, 4 * a, *rest)):
            read["codes at 1/4 range"] = cs.log_diff(
                qours._group_scores(batch), bf16)
    print(f"[probe] LLaVA-1.5-7B W8A8 against bf16, max |d log score|: "
          f"{read} on {gpu}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_llava: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(f"[probe] {gpu}")
    attention_faults(gpu)
    ptxas_report()
    llava_faults(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
