#!/usr/bin/env python3
"""Readings and fault probes behind the limits of chip_smoke.py's phase 13
(the T5 and BLIP score families), on one NVIDIA GPU:

    python3 scripts/chip_probe_t5.py

1. The attention forward at chip_smoke.T5_FAMILY_FLASH_CASES (EVA-g at
   257 and 677 rows, head dim 88; BLIP ViT-L/16 at 197, head dim 64): mean
   |diff| of the kernel against its plain version beside two faults, each
   the plain version with the fault against the plain version: the logits
   scaled by 1/sqrt(128) in place of 1/sqrt(hd), and the last partial Q
   tile left unwritten (zeros).
2. int8_linear at chip_smoke.T5_INT8_LINEAR_CASES (check_int8_linear).
3. Phase 13 whole (check_t5_family) with every limit opened, so that it
   prints each sound reading: the paths against each other, bf16 against
   plain fp32 on the cut and the no-kernel witness, W8A8 against bf16,
   the ITM / ITC / reward differences, launches, pairs/s, peak memory.
4. Faults on CLIP-FlanT5-XXL and InstructBLIP-FlanT5-XXL cut to
   T5_CUT_LAYERS + T5_CUT_LAYERS T5 layers (full width, the towers whole),
   against plain fp32 on the same cut: the encoder's relative position
   bias dropped, the T5 attention scaled by d_kv^-1/2 (the towers'
   convention), InstructBLIP's Q-Former cross-attention skipped; W8A8 with
   every projection's codes at a quarter of their range, against the bf16
   cut. BLIP-2 ITM and ImageReward (seeded, full width): the bf16 route
   against fp32 with the text mask ignored.
5. W8A8 against bf16 at full depth (CLIP-FlanT5-XXL and
   InstructBLIP-FlanT5-XXL), sound and with the codes at a quarter of
   their range.

Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
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

    rng = np.random.default_rng(13)
    for shape, causal, limit in cs.T5_FAMILY_FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
        hd, n = shape[-1], shape[-2]
        with torch.inference_mode():
            want = flash_attention_reference(q, k, v, causal).float()
            got = flash_attention(q, k, v, causal).float()
            scaled = flash_attention_reference(
                q * (hd / 128) ** 0.5, k, v, causal).float()
        dropped = want.clone()
        dropped[:, :, (n // 128) * 128:] = 0
        read = {"sound": (got - want).abs().mean().item(),
                "logits at 1/sqrt(128)": (scaled - want).abs().mean().item(),
                "last Q tile dropped": (dropped - want).abs().mean().item()}
        print(f"[probe] attention {'x'.join(map(str, shape))}: mean |diff| "
              f"{read} (limit {limit}) on {gpu}")


@contextlib.contextmanager
def opened_limits():
    names = {"T5_PATHS_LOG_TOL": 1e9, "T5_FP32_LOG_TOL": 1e9,
             "T5_FP32_COS": -1.0, "T5_INT8_LOG_TOL": 1e9, "T5_INT8_COS": -1.0,
             "BLIP_ITM_TOL": 1e9, "BLIP_ITC_TOL": 1e9, "REWARD_TOL": 1e9}
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


def fixture(tmp):
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation

    root = os.path.join(tmp, "whatsup")
    cs.write_whatsup(root, 7)
    data, _ = load_annotation(root, "a")
    images = [os.path.join(root, d["image_path"][5:])
              for d in data[:cs.T5_PLAIN_IMAGES]]
    return images, data[0]["caption_options"][:cs.T5_TEXTS]


def t5_faults(gpu, images, texts):
    from clip_embeds_tpu_torch.core.factory import init_score_model
    from clip_embeds_tpu_torch.models import quant
    from clip_embeds_tpu_torch.models import t5 as t5mod
    from clip_embeds_tpu_torch.models.blip2 import QFormerLayer
    from clip_embeds_tpu_torch.models.clip_t5 import CLIPT5
    from clip_embeds_tpu_torch.models.instructblip import InstructBlipT5
    from clip_embeds_tpu_torch.models.quant import quantize_clip_t5_trunk
    from clip_embeds_tpu_torch.scores.build import default_model_config
    from clip_embeds_tpu_torch.scores.vqa_score import (
        InstructBlipVQAScorer, T5VQAScorer)

    cfg = cs.t5_cut(default_model_config("clip-flant5-xxl"),
                    cs.T5_CUT_LAYERS)
    tok = cs.t5_word_tokenizer(cs.T5_SEED, cfg.t5.vocab_size)
    with torch.device("meta"):
        model = CLIPT5(cfg)
    model = init_score_model(model, cs.T5_SEED, "cuda", torch.bfloat16)
    ib_cfg = cs.t5_cut(default_model_config("instructblip-flant5-xxl"),
                       cs.T5_CUT_LAYERS)
    qtok = cs.word_tokenizer(cs.T5_SEED, ib_cfg.qformer.vocab_size)
    with torch.device("meta"):
        ib = InstructBlipT5(ib_cfg)
    ib = init_score_model(ib, cs.T5_SEED + 1, "cuda", torch.bfloat16,
                          t5=model.t5)
    zero_bias = (lambda self, nq, nk, device, dtype: torch.zeros(
        1, self.cfg.num_heads, nq, nk, device=device, dtype=dtype))

    def scaled_q(m):
        scale = m.cfg.t5.d_kv ** -0.5
        return [a.q.register_forward_hook(lambda mod, inp, out: out * scale)
                for a in m.modules() if isinstance(a, t5mod.T5Attention)]

    for label, net, make in (
            ("clip-flant5", model, lambda m: T5VQAScorer(m, tok)),
            ("instructblip", ib,
             lambda m: InstructBlipVQAScorer(m, qtok, tok))):
        ref = cs.cast_copy(net, torch.float32)
        want = cs.answer_logits(make(ref), images, texts)
        del ref
        torch.cuda.empty_cache()
        ours = make(net)
        base = cs.answer_logits(ours, images, texts)
        read = {"kernel": cs.agreement(base, want)}
        with cs.plain_attention():
            read["witness"] = cs.agreement(cs.answer_logits(
                ours, images, texts), want)
        with cs.patched(t5mod.T5Attention, "position_bias", zero_bias):
            # the decoder's bias dropped too: both stacks own one
            read["no relative bias"] = cs.agreement(cs.answer_logits(
                ours, images, texts), want)
        hooks = scaled_q(net)
        read["attention at d_kv^-1/2"] = cs.agreement(cs.answer_logits(
            ours, images, texts), want)
        for h in hooks:
            h.remove()
        if label == "instructblip":
            real = QFormerLayer.forward
            with cs.patched(QFormerLayer, "forward",
                            lambda self, *a: _skip_cross(self, real, *a)):
                read["no cross-attention"] = cs.agreement(cs.answer_logits(
                    ours, images, texts), want)
        print(f"[probe] {label} cut to {cs.T5_CUT_LAYERS} + "
              f"{cs.T5_CUT_LAYERS} T5 layers against plain fp32: (max |d "
              f"log score|, min answer-row cosine) {read} on {gpu}")
        qnet = (quantize_clip_t5_trunk(net) if label == "clip-flant5"
                else None)
        if qnet is not None:
            qours = make(qnet)
            read = {"int8": cs.agreement(cs.answer_logits(
                qours, images, texts), base)}
            lin = quant.int8_linear
            with cs.patched(quant, "int8_linear",
                            lambda x, a, *rest: lin(x, 4 * a, *rest)):
                read["codes at 1/4 range"] = cs.agreement(cs.answer_logits(
                    qours, images, texts), base)
            print(f"[probe] {label} cut, W8A8 against bf16: {read} on {gpu}")
            del qours, qnet
        torch.cuda.empty_cache()


def _skip_cross(self, real, hidden, image_embeds, self_mask, ql):
    """QFormerLayer.forward with its cross-attention left out."""
    cross = self._modules.pop("crossattention", None)
    try:
        return real(self, hidden, image_embeds, self_mask, ql)
    finally:
        if cross is not None:
            self._modules["crossattention"] = cross


def blip_faults(gpu, images, texts):
    from clip_embeds_tpu_torch.core.factory import init_score_model
    from clip_embeds_tpu_torch.models.blip import ImageReward
    from clip_embeds_tpu_torch.models.blip2 import Blip2ITM
    from clip_embeds_tpu_torch.scores.build import default_model_config
    from clip_embeds_tpu_torch.scores.score import ITMScore, ImageRewardScore

    for name, cls, factory in (("blip2-itm", Blip2ITM, ITMScore),
                               ("image-reward-v1", ImageReward,
                                ImageRewardScore)):
        cfg = default_model_config(name)
        vocab = (cfg.qformer if name.startswith("blip2") else cfg.text
                 ).vocab_size
        tok = cs.word_tokenizer(cs.T5_SEED, vocab)
        with torch.device("meta"):
            src = cls(cfg)
        src = init_score_model(src, cs.T5_SEED + 2, "cuda", torch.float32)
        want = factory(src, tok)(list(images), list(texts))
        bf = cs.cast_copy(src, torch.bfloat16)
        got = factory(bf, tok)(list(images), list(texts))
        read = {"bf16": float(np.abs(got - want).max())}
        method = "itm_logits" if name.startswith("blip2") else "forward"
        real = getattr(bf, method)
        setattr(bf, method, lambda p, i, m=None: real(p, i, None))
        bad = factory(bf, tok)(list(images), list(texts))
        read["text mask ignored"] = float(np.abs(bad - want).max())
        print(f"[probe] {name} max |bf16 - fp32| {read}; fp32 range "
              f"{want.min():.4g}..{want.max():.4g} on {gpu}")
        del src, bf
        torch.cuda.empty_cache()


def int8_full_depth(gpu, images, texts):
    """W8A8 against bf16 at full depth, sound and with every projection's
    codes at a quarter of their range, for CLIP-FlanT5-XXL and
    InstructBLIP-FlanT5-XXL on one shared seeded trunk."""
    from clip_embeds_tpu_torch.core.factory import init_score_model
    from clip_embeds_tpu_torch.models import quant
    from clip_embeds_tpu_torch.models.clip_t5 import CLIPT5
    from clip_embeds_tpu_torch.models.instructblip import InstructBlipT5
    from clip_embeds_tpu_torch.models.quant import quantize_clip_t5_trunk
    from clip_embeds_tpu_torch.scores.build import default_model_config
    from clip_embeds_tpu_torch.scores.vqa_score import (
        InstructBlipVQAScorer, T5VQAScorer)

    cfg = default_model_config("clip-flant5-xxl")
    ib_cfg = default_model_config("instructblip-flant5-xxl")
    tok = cs.t5_word_tokenizer(cs.T5_SEED, cfg.t5.vocab_size)
    qtok = cs.word_tokenizer(cs.T5_SEED, ib_cfg.qformer.vocab_size)
    with torch.device("meta"):
        model, ib = CLIPT5(cfg), InstructBlipT5(ib_cfg)
    model = init_score_model(model, cs.T5_SEED, "cuda", torch.bfloat16)
    ib = init_score_model(ib, cs.T5_SEED + 1, "cuda", torch.bfloat16,
                          t5=model.t5)
    qmodel = quantize_clip_t5_trunk(model)
    qib = cs.model_view(ib, strict=False, quant_t5="dynamic")
    qib.t5 = qmodel.t5
    lin = quant.int8_linear
    for label, net, qnet, make in (
            ("clip-flant5", model, qmodel, lambda m: T5VQAScorer(m, tok)),
            ("instructblip", ib, qib,
             lambda m: InstructBlipVQAScorer(m, qtok, tok))):
        base = cs.answer_logits(make(net), images, texts)
        read = {"int8": cs.agreement(cs.answer_logits(
            make(qnet), images, texts), base)}
        with cs.patched(quant, "int8_linear",
                        lambda x, a, *rest: lin(x, 4 * a, *rest)):
            read["codes at 1/4 range"] = cs.agreement(cs.answer_logits(
                make(qnet), images, texts), base)
        print(f"[probe] {label} full depth, W8A8 against bf16: (max |d log "
              f"score|, min answer-row cosine) {read} on {gpu}")
    del model, ib, qmodel, qib
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_t5: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.gpu_line()
    print(f"[probe] {gpu}")
    from clip_embeds_tpu_torch.ops import _build

    _build.library()
    attention_faults(gpu)
    with torch.no_grad():
        cs.check_int8_linear(gpu, cs.T5_INT8_LINEAR_CASES, seed=13)
    with opened_limits():
        cs.check_t5_family(counters(), gpu)
    with tempfile.TemporaryDirectory() as tmp:
        images, texts = fixture(tmp)
        t5_faults(gpu, images, texts)
        blip_faults(gpu, images, texts)
        int8_full_depth(gpu, images, texts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
