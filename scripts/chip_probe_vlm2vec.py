#!/usr/bin/env python3
"""Fault probes behind the limits of chip_smoke.py's VLM2Vec checks (phase
11), on one NVIDIA GPU, at LLaVA-1.5-7B's full width and depth (seeded as
chip_smoke phase 10):

    python3 scripts/chip_probe_vlm2vec.py

1. Embeddings of a mixed batch of the synthetic route at batch
   chip_smoke.V2V_BATCHES[0], least row cosine: the bf16 kernel route
   (flash_attention in the tower) and the bf16 no-kernel witness against
   the plain fp32 path; the mixed batch against its rows on their own
   paths; the W8A8 trunk against bf16. Beside each sound reading, faults
   read the same way: the imageless rows' image block left visible
   (image_valid all True), pooling one token past the last valid one, and
   the W8A8 codes at a quarter of their range (scale x4).
2. The LoRA adapters' gradients on a mixed batch of
   chip_smoke.V2V_GRAD_BATCH rows (chip_smoke.v2v_adapters: r16, alpha 64,
   b drawn off zero; chip_smoke.v2v_grads), of the contrastive loss at the
   recipe's temperature 0.02 and of a linear readout of the embeddings
   (T=None), through the whole 32-layer trunk and through its first
   chip_smoke.V2V_GRAD_LAYERS layers (full width): the bf16 materialized
   kernel route and its witness against the plain fp32 path (the
   side-path), cosine over all and least per tensor, beside the kernel
   route with the imageless rows' image block left visible (a fault); and
   the W8A8 side-path route against its witness, beside the same route with
   the dynamic scale's gradient (JAX's one term through the int8 base)
   dropped.

Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import gc
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def pool_past_last(model):
    """Llava.embed_mixed pooling one token past the last valid one (a
    fault)."""
    from clip_embeds_tpu_torch.models.clip import l2_normalize
    from clip_embeds_tpu_torch.models.llava import splice_positions

    def embed(ids, px, valid, mask):
        feats = model.encode_images(px)
        embeds = model.merge(ids, feats)
        _, is_image, gather, _ = splice_positions(ids, feats.shape[1])
        text = torch.gather(mask.int(), 1, gather)
        m = torch.where(is_image, valid[:, None].int(), text)
        pos = (torch.cumsum(m, 1) - 1).clamp_min(0)
        hidden = model.language_model.trunk(embeds, m.bool(), pos)
        idx = torch.arange(hidden.shape[1], device=hidden.device)[None]
        last = torch.where(m.bool(), idx, -1).amax(1)
        last = (last + 1).clamp_max(hidden.shape[1] - 1)
        return l2_normalize(hidden[torch.arange(hidden.shape[0]), last])

    return embed


def embedding_faults(model, qmodel, ref, gpu):
    from clip_embeds_tpu_torch.cli.train_vlm2vec import (
        _synthetic_mixed_batches, to_device)
    from clip_embeds_tpu_torch.models import quant

    b = cs.V2V_BATCHES[0]
    size = model.cfg.vision.image_size
    mix = next(_synthetic_mixed_batches(b, size, cs.V2V_SEED))
    on = to_device(mix, "cuda", torch.bfloat16)
    args = [on[k] for k in ("qry_ids", "qry_pixels", "qry_image_valid",
                            "qry_mask")]

    def cos(x, y):
        return float(cs.row_cos(x.float().cpu().numpy(),
                                y.float().cpu().numpy()).min())

    with torch.inference_mode():
        p32 = to_device(mix, "cuda", torch.float32)
        plain = ref.embed_mixed(*(p32[k] for k in (
            "qry_ids", "qry_pixels", "qry_image_valid", "qry_mask")))
        got = model.embed_mixed(*args)
        read = {"kernel vs plain": cos(got, plain)}
        with cs.plain_attention():
            read["witness vs plain"] = cos(model.embed_mixed(*args), plain)
        visible = model.embed_mixed(args[0], args[1],
                                    torch.ones_like(args[2]), args[3])
        read["image block visible vs plain"] = cos(visible, plain)
        read["pool+1 vs plain"] = cos(pool_past_last(model)(*args), plain)
        split = []
        for i in range(b):
            n = int(mix["qry_mask"][i].sum())
            if mix["qry_image_valid"][i]:
                split.append(model.embed_last_token(
                    args[0][i:i + 1], args[1][i:i + 1], args[3][i:i + 1]))
            else:
                split.append(model.embed_last_token(
                    args[0][i:i + 1, :n], None, args[3][i:i + 1, :n]))
        split = torch.cat(split)
        read["mixed vs split"] = cos(got, split)
        read["image block visible vs split"] = cos(visible, split)
        print(f"[probe] VLM2Vec embed_mixed b{b}, least row cosine: {read} "
              f"on {gpu}")
        read = {"int8 vs bf16": cos(qmodel.embed_mixed(*args), got)}
        lin = quant.int8_linear
        with cs.patched(quant, "int8_linear",
                        lambda x, a, *rest: lin(x, 4 * a, *rest)):
            read["codes at 1/4 range"] = cos(qmodel.embed_mixed(*args), got)
    print(f"[probe] VLM2Vec W8A8 against bf16, least row cosine: {read} on "
          f"{gpu}")


def gradient_faults(model, qmodel, gpu):
    from clip_embeds_tpu_torch.cli.train_vlm2vec import (
        _synthetic_mixed_batches)
    from clip_embeds_tpu_torch.models import llava as llava_mod

    alpha, bf16, f32 = cs.V2V_ALPHA, torch.bfloat16, torch.float32
    real = llava_mod.Llava.embed_mixed

    def visible(self, ids, px, valid, mask):
        return real(self, ids, px, torch.ones_like(valid), mask)

    real_amax = torch.Tensor.amax

    def no_scale_grad(self, *a, **kw):
        return real_amax(self.detach(), *a, **kw)

    lora = dict(lora_rank=cs.V2V_RANK, lora_alpha=float(alpha))
    for layers in (model.cfg.llama.num_layers, cs.V2V_GRAD_LAYERS):
        cut = cs.cut_config(model.cfg, layers)
        # remat: memory only, at full depth
        small = cs.model_view(model, cut, remat=True)
        ref = cs.v2v_cast(small, f32, remat=True, **lora)
        qsmall = cs.model_view(qmodel, cut, quant_llm="dynamic", remat=True,
                               **lora)
        batch = next(_synthetic_mixed_batches(
            cs.V2V_GRAD_BATCH, cut.vision.image_size, cs.V2V_SEED))
        tree = cs.v2v_adapters(small)
        read, want = {}, {}
        for t in (0.02, None):  # None: a linear readout of the embeddings
            want[t] = cs.v2v_grads(ref, tree, batch, alpha, f32, t)
            read[f"kernel T={t}"] = cs.grad_agreement(
                cs.v2v_grads(small, tree, batch, alpha, bf16, t), want[t])
            with cs.plain_attention():
                read[f"witness T={t}"] = cs.grad_agreement(
                    cs.v2v_grads(small, tree, batch, alpha, bf16, t),
                    want[t])
        with cs.patched(llava_mod.Llava, "embed_mixed", visible):
            read["image block visible T=0.02"] = cs.grad_agreement(
                cs.v2v_grads(small, tree, batch, alpha, bf16, 0.02),
                want[0.02])
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        got = cs.v2v_grads(qsmall, tree, batch, alpha, bf16, 0.02)
        with cs.plain_attention():
            read["int8 kernel vs witness T=0.02"] = cs.grad_agreement(
                cs.v2v_grads(qsmall, tree, batch, alpha, bf16, 0.02), got)
        with cs.patched(torch.Tensor, "amax", no_scale_grad):
            read["int8 scale's gradient dropped vs kernel T=0.02"] = \
                cs.grad_agreement(cs.v2v_grads(qsmall, tree, batch, alpha,
                                               bf16, 0.02), got)
        print(f"[probe] VLM2Vec adapter gradients at b{cs.V2V_GRAD_BATCH}, "
              f"trunk {layers} layers, against plain fp32 (int8: against "
              f"its kernel route or witness; cosine over all, least per "
              f"tensor, its name): {read} on {gpu}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_vlm2vec: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk

    gpu = cs.gpu_line()
    print(f"[probe] {gpu}")
    model = init_llava(LlavaConfig(), seed=cs.LLAVA_SEED, device="cuda",
                       dtype=torch.bfloat16)
    qmodel = quantize_llava_trunk(model)
    ref = cs.v2v_cast(model, torch.float32)
    embedding_faults(model, qmodel, ref, gpu)
    del ref
    torch.cuda.empty_cache()
    gradient_faults(model, qmodel, gpu)
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())
