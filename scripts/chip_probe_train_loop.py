#!/usr/bin/env python3
"""Fault probes behind the limits of chip_smoke.py's phase 15 (the rest of
the training loop), on one NVIDIA GPU:

    python3 scripts/chip_probe_train_loop.py [--phase]

ViT-L/14-336 (OpenAI config) with chip_smoke.py's seed-0 weights, on
phase 12's fixtures and phase 15's (val.tsv over 256 JPEGs, an ImageFolder
of 10 classes x 8, the fp32 classifier's 50 classes). For each reading of
phase 15 (b) (chip_smoke.loop_readings: the val features' least row
cosine, |delta clip_val_loss|, the classifier columns' least cosine, the
zero-shot logits' largest |delta|, the clear decisions) it prints the
sound eval passes of each block route against the plain fp32 path beside
these faults, each run on the bf16 composable model:

  a classifier without its per-class renormalisation;
  the eval with patch dropout left on (--force-patch-dropout 0.5, the
      towers run as in a train step);
  the ImageFolder's classes indexed one class off (column c built from
      class c + 1's name);
  the val loss at the logit scale's parameter instead of its exp;

and for phase 15 (a) a teacher whose output is not detached (its forward
under autograd, its parameters requiring grad): the teacher tensors that
get a gradient, and the student's gradient cosine against the sound step's.
``--phase`` runs chip_smoke.check_train_loop afterwards (phase 15 alone,
phase 6's rates not measured). Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def unnormalised_classifier(encode_texts, classnames, templates,
                            num_classes_per_batch=10):
    """build_zero_shot_classifier without the renormalisation of each
    class's mean embedding."""
    columns = []
    for start in range(0, len(classnames), num_classes_per_batch):
        chunk = classnames[start:start + num_classes_per_batch]
        emb = encode_texts([t.format(c=c) for c in chunk for t in templates])
        columns.append(emb.reshape(len(chunk), len(templates), -1).mean(1))
    return np.concatenate(columns).T


def print_readings(label, r):
    print(f"[probe] {label}: val cos image {r['val_image_cos']:.6f} text "
          f"{r['val_text_cos']:.6f}; |d clip_val_loss| "
          f"{r['val_loss_diff']:.4g}; classifier cos "
          f"{r['classifier_cos']:.6f}; zero-shot logits max |d| "
          f"{r['zs_logit_diff']:.4g}; clear decisions (agree, clear, "
          f"largest |d|): zero-shot {r['zs_decisions']}, i2t "
          f"{r['i2t_decisions']}, t2i {r['t2i_decisions']}")


def probe_evals(base, root, gpu):
    from clip_embeds_tpu_torch.cli import train as train_cli
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.evals import zero_shot

    cs.write_loop_fixtures(root)
    subset = cs.loop_reference_subset()
    args = train_cli.parse_args([
        "--model", cs.MODEL, "--batch-size", str(cs.TRAIN_BATCH),
        "--val-data", f"{root}/val.tsv", "--val-num-samples",
        str(cs.LOOP_VAL_SAMPLES), "--imagenet-val", f"{root}/inet"])
    t0 = time.perf_counter()
    want = cs.loop_eval_outputs(cs.route_model("composable", None), args,
                                subset)
    print(f"[probe] plain fp32 outputs in {time.perf_counter() - t0:.1f} s "
          f"on {gpu}")
    for route in cs.RECIPE_ROUTES:
        got = cs.loop_eval_outputs(cs.route_model(route), args, subset)
        print_readings(f"sound {route}", cs.loop_readings(got, want))
        if route == "composable":
            # the val loss at the logit scale's parameter, not its exp
            loss = train_cli.validation_metrics(
                got["img"], got["txt"], np.log(got["scale"]))
            sound = train_cli.validation_metrics(
                want["img"], want["txt"], want["scale"])
            print(f"[probe] fault: clip_val_loss at logit_scale, not "
                  f"exp(logit_scale): |d clip_val_loss| "
                  f"{abs(loss['clip_val_loss'] - sound['clip_val_loss']):.4g}"
                  f" ({loss['clip_val_loss']:.6f} vs "
                  f"{sound['clip_val_loss']:.6f})")
    model = cs.route_model("composable")
    with cs.patched(zero_shot, "build_zero_shot_classifier",
                    unnormalised_classifier):
        got = cs.loop_eval_outputs(model, args, subset)
    print_readings("fault: classifier not renormalised",
                   cs.loop_readings(got, want))
    shifted = (subset + 1) % 1000
    got = cs.loop_eval_outputs(model, args, shifted)
    print_readings("fault: classes indexed one off",
                   cs.loop_readings(got, want))
    dropped = create_model(cs.MODEL, pretrained="openai", seed=0,
                           dtype=torch.float32, device="cuda",
                           compute_dtype=torch.bfloat16,
                           force_patch_dropout=0.5, train=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    with cs.patched(dropped, "forward", functools.partial(
            dropped.forward, deterministic=False, generator=g)), \
            cs.patched(dropped, "encode_image", functools.partial(
                dropped.encode_image, deterministic=False, generator=g)):
        got = cs.loop_eval_outputs(dropped, args, subset)
    print_readings("fault: patch dropout 0.5 left on",
                   cs.loop_readings(got, want))


def probe_teacher(base, root, gpu):
    """The distillation step with the teacher under autograd."""
    from clip_embeds_tpu_torch.cli import train as train_cli
    from clip_embeds_tpu_torch.core.config import get_model_config

    tpath = os.path.join(root, "teacher.pt")
    cs.write_teacher(base, tpath)
    teacher = train_cli.build_teacher(
        train_cli.parse_args(["--model", cs.MODEL, "--distill-model",
                              cs.MODEL, "--distill-pretrained", tpath]),
        torch.device("cuda"), torch.bfloat16,
        get_model_config(cs.MODEL, "openai"))
    batch = cs.train_batch(cs.GRAD_BATCH, seed=1)
    model = cs.route_model("composable")
    sound, _ = cs.distill_grads(model, teacher, batch)
    teacher.requires_grad_(True)
    with cs.patched(torch, "no_grad", contextlib.nullcontext):
        faulty, _ = cs.distill_grads(model, teacher, batch)
    with_grad = sum(p.grad is not None for p in teacher.parameters())
    cos, worst, name = cs.grad_agreement(faulty, sound)
    print(f"[probe] fault: teacher not detached: {with_grad} of "
          f"{len(list(teacher.parameters()))} teacher tensors get a "
          f"gradient (sound: 0); the student's gradients vs the sound "
          f"step's cosine {cos:.6f}, least per tensor {worst:.6f} ({name}) "
          f"on {gpu}")
    os.remove(tpath)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8, fused_block_residuals)

    gpu = cs.gpu_line()
    print(f"[probe] {gpu}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    logging.getLogger().setLevel(logging.INFO)
    t0 = time.perf_counter()
    base = {k: v.detach().cpu() for k, v in
            cs.route_model("composable").state_dict().items()}
    print(f"[probe] seed-0 weights in {time.perf_counter() - t0:.1f} s")
    with cs.recipe_fixtures(base) as (root, _):
        probe_teacher(base, root, gpu)
        probe_evals(base, root, gpu)
        if "--phase" in sys.argv[1:]:
            counters = {"flash_attention": flash_attention,
                        "flash_attention_bwd": flash_attention_bwd,
                        "fused_block": fused_block,
                        "fused_block_residuals": fused_block_residuals,
                        "fused_block_int8": fused_block_int8}
            rates = {(r, cs.TRAIN_BATCH): float("nan")
                     for r in cs.ROUTES}
            # phase 15 writes its fixtures anew
            os.remove(os.path.join(root, "val.tsv"))
            for d in ("inet", "flickr"):
                shutil.rmtree(os.path.join(root, d))
            t0 = time.perf_counter()
            cs.check_train_loop(counters, base, rates, gpu, root)
            print(f"[phase 15] {time.perf_counter() - t0:.1f} s on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
