#!/usr/bin/env python3
"""Smoke run of the PyTorch port (clip_embeds_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card's name and power limit; TF32 off for the fp32 references;
  2. build the CUDA kernels from clip_embeds_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version, bf16 (int8 weights
     and static scales for fused_block_int8), at the main paths' shapes,
     with the tolerance stated; for the attention kernels also the TFLOP/s
     achieved on the counted work (4 and 10 N^2 D per head) and the share
     of the bound; then the bf16 GEMM behind fused_block and
     fused_block_residuals alone ([gemm] lines), each projection of a
     block at the main paths' rows against its plain version, with its
     TFLOP/s, share of the bound and torch.nn.functional.linear's time at
     the same shape (the yardstick, timed only); and the int8 GEMM behind
     fused_block_int8 alone ([gemm_s8] lines) the same way, against
     gemm_s8_reference, with TOP/s and torch._int_mm's time; each with
     the SigLIP SO400M shapes too (head dim 72, MLP width 4304, tanh-GELU,
     eps 1e-6: the blocks at 4x736x1152 and 8x64x1152, the attention
     forward at 4x16x729x72 beside scaled_dot_product_attention, the fc
     and fc2 GEMMs at 23552 rows), within limits set by fault probes
     (scripts/chip_probe_siglip.py); and the attention forward at
     LLaVA-1.5-7B's causal prefill, [1|8, 32, 639, 128] (a partial last Q
     tile), beside scaled_dot_product_attention, its limit from
     scripts/chip_probe_llava.py; and int8_linear, QuantLinear's card
     route (cet_quantize_s8 + cet_gemm_s8), at the W8A8 trunk's
     projections ([int8_linear] lines: 639 and 5112 rows, 4096 -> 4096,
     4096 -> 11008, 11008 -> 4096, dynamic and static scales) bit-equal
     to qdot rounded to bf16, with TOP/s and torch._int_mm's time;
  4. the main paths: ViT-L/14-336 (OpenAI config, seeded random weights,
     all 24 + 12 layers) serves 3 image and 3 text requests of 8 through
     embed_image_batches / embed_text_batches, the CLI's helpers: first in
     bf16, then with --int8 (W8A8, int8 weights from the fp32 weights,
     static scales calibrated on the first request). Each path's kernel
     launch counts are reset before it and must rise; the embeddings must
     be finite, unit-norm, and agree with the plain fp32 path (bf16) or
     with the bf16 embeddings (int8, the JAX package's 0.99 gate);
  5. timings with CUDA events: img/s per image route, texts/s (bf16 and
     int8), and each kernel against its plain version, its bound (the
     larger of its bytes over 3.35 TB/s and its operations over 989 bf16
     TFLOP/s / 1,979 int8 TOP/s) and, where one PyTorch call computes the
     same function, that call (scaled_dot_product_attention, timed only);
  6. training at full width and depth: ViT-L/14-336 (OpenAI config,
     seeded random fp32 master weights, bf16 compute, synthetic batches)
     through the training CLI's main(argv), 3 steps at batch 32 on each
     block route (composable, --fused-train-blocks, --fused-train-blocks
     --fused-train-backward residual), each with the launch counts set to 0
     just before and held to the counts the route gives per step; finite
     losses and moved parameters; at batch 8 each route's gradients
     against the plain fp32 composable path (one cosine over all, held
     also to a witness, the bf16 composable model with no kernel; and the
     least per tensor); train samples/s at batch 32 and 64 with peak
     device memory;
  7. (run after 5, before 6) the eval and host-pipeline entry points at
     full width and depth, on fixtures written from the seed into a
     temporary directory (640x480 JPEGs of smooth fields with mild noise):
     (a) cli/eval.py main, --scorer clip in bf16 on the card, on a
     What'sUp-A fixture of 102 object pairs x 4 prepositions (--dataset a
     and a4) and an MMVP-VLM fixture of 135 pairs (--dataset mmvpvlm),
     each with its exact fused_block launches and samples/s; the scorer's
     image and text embeddings against the plain fp32 composable path
     (least row cosine >= 0.99), and its decisions against that path's on
     every sample whose fp32 margin exceeds twice the largest score
     difference; (b) cli/embed.py main --workers <cores> on 1024 JPEGs,
     bf16 (composable + flash) and --int8 (fused_block_int8), each with its
     exact launches, end-to-end img/s beside phase 5's device-only img/s
     of the same route, on the decoder the card's machine provides
     (EXPECTED_DECODER);
  8. (run after 7 (a), on its fixtures and phase 4's models) the PACL/SPARC
     heads: (a) cli/train_pacl.py main at batch 64 for 3 steps (synthetic
     batches, fp32 head) on the frozen tower's kernel routes, --objective
     pacl --frozen-tower fused (fused_block) and int8 (fused_block_int8),
     --objective sparc --frozen-tower fused, each with its exact launches,
     the gate's patch-token cosine against the composable fp32 tower
     (>= 0.999), finite losses, samples/s, peak device memory, and a saved
     .npz head in the JAX layout whose every tensor moved; (b) cli/eval.py
     main with those heads in bf16 (composable towers: the flash kernel in
     the image tower), --scorer pacl on What'sUp-A and MMVP-VLM and
     --scorer sparc --sparc-local on the first 128 What'sUp-A samples,
     with exact launches and samples/s; the scorers' image-side head
     outputs (bf16 towers through the flash kernel, exact launches)
     against the plain fp32 path (least row cosine >= 0.99) and their
     clear decisions against that path's, as in 7 (a);
  9. (run after 8, on 7's fixtures) SigLIP ViT-SO400M-14-SigLIP-384 at
     full width and depth (27 + 27 layers, seeded random weights): (a)
     fused_encode_image_siglip at b32, fused_encode_text_siglip at b256,
     their int8 twins (static scales calibrated on the first 8) and the
     composable image tower (flash_attention), each with its launches
     reset before it and held exactly, embeddings finite and unit-norm,
     bf16 against the plain fp32 path and int8 against bf16 (least row
     cosine >= 0.99), img/s and texts/s by CUDA events and peak memory;
     (b) SiglipScorer in bf16 on 7's What'sUp-A fixture through
     evals/whatsup.py eval_whatsup, with a sentencepiece vocabulary
     written from the seed: exact fused_block launches, samples/s,
     image embeddings against plain fp32 and clear decisions as in 7
     (a); (c) (with phase 6) cli/train.py main --siglip, 3 steps at b32
     on the composable ViT-L/14-336 route with its exact launches,
     finite losses and moved parameters.

 10. (run last) LLaVA-1.5-7B VQAScore at full width and depth (ViT-L/14-336
     read at layer -2, 23 blocks; the 2-layer projector; the 32-layer
     Vicuna-7B trunk, 32 heads of 128; seeded random weights built on the
     card by init_llava; a seeded word-hash tokenizer passed in, BOS 1,
     pad 0): (a) the VQAScore Score's pair path, forward_image_texts and
     forward_groups on 8 What'sUp-A images x 4 texts, in bf16 and with the
     W8A8 trunk (quantize_llava_trunk, dynamic QuantLinear), each with its
     launches held exactly (flash_attention: 23 a pair-path chunk, 23 + 32
     a prefill; int8_linear: 7 a trunk layer a pass), scores finite in
     (0, 1], the paths against each other, bf16 against the plain fp32
     path beside the no-kernel witness (|delta log score| and the answer
     rows' logits cosine), int8 against bf16, pairs/s, prefill ms at k = 1
     and 8 and peak memory (int8 below bf16); (b) evals/whatsup.py
     eval_whatsup on the first 64 What'sUp-A samples through
     forward_groups (a GroupAdapter here), samples/s, exact launches, and
     the clear decisions of the first 16 against the plain fp32 path's;
     (c) a score bundle in the JAX layout at full width with the trunk and
     the tower cut to 2 layers, loaded by scores.registry.get_score_model
     in bf16 and with quant=True, through evals/benchmarks.py
     run_benchmark on a 16-sample Winoground fixture, exact launches and
     metrics in [0, 1].

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

MODEL = "ViT-L-14-336"
REQUESTS, REQUEST_SIZE = 3, 8
SOT, EOT = 49406, 49407
TRAIN_STEPS, TRAIN_BATCH, GRAD_BATCH = 3, 32, 8
# the training CLI's block routes: flags, and the launches of each kernel
# wrapper per step (24 vision + 12 text blocks; the 77-token text tower
# takes plain attention, the 577-token vision tower the flash kernels)
ROUTES = {
    "composable": ([], {"flash_attention": 24, "flash_attention_bwd": 24}),
    "fused-train": (["--fused-train-blocks"],
                    {"fused_block": 36, "flash_attention": 24,
                     "flash_attention_bwd": 24}),
    "fused-train-res": (["--fused-train-blocks", "--fused-train-backward",
                         "residual"],
                        {"fused_block": 36, "fused_block_residuals": 36,
                         "flash_attention_bwd": 24}),
}
# gradient agreement with the plain fp32 composable path at batch 8
# (readings on the H100, scripts/chip_probe_train.py, PERF.md). The sound
# routes read 0.99455-0.99476 over all and >= 0.990 per tensor, the
# witness (bf16, no kernel) 0.99452: bf16 compute alone costs that much.
# The attention backward without its delta term reads 0.9930 / 0.9932
# over all (0.0013-0.0015 under the witness) and 0.786 on one vision
# in_proj bias; m1 stored after the activation (residual route) 0.916 over
# all and 0.847 per tensor. Limits: over all, 0.99 and at most
# GRAD_COS_BELOW_WITNESS under the witness; per tensor, 0.95
GRAD_COS_MIN, GRAD_TENSOR_COS_MIN, GRAD_COS_BELOW_WITNESS = 0.99, 0.95, 5e-4
# phase 3, blocks: (b, n, d, heads, kv_valid, causal) and the limits on the
# mean |kernel - plain| of fused_block, fused_block_residuals (the worst of
# its five outputs) and fused_block_int8 (None: not on an int8 path). The
# serving shapes (the image tower at batch 4, padded to 592 rows; texts at
# 8, padded to 80) and the training shapes (batch 32, unpadded: the vision
# and text blocks of the fused training routes). Each limit is about 2-5x
# the sound reading on the H100 (bf16 0.0013 / 0.0005 at either batch,
# int8 0.0076 / 0.0004), far under a dropped bias (>= 0.26), m1 stored
# after the activation (>= 0.34) and two swapped int8 act scales (0.020 /
# 0.015)
BLOCK_CASES = (
    ((4, 592, 1024, 16, 577, False), 0.004, 0.004, 0.012),
    ((8, 80, 768, 12, 77, True), 0.002, 0.002, 0.002),
    ((32, 577, 1024, 16, 577, False), 0.004, 0.004, None),
    ((32, 77, 768, 12, 77, True), 0.002, 0.002, None),
)
# phase 3, attention: [B, H, N, D], causal, and the limit on the mean
# |kernel - plain| of the backward's worst output: 90-230x the sound
# reading on the H100 (2.1e-7 / 4e-8 causal), far under a dropped delta
# term (0.0062 / 0.079), one Q tile left out of dK and dV (0.017 / 0.055)
# and a causal mask left out (0.17). 32x16x577x64 is the vision tower's
# attention in a b32 train step
FLASH_CASES = (
    ((4, 16, 577, 64), False, 2e-5),
    ((32, 16, 577, 64), False, 2e-5),
    ((2, 12, 77, 64), True, 1e-5),
)
# phase 3, SigLIP SO400M (head dim 72, MLP width 4304, tanh-GELU, eps
# 1e-6): fused_block and fused_block_int8 at the image block of a b4
# request (736 rows, kv_valid 729) and the text block of a b8 one (64
# rows, bidirectional), limits on the mean |kernel - plain| (fused_block,
# none, fused_block_int8); and the attention forward at the image tower's
# 4x16x729x72 with its limit. The limits sit between the sound readings
# and the two faults of an odd head dim, the logits scaled by 1/sqrt(128)
# and the tile's padded columns read from memory instead of zero-filled
# (scripts/chip_probe_siglip.py; PERF.md)
SIGLIP_MLP, SIGLIP_EPS = 4304, 1e-6
# (readings on the H100, mean |diff|: sound / logits at 1/sqrt(128) /
# padded columns read: fused_block 0.00128 / 0.0157 / 0.0538 and 0.00094 /
# 0.0377 / 0.128; fused_block_int8 0.0077 / 0.0222 / 0.0565 and 0.00013 /
# 0.0406 / 0.129; attention 6.1e-5 / 0.0138 / 0.0486). The int8 image
# block's max limit is 0.25: a code flip's run reached 0.156 there
SIGLIP_BLOCK_CASES = (
    ((4, 736, 1152, 16, 729, False), 0.004, None, 0.012),
    ((8, 64, 1152, 16, 64, False), 0.004, None, 0.002),
)
SIGLIP_INT8_MAX_DIFF = 0.25
SIGLIP_FLASH_CASES = (((4, 16, 729, 72), False, 1e-3),)
# phase 3, LLaVA-1.5-7B's causal prefill at head dim 128 (32 heads, F =
# 63 + 576 = 639 rows: a partial last Q tile) at k = 1 and 8 images, and
# the limit on the mean |kernel - plain|
LLAVA_FLASH_CASES = (((1, 32, 639, 128), True, 1e-3),
                     ((8, 32, 639, 128), True, 1e-3))
# phase 3, the bf16 GEMM (cet_gemm) alone: (name, M, N, K, epilogue) for
# each projection of a block at the b32 train step's vision rows (18464 =
# 32 x 577, d 1024), the image serving rows (2368 = 4 x 592) and
# fused_encode_text's b256 rows (20480 = 256 x 80, d 768); epilogues as
# gemm_call names them. Limits on |kernel - gemm_reference|: the fp32 sums
# differ in order only, so outputs (|out| < 16) round apart by a bf16 step,
# rarely (two where the residual rounds again): max 0.125; mean 1e-3, far
# under a dropped bias (~0.4: biases of std 0.5)
GEMM_CASES = tuple(
    (f"{name} {m}x{n}x{k}", m, n, k, epilogue, "quick")
    for m, d in ((18464, 1024), (2368, 1024), (20480, 768))
    for name, n, k, epilogue in (
        ("qkv", 3 * d, d, "bias"), ("out", d, d, "residual"),
        ("fc", 4 * d, d, "act"), ("fc+pre", 4 * d, d, "act_pre"),
        ("proj", d, 4 * d, "residual"))) + (
    # SigLIP SO400M's fc (N = 4304, tanh) and fc2 (K = 4304) at the b32
    # image call's rows (23552 = 32 x 736)
    ("siglip fc 23552x4304x1152", 23552, 4304, 1152, "act", "tanh"),
    ("siglip proj 23552x1152x4304", 23552, 1152, 4304, "residual", "tanh"))
GEMM_MAX_DIFF, GEMM_MEAN_DIFF = 0.125, 1e-3
# phase 3, the int8 GEMM (cet_gemm_s8) alone: (name, M, N, K, epilogue,
# act scale index) for each projection of an int8 block at the b32 image
# rows (18944 = 32 x 592, d 1024), the b4 image request's (2368),
# fused_encode_text_int8's b256 rows (20480 = 256 x 80, d 768) and the
# CLI's b8 text request's (640). Limits against gemm_s8_reference: bf16 and
# residual outputs bit-equal (exact int32 sums, the same unfused fp32
# steps); int8 codes within one of it, and apart in at most GEMM_S8_FLIPS
# of the entries (the activation's exp and division round apart from
# torch's, which moves a code at a .5 boundary)
GEMM_S8_CASES = tuple(
    (f"{name} {m}x{n}x{k}", m, n, k, epilogue, a_idx, "quick")
    for m, d in ((18944, 1024), (2368, 1024), (20480, 768), (640, 768))
    for name, n, k, epilogue, a_idx in (
        ("qkv", 3 * d, d, "bf16", 0), ("out", d, d, "residual", 1),
        ("fc", 4 * d, d, "act_q8", 2), ("proj", d, 4 * d, "residual", 3))
) + (("siglip fc 23552x4304x1152", 23552, 4304, 1152, "act_q8", 2, "tanh"),
     ("siglip proj 23552x1152x4304", 23552, 1152, 4304, "residual", 3,
      "tanh"))
GEMM_S8_FLIPS = 1e-4
# the act scales of the int8 GEMM's inputs: a[2] * s gives sums of std
# ~1.6, and a[3] spreads act(v) over the int8 codes
GEMM_S8_ACT_SCALES = (0.021, 0.034, 0.027, 0.0315)
# phase 3, int8_linear (QuantLinear's card route: cet_quantize_s8, then
# cet_gemm_s8 with the bf16 epilogue and no bias) at the W8A8 trunk's
# projections, (M, N, K): the prefill's rows at k = 1 and 8 images (639
# and 5112 = 8 x 639, a partial last M tile) through q/k/v/o (4096 ->
# 4096), gate/up (4096 -> 11008) and down (11008 -> 4096), in the dynamic
# mode (the scale from the input's abs-max) and the static one (a
# calibrated scale at INT8_LINEAR_STATIC of it, so codes clip). Held
# bit-equal to qdot's exact product rounded to bf16
INT8_LINEAR_CASES = tuple((m, n, k) for m in (639, 5112)
                          for n, k in ((4096, 4096), (11008, 4096),
                                       (4096, 11008)))
INT8_LINEAR_STATIC = 0.5
# phase 7: the image decoder the card's machine gives the port. It has g++
# and PIL but not the libjpeg / libpng / libwebp headers, so the native
# library does not build there and images decode with PIL (probe on NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md). Held exactly, so a build that starts
# or stops working shows here.
EXPECTED_DECODER = "pil"
# What'sUp subset A's size, MMVP-VLM's (9 categories x 15 pairs), the
# end-to-end image count and the fixtures' photo size (h, w)
WHATSUP_PAIRS, MMVP_PAIRS, E2E_IMAGES, PHOTO = 102, 135, 1024, (480, 640)
EVAL_BATCH, E2E_BATCH = 64, 32
# the part of each fixture on which decisions are held to the fp32 path's
AGREE_SAMPLES, AGREE_PAIRS = 128, 45
WHATSUP_KEYS = ("left", "right", "on", "under")
OPPOSITE = {"left": "right", "right": "left", "on": "under", "under": "on"}
OBJECTS = ("mug", "book", "cup", "bowl", "can", "box", "plate", "lamp",
           "phone", "shoe", "ball", "vase", "key", "pen", "clock", "hat",
           "bottle")
# phase 8: the PACL/SPARC head trainer (cli/train_pacl.py) at batch 64 for
# 3 steps on each frozen-tower route, and the eval CLI's PACL and SPARC
# scorers on phase 7's fixtures (SPARC, one tower call a sample, on the
# first HEAD_EVAL_SAMPLES What'sUp-A samples)
HEAD_STEPS, HEAD_BATCH, HEAD_EVAL_SAMPLES = 3, 64, 128
HEAD_ROUTES = {"pacl fused": ("pacl", "fused"), "pacl int8": ("pacl", "int8"),
               "sparc fused": ("sparc", "fused")}
# the limit on the kernel routes' first-batch patch-token cosine against the
# composable fp32 tower, held here apart from the trainer's own gate
# (train_pacl.py GATE_MIN_COS), which must not drift below it
HEAD_GATE_COS = 0.999
# phase 9: SigLIP ViT-SO400M-14-SigLIP-384 at full width and depth (27 + 27
# layers, seeded random weights): images at b32, texts at b256 (64
# tokens), the int8 towers calibrated on the first SIGLIP_CALIB of each;
# the scorer on phase 7's What'sUp-A fixture through a sentencepiece
# vocabulary written from the seed; and the training CLI's --siglip on
# phase 6's composable ViT-L/14-336 route
SIGLIP_MODEL = "ViT-SO400M-14-SigLIP-384"
SIGLIP_IMAGES, SIGLIP_TEXTS, SIGLIP_CALIB = 32, 256, 8
SIGLIP_TRAIN_ROUTE = {"composable --siglip": (
    ["--siglip"], ROUTES["composable"][1])}
# phase 10: LLaVA-1.5-7B VQAScore at full width and depth (ViT-L/14-336 to
# layer -2, the 2-layer projector, the 32-layer Vicuna-7B trunk; seeded
# random weights) through the three VQAScorer paths on LLAVA_GROUP images
# x LLAVA_TEXTS texts, bf16 and W8A8; What'sUp-A's first LLAVA_WHATSUP
# samples through forward_groups, decisions against the plain fp32 path on
# the first LLAVA_AGREE; a score bundle cut to 2 + 2 layers through the
# registry and run_benchmark on a LLAVA_WINO-sample Winoground fixture
LLAVA_SEED, LLAVA_GROUP, LLAVA_TEXTS = 10, 8, 4
# calls a path is timed over: the paths run host code between launches,
# and one call's time spreads up to 1.8x from one machine to the next
LLAVA_TIME_ITERS, LLAVA_PREFILL_ITERS = 5, 10
LLAVA_WHATSUP, LLAVA_AGREE, LLAVA_WINO, LLAVA_PLAIN_IMAGES = 64, 16, 16, 2
# limits on |delta log score| and the least cosine of the answer
# positions' logits rows. Readings on the H100 (scripts/chip_probe_llava.py
# and this phase; PERF.md): the bf16 paths against the k-group path 0.040
# (pair, plain attention in the trunk) and 0.050 (per-image); bf16 against
# plain fp32 0.068 and cosine 0.99900, the no-kernel witness 0.033 and
# 0.99898, the prefill without its causal mask 0.448; W8A8 against bf16
# 0.23-0.53 and cosine 0.973, with every projection's codes at a quarter
# of their range 1.63
LLAVA_PATHS_LOG_TOL = 0.2      # the three bf16 paths against each other
LLAVA_FP32_LOG_TOL = 0.2       # bf16 kernel route against plain fp32
LLAVA_FP32_COS = 0.998
LLAVA_INT8_LOG_TOL = 1.0       # W8A8 against bf16
LLAVA_INT8_COS = 0.95
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops=0.0, int8_ops=0.0, nbytes=0.0):
    """The least time the card could take: the larger of the operations
    over their type's peak and the bytes over the memory rate; and which
    of the two bounds it."""
    t_ops = flops / PEAK_BF16 + int8_ops / PEAK_INT8
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_pairs(n, causal):
    """(query, key) pairs attention computes: N^2, or N(N+1)/2 causal."""
    return n * (n + 1) // 2 if causal else n * n


def block_cost(b, n, d, mlp, heads, kv, causal, extra_out=0, int8=False):
    """Operations and bytes of one block: the four projections over all n
    rows, attention over the kept (query, key) pairs; x, the weights and
    the biases read once, y (and ``extra_out`` more values per row)
    written once."""
    proj = 2 * b * n * (4 * d * d + 2 * d * mlp)
    pairs = (attention_pairs(kv, True) + (n - kv) * kv if causal
             else n * kv)
    attn = 4 * b * heads * pairs * (d // heads)
    vectors = 3 * d + d + mlp + d  # biases (and int8 scales), per output
    weights = 4 * d * d + 2 * d * mlp
    wbytes = (weights + vectors * 8 + 16 if int8  # int8, fp32 scale + bias
              else weights * 2 + vectors * 2)
    nbytes = 2 * b * n * d * 2 + wbytes + 4 * d * 2 + 2 * b * n * extra_out
    if int8:
        return bound_ms(flops=attn, int8_ops=proj, nbytes=nbytes)
    return bound_ms(flops=proj + attn, nbytes=nbytes)


def block_inputs(rng, b, n, d, mlp, bias_std=0.5):
    """fused_block inputs at trained-like scales, bf16 on the card. The
    biases are large (std 0.5) so that a kernel which drops one moves the
    mean |diff| far past the limits below."""
    def t(*shape, std=1.0, mean=0.0):
        a = mean + std * rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to("cuda", torch.bfloat16)

    ln = lambda: torch.stack([t(d, std=0.1, mean=1.0), t(d, std=0.1)])
    return (t(b, n, d), t(3 * d, d, std=d ** -0.5), t(3 * d, std=bias_std),
            t(d, d, std=0.02), t(d, std=bias_std),
            t(mlp, d, std=(2 * d) ** -0.5), t(mlp, std=bias_std),
            t(d, mlp, std=0.02), t(d, std=bias_std), ln(), ln())


def int8_block_inputs(args, heads, kv, causal, act="quick", eps=1e-5):
    """fused_block_int8 inputs from fused_block's: the weights quantised by
    the port's quantize_weight, the static scales calibrated by a dynamic
    pass over the same x of a quantised ResidualAttentionBlock (QuickGELU)
    or, for act "tanh", a quantised SiglipBlock (bidirectional)."""
    from clip_embeds_tpu_torch.models.layers import ResidualAttentionBlock
    from clip_embeds_tpu_torch.models.quant import (
        calibrate_act_scales, quantize_linears, quantize_state_dict)
    from clip_embeds_tpu_torch.models.serving import (
        INT8_BLOCK_ARGS, int8_block_args, siglip_int8_block_args)
    from clip_embeds_tpu_torch.models.siglip import SiglipBlock

    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = args
    d, mlp = x.shape[-1], w1.shape[0]
    if act == "tanh":
        sd = {"ln_1.weight": ln1[0], "ln_1.bias": ln1[1],
              "in_proj.weight": wqkv, "in_proj.bias": bqkv,
              "out_proj.weight": wo, "out_proj.bias": bo,
              "ln_2.weight": ln2[0], "ln_2.bias": ln2[1],
              "fc1.weight": w1, "fc1.bias": b1, "fc2.weight": w2,
              "fc2.bias": b2}
        with torch.device("meta"):
            block = SiglipBlock(d, heads, mlp, eps, quant="dynamic")
        block.load_state_dict(quantize_linears(sd, [
            (f"{k}.weight", k) for k in ("in_proj", "out_proj", "fc1",
                                         "fc2")]), assign=True)
        calibrate_act_scales(block, [x[:, :kv]])
        p = siglip_int8_block_args(block)
        return (x, *(p[k] for k in INT8_BLOCK_ARGS))
    sd = {"ln_1.weight": ln1[0], "ln_1.bias": ln1[1],
          "attn.in_proj_weight": wqkv, "attn.in_proj_bias": bqkv,
          "attn.out_proj.weight": wo, "attn.out_proj.bias": bo,
          "ln_2.weight": ln2[0], "ln_2.bias": ln2[1],
          "mlp.c_fc.weight": w1, "mlp.c_fc.bias": b1,
          "mlp.c_proj.weight": w2, "mlp.c_proj.bias": b2}
    with torch.device("meta"):
        block = ResidualAttentionBlock(d, heads, mlp / d, quick_gelu=True,
                                       quant="dynamic")
    block.load_state_dict(quantize_state_dict(sd), assign=True)
    calibrate_act_scales(block, [(x[:, :kv], causal)])
    p = int8_block_args(block)
    return (x, *(p[k] for k in INT8_BLOCK_ARGS))


def block_kernel_cases(rng, cases, mlp_of, act, eps, label,
                       max_tol8=0.125):
    """Phase 3's block cases: (name, kernel call, plain call, max tol, rows
    compared, mean tol, bound, library, counted FLOPs) for fused_block,
    fused_block_residuals (where its limit is not None) and
    fused_block_int8 (likewise; max limit ``max_tol8``) at each ((b, n,
    d, heads, kv_valid, causal), limits) of ``cases``, with the MLP width
    ``mlp_of(d)``, activation ``act`` and LayerNorm eps ``eps``."""
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8, fused_block_int8_reference,
        fused_block_reference, fused_block_residuals,
        fused_block_residuals_reference)

    out = []
    # Max: bf16 outputs below 8, where a rounding flip is <= 1/32; an int8
    # code that the two sides round apart moves its projection by
    # a * max|w| and later codes with it.
    for (b, n, d, heads, kv, causal), mean_tol, mean_tol_res, mean_tol8 \
            in cases:
        mlp = mlp_of(d)
        args = block_inputs(rng, b, n, d, mlp)
        kw = dict(heads=heads, kv_valid=kv, act=act, ln_eps=eps,
                  causal=causal)
        shape = f"{b}x{n}x{d} causal={causal}{label}"
        out.append((f"fused_block {shape}",
                    lambda a=args, k=kw: fused_block(*a, **k),
                    lambda a=args, k=kw: fused_block_reference(*a, **k),
                    0.125, kv, mean_tol,
                    block_cost(b, n, d, mlp, heads, kv, causal), None, None))
        if mean_tol_res is not None:
            out.append((f"fused_block_residuals {shape}",
                        lambda a=args, k=kw: fused_block_residuals(*a, **k),
                        lambda a=args, k=kw:
                        fused_block_residuals_reference(*a, **k),
                        0.125, kv, mean_tol_res,
                        block_cost(b, n, d, mlp, heads, kv, causal,
                                   extra_out=5 * d + mlp), None, None))
        if mean_tol8 is None:
            continue
        args8 = int8_block_inputs(args, heads, kv, causal, act, eps)
        out.append((f"fused_block_int8 {shape}",
                    lambda a=args8, k=kw: fused_block_int8(*a, **k),
                    lambda a=args8, k=kw:
                    fused_block_int8_reference(*a, **k),
                    max_tol8, kv, mean_tol8,
                    block_cost(b, n, d, mlp, heads, kv, causal, int8=True),
                    None, None))
    return out


def flash_forward_case(rng, shape, causal, mean_tol):
    """Phase 3's case of the attention forward at [B, H, N, D] (the max
    limit: |o| <= max|v| ~ 4, P rounded to bf16 on both sides), with
    scaled_dot_product_attention's time beside it; and its q, k, v."""
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
    bh, n, hd = shape[0] * shape[1], shape[2], shape[3]
    pairs = bh * attention_pairs(n, causal) * hd
    name = f"{'x'.join(map(str, shape))} causal={causal}"
    return (f"flash_attention {name}",
            lambda: flash_attention(q, k, v, causal),
            lambda: flash_attention_reference(q, k, v, causal),
            0.02, n, mean_tol,
            bound_ms(flops=4 * pairs, nbytes=4 * bh * n * hd * 2),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
            4 * pairs), (q, k, v)


def check_kernels(rng):
    """Phase 3: every kernel against its plain version on the same inputs;
    their times, the bound, and the library call's time where there is
    one. The SigLIP shapes draw from their own generator, so the earlier
    cases keep their inputs."""
    from clip_embeds_tpu_torch.ops.flash_attention import (
        _flash_forward, flash_attention_bwd, flash_attention_bwd_reference)

    # (name, kernel call, plain call, tolerance on max |kernel - plain|,
    #  rows compared (axis 1), tolerance on the mean |kernel - plain|,
    #  (bound_ms, bound_by), library call or None, counted FLOPs or None)
    # Mean limits: BLOCK_CASES, FLASH_CASES, SIGLIP_*_CASES.
    cases = block_kernel_cases(rng, BLOCK_CASES, lambda d: 4 * d, "quick",
                               1e-5, "")
    # the attention backward: max as the edge tests (bf16 rounding flips of
    # P and dS, which the online (kernel) and two-pass (plain) softmax
    # round apart).
    for shape, causal, mean_tol_bwd in FLASH_CASES:
        fwd, (q, k, v) = flash_forward_case(rng, shape, causal, 0.02)
        cases.append(fwd)
        g = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16)
        bh, n, hd = shape[0] * shape[1], shape[2], shape[3]
        pairs = bh * attention_pairs(n, causal) * hd
        io = bh * n * hd * 2
        name = f"{'x'.join(map(str, shape))} causal={causal}"
        o, lse = _flash_forward(q, k, v, causal, with_lse=True)
        with torch.enable_grad():
            lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        cases.append((f"flash_attention_bwd {name}",
                      lambda a=(q, k, v, o, g, lse), c=causal:
                      flash_attention_bwd(*a, c),
                      lambda a=(q, k, v, o, g), c=causal:
                      flash_attention_bwd_reference(*a, c),
                      0.0625, n, mean_tol_bwd,
                      bound_ms(flops=10 * pairs,
                               nbytes=8 * io + bh * n * 4),
                      lambda t=(lq, lk, lv), lo=lo, g=g:
                      torch.autograd.grad(lo, t, g, retain_graph=True),
                      10 * pairs))
    siglip_rng = np.random.default_rng(9)
    cases += block_kernel_cases(
        siglip_rng, SIGLIP_BLOCK_CASES, lambda d: SIGLIP_MLP, "tanh",
        SIGLIP_EPS, f" mlp={SIGLIP_MLP} tanh", SIGLIP_INT8_MAX_DIFF)
    for shape, causal, mean_tol in SIGLIP_FLASH_CASES:
        cases.append(flash_forward_case(siglip_rng, shape, causal,
                                        mean_tol)[0])
    llava_rng = np.random.default_rng(10)
    for shape, causal, mean_tol in LLAVA_FLASH_CASES:
        cases.append(flash_forward_case(llava_rng, shape, causal,
                                        mean_tol)[0])
    results = {}
    for (name, kernel, plain, tol, n_valid, mean_tol, bound, library,
         flops) in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        err = mean = 0.0
        for a, w in zip(got, want, strict=True):
            if a.shape != w.shape:
                raise AssertionError(f"{name}: shape {a.shape} != {w.shape}")
            # padded query rows (fused_block) are not part of the contract
            diff = (a.float() - w.float())
            diff = (diff[:, :n_valid] if a.dim() == 3 else diff).abs()
            err, mean = max(err, float(diff.max())), max(mean,
                                                         float(diff.mean()))
        if not (err <= tol and mean <= mean_tol):
            raise AssertionError(f"{name}: max|diff| {err} (tol {tol}), "
                                 f"mean|diff| {mean} (tol {mean_tol})")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        lib_ms = None if library is None else cuda_ms(library)
        print(f"[kernel] {name}: max|diff| {err:.6g} (tol {tol}), "
              f"mean|diff| {mean:.3g} (tol {mean_tol}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}), library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              + ("" if flops is None else
                 f"; {flops / ms / 1e9:.1f} TFLOP/s on the counted work, "
                 f"{100 * bound[0] / ms:.1f}% of the bound"))
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound[0], bound_by=bound[1],
                             library_ms=lib_ms)
    return results


def gemm_inputs(rng, m, n, k):
    """cet_gemm operands on the card, bf16: a [m, k], w [n, k] of std
    k^-1/2 (sums of std 1), a bias of std 0.5, a residual [m, n]."""
    def t(*shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(
            np.float32)).to("cuda", torch.bfloat16)

    return t(m, k), t(n, k, std=k ** -0.5), t(n, std=0.5), t(m, n)


def gemm_call(epilogue, a, w, bias, res, act="quick"):
    """The kernel and plain calls of one cet_gemm launch with the named
    epilogue ("bias", "act", "residual" or "act_pre"), and the bytes it
    moves (operands read once, outputs written once)."""
    from clip_embeds_tpu_torch.ops.fused_block import (
        _EPI_ACT, _EPI_BIAS, _EPI_RESIDUAL, _gemm, gemm_reference)

    epi = {"bias": _EPI_BIAS, "act": _EPI_ACT, "act_pre": _EPI_ACT,
           "residual": _EPI_RESIDUAL}[epilogue]
    pre = epilogue == "act_pre"
    res = res if epi == _EPI_RESIDUAL else None
    m, n = a.shape[0], w.shape[0]

    def kernel():
        out = torch.empty(m, n, dtype=a.dtype, device=a.device)
        p = torch.empty_like(out) if pre else None
        _gemm(a, w, bias, res, out, epi, act, p)
        return (out, p) if pre else out

    outs = 1 + pre + (res is not None)  # C, pre, and the residual read
    nbytes = 2 * (a.numel() + w.numel() + bias.numel() + outs * m * n)
    return (kernel, lambda: gemm_reference(a, w, bias, res, epi, act, pre),
            nbytes)


def check_gemms(rng, gpu):
    """Phase 3, the bf16 GEMM alone at GEMM_CASES: |kernel - plain|,
    kernel ms, TFLOP/s, share of the bound, F.linear ms."""
    for name, m, n, k, epilogue, act in GEMM_CASES:
        a, w, bias, res = gemm_inputs(rng, m, n, k)
        kernel, plain, nbytes = gemm_call(epilogue, a, w, bias, res, act)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        diffs = [(g.float() - p.float()).abs() for g, p in
                 zip(got, want, strict=True)]
        err = max(float(d.max()) for d in diffs)
        mean = max(float(d.mean()) for d in diffs)
        del got, want, diffs
        if not (err <= GEMM_MAX_DIFF and mean <= GEMM_MEAN_DIFF):
            raise AssertionError(
                f"gemm {name}: max|diff| {err} (tol {GEMM_MAX_DIFF}), "
                f"mean|diff| {mean} (tol {GEMM_MEAN_DIFF})")
        flops = 2 * m * n * k
        bound, bound_by = bound_ms(flops=flops, nbytes=nbytes)
        ms = cuda_ms(kernel)
        linear_ms = cuda_ms(lambda: F.linear(a, w, bias))
        print(f"[gemm] {name} {epilogue}: max|diff| {err:.6g} (tol "
              f"{GEMM_MAX_DIFF}), mean|diff| {mean:.3g} (tol "
              f"{GEMM_MEAN_DIFF}); kernel {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of "
              f"the bound {bound:.4f} ms ({bound_by}); F.linear "
              f"{linear_ms:.4f} ms (kernel / F.linear {ms / linear_ms:.2f})"
              f" on {gpu}")


def gemm_s8_inputs(rng, m, n, k):
    """cet_gemm_s8 operands on the card: int8 codes a [m, k] and w [n, k]
    (std 40), fp32 column scales and biases (std 0.5), the four fp32 act
    scales, a bf16 residual [m, n]."""
    def codes(*shape):
        q = np.clip(np.round(40 * rng.standard_normal(shape)), -127, 127)
        return torch.from_numpy(q.astype(np.int8)).cuda()

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    wscale = (1 + 0.1 * rng.standard_normal(n)) / (30 * k ** 0.5)
    return (codes(m, k), codes(n, k), f32(wscale),
            f32(0.5 * rng.standard_normal(n)), f32(GEMM_S8_ACT_SCALES),
            torch.from_numpy(rng.standard_normal((m, n)).astype(
                np.float32)).to("cuda", torch.bfloat16))


def gemm_s8_call(epilogue, a_idx, a, w, wscale, bias, act_scales, res,
                 act="quick"):
    """The kernel and plain calls of one cet_gemm_s8 launch with the named
    epilogue ("bf16", "residual" or "act_q8"), and the bytes it moves
    (operands read once, the output written once)."""
    from clip_embeds_tpu_torch.ops.fused_block import (
        _ACTS, _EPI_Q_ACT_Q8, _EPI_Q_BF16, _EPI_Q_RESIDUAL, _gemm_s8,
        gemm_s8_reference)

    epi = {"bf16": _EPI_Q_BF16, "residual": _EPI_Q_RESIDUAL,
           "act_q8": _EPI_Q_ACT_Q8}[epilogue]
    res = res if epi == _EPI_Q_RESIDUAL else None
    m, n = a.shape[0], w.shape[0]
    out_dtype = torch.int8 if epi == _EPI_Q_ACT_Q8 else torch.bfloat16

    def kernel():
        out = torch.empty(m, n, dtype=out_dtype, device=a.device)
        _gemm_s8(a, w, wscale, bias, act_scales, a_idx, res, out, epi,
                 _ACTS[act])
        return out

    nbytes = (a.numel() + w.numel() + 8 * n + 4 * act_scales.numel()
              + (0 if res is None else 2 * m * n)
              + m * n * (1 if epi == _EPI_Q_ACT_Q8 else 2))
    return (kernel, lambda: gemm_s8_reference(
        a, w, wscale, bias, act_scales, a_idx, res, epi, act), nbytes)


def int_mm_ms(a, w):
    """ms of torch._int_mm(a, w^T), cuBLASLt's int8 -> int32 product with
    no epilogue (the yardstick, timed only), or "none" and why."""
    try:
        return f"{cuda_ms(lambda: torch._int_mm(a, w.t())):.4f} ms"
    except (RuntimeError, AttributeError) as e:
        return f"none ({type(e).__name__}: {str(e).splitlines()[0]})"


def check_gemms_s8(rng, gpu):
    """Phase 3, the int8 GEMM alone at GEMM_S8_CASES: the outputs against
    the plain version, kernel ms, TOP/s, share of the bound, _int_mm ms."""
    for name, m, n, k, epilogue, a_idx, act in GEMM_S8_CASES:
        a, w, wscale, bias, scales, res = gemm_s8_inputs(rng, m, n, k)
        kernel, plain, nbytes = gemm_s8_call(epilogue, a_idx, a, w, wscale,
                                             bias, scales, res, act)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, flips = float(diff.max()), int((diff > 0).sum())
        del got, want, diff
        exact = epilogue != "act_q8"
        limit = 0 if exact else int(GEMM_S8_FLIPS * m * n)
        if not (err <= (0 if exact else 1) and flips <= limit):
            raise AssertionError(
                f"gemm_s8 {name} {epilogue}: max|diff| {err}, {flips} of "
                f"{m * n} entries apart (limit {limit})")
        ops = 2 * m * n * k
        bound, bound_by = bound_ms(int8_ops=ops, nbytes=nbytes)
        ms = cuda_ms(kernel)
        print(f"[gemm_s8] {name} {epilogue}: max|diff| {err:.6g}, "
              f"{flips} of {m * n} entries apart (limit {limit}); kernel "
              f"{ms:.4f} ms, {ops / ms / 1e9:.1f} TOP/s, "
              f"{100 * bound / ms:.1f}% of the bound {bound:.4f} ms "
              f"({bound_by}); torch._int_mm {int_mm_ms(a, w)} on {gpu}")
        del a, w, wscale, bias, scales, res, kernel, plain


def check_int8_linear(gpu):
    """Phase 3, QuantLinear's card route at INT8_LINEAR_CASES in both
    modes: bit-equal to qdot rounded to bf16, int8_linear ms (both
    kernels), TOP/s, share of the bound, _int_mm ms on the same codes."""
    from clip_embeds_tpu_torch.models.quant import QuantLinear, quantize_weight
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear, qdot

    g = torch.Generator(device="cuda").manual_seed(3)
    for m, n, k in INT8_LINEAR_CASES:
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = 0.02 * torch.randn(n, k, generator=g, device="cuda")
        for mode in ("dynamic", "static"):
            lin = QuantLinear(k, n, mode, bias=False).cuda()
            lin.weight_q, lin.scale = quantize_weight(w)
            amax = x.float().abs().max()
            lin.act_scale.copy_(INT8_LINEAR_STATIC * amax / 127.0)
            got = lin(x)
            a = (lin.act_scale if mode == "static"
                 else (lin.act_max / 127.0).clamp_min(1e-8))
            want = qdot(x.float(), a, lin.weight_q, lin.scale,
                        None).to(torch.bfloat16)
            apart = int((got != want).sum())
            if got.shape != (m, n) or apart or (
                    mode == "dynamic" and lin.act_max != amax):
                raise AssertionError(
                    f"int8_linear {m}x{n}x{k} {mode}: {apart} of {m * n} "
                    f"entries differ from qdot, act_max "
                    f"{float(lin.act_max)} (abs-max {float(amax)})")
            del got, want
        ops = 2 * m * n * k
        nbytes = 2 * m * k + n * k + 4 * n + 2 * m * n
        bound, bound_by = bound_ms(int8_ops=ops, nbytes=nbytes)
        ms = cuda_ms(lambda: int8_linear(x, a, lin.weight_q, lin.scale,
                                         None))
        xq = torch.clamp(torch.round(x.float() / a), -127, 127).to(
            torch.int8)
        print(f"[int8_linear] {m}x{n}x{k}: dynamic and static bit-equal to "
              f"qdot in bf16; kernel {ms:.4f} ms, {ops / ms / 1e9:.1f} "
              f"TOP/s, {100 * bound / ms:.1f}% of the bound {bound:.4f} ms "
              f"({bound_by}); torch._int_mm {int_mm_ms(xq, lin.weight_q)} "
              f"on {gpu}")
        del x, w, xq, lin


def synthetic_requests(rng, cfg):
    size, ctx = cfg.vision.image_size, cfg.text.context_length
    images = [rng.standard_normal((REQUEST_SIZE, size, size, 3)).astype(
        np.float32) for _ in range(REQUESTS)]
    texts = []
    for _ in range(REQUESTS):
        ids = np.zeros((REQUEST_SIZE, ctx), np.int32)
        for row in ids:
            length = int(rng.integers(3, ctx + 1))
            row[0] = SOT
            row[1:length - 1] = rng.integers(1, SOT, length - 2)
            row[length - 1] = EOT
        texts.append(ids)
    return images, texts


def row_cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


class _StepLog(logging.Handler):
    """Collects the training CLI's per-step log records (loss, lr,
    samples/s)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if str(record.msg).startswith("epoch %d step %d loss"):
            self.losses.append(float(record.args[2]))


def route_model(block_impl, compute_dtype=torch.bfloat16):
    """ViT-L/14-336 (OpenAI config) with the seed-0 weights in fp32 on the
    card, computing in ``compute_dtype``, on one block route."""
    from clip_embeds_tpu_torch.core.factory import create_model

    return create_model(MODEL, pretrained="openai", seed=0,
                        dtype=torch.float32, device="cuda",
                        block_impl=block_impl, compute_dtype=compute_dtype,
                        train=True)


def train_batch(batch_size, seed):
    """One synthetic batch (the CLI's data) on the card."""
    from clip_embeds_tpu_torch.cli.train import _to_device
    from clip_embeds_tpu_torch.core.config import get_model_config
    from clip_embeds_tpu_torch.data.synthetic import synthetic_batches

    cfg = get_model_config(MODEL, "openai")
    batch = next(synthetic_batches(batch_size, cfg.vision.image_size,
                                   cfg.text.context_length, seed=seed))
    return _to_device(batch, torch.device("cuda"))


def train_grads(model, batch):
    """Gradients of one batch's InfoNCE loss, fp32, by parameter name."""
    from clip_embeds_tpu_torch.train.steps import clip_train_loss

    model.zero_grad(set_to_none=True)
    loss, _ = clip_train_loss(model, batch)
    loss.backward()
    grads = {k: p.grad.float() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads, loss.item()


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` replaced by ``value`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


def plain_attention():
    """Every attention on its plain path, no kernel: the 'auto' gate of
    ops/attention.py closed."""
    from clip_embeds_tpu_torch.ops import attention

    return patched(attention, "flash_eligible", lambda q, mask=None: False)


def grad_agreement(grads, ref):
    """(cosine over all gradients, least per-tensor cosine and its name)."""
    dot = sum(float((grads[k] * ref[k]).sum()) for k in ref)
    na = sum(float(grads[k].square().sum()) for k in ref) ** 0.5
    nb = sum(float(ref[k].square().sum()) for k in ref) ** 0.5
    per = {k: float(F.cosine_similarity(grads[k].flatten(),
                                        ref[k].flatten(), dim=0))
           for k in ref}
    worst = min(per, key=per.get)
    return dot / (na * nb), per[worst], worst


def check_training(counters, gpu):
    """Phase 6. Returns each route's launch counts from its CLI run."""
    from clip_embeds_tpu_torch.cli.train import main as train_main
    from clip_embeds_tpu_torch.train.optim import adamw
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState, make_clip_train_step)

    base = {k: v.detach().cpu() for k, v in
            route_model("composable").state_dict().items()}
    logging.getLogger().setLevel(logging.INFO)
    launches = {}
    for route, (flags, per_step) in {**ROUTES, **SIGLIP_TRAIN_ROUTE}.items():
        gc.collect()
        torch.cuda.empty_cache()
        log = _StepLog()
        logging.getLogger().addHandler(log)
        for fn in counters.values():
            fn.launches = 0
        try:
            t0 = time.perf_counter()
            state = train_main([
                "--model", MODEL, "--pretrained", "openai", "--seed", "0",
                "--batch-size", str(TRAIN_BATCH), "--train-num-samples",
                str(TRAIN_STEPS * TRAIN_BATCH), "--lr", "1e-5",
                "--warmup", "1", "--log-every", "1", *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            logging.getLogger().removeHandler(log)
        counts = {k: fn.launches for k, fn in counters.items()}
        want = {k: TRAIN_STEPS * per_step.get(k, 0) for k in counters}
        after = state.model.state_dict()
        moved = sum(not torch.equal(after[k].cpu(), v)
                    for k, v in base.items())
        print(f"[train] {route}: {TRAIN_STEPS} steps of {TRAIN_BATCH} "
              f"through cli.train.main in {wall:.1f} s; losses "
              f"{log.losses}; launches {counts}; {moved} of {len(base)} "
              f"parameter tensors moved")
        if counts != want:
            raise AssertionError(f"{route}: launches {counts} != {want}")
        if len(log.losses) != TRAIN_STEPS or not np.isfinite(
                log.losses).all():
            raise AssertionError(f"{route}: losses {log.losses}")
        if moved != len(base):
            raise AssertionError(f"{route}: only {moved} of {len(base)} "
                                 f"parameter tensors moved")
        launches[route] = counts
        del state, after

    # gradients against the plain fp32 composable path, one batch of 8
    batch = train_batch(GRAD_BATCH, seed=1)
    ref_model = route_model("composable", compute_dtype=None)
    ref, ref_loss = train_grads(ref_model, batch)
    del ref_model
    # the witness: the bf16 composable model with no kernel at all, what
    # bf16 compute alone costs the gradients
    with plain_attention():
        witness, _ = train_grads(route_model("composable"), batch)
    cos, worst, worst_name = grad_agreement(witness, ref)
    del witness
    print(f"[train] witness (bf16 composable, plain attention) gradients "
          f"vs plain fp32 at batch {GRAD_BATCH}: cosine {cos:.6f}, least "
          f"per tensor {worst:.6f} ({worst_name})")
    cos_min = max(GRAD_COS_MIN, cos - GRAD_COS_BELOW_WITNESS)
    for route in ROUTES:
        gc.collect()
        torch.cuda.empty_cache()
        model = route_model(route)
        grads, loss = train_grads(model, batch)
        cos, worst, worst_name = grad_agreement(grads, ref)
        print(f"[train] {route} gradients vs plain fp32 at batch "
              f"{GRAD_BATCH}: cosine {cos:.6f} (limit {cos_min:.6f}), "
              f"least per tensor {worst:.6f} ({worst_name}; limit "
              f"{GRAD_TENSOR_COS_MIN}); loss {loss:.6f} vs {ref_loss:.6f}")
        if not (cos >= cos_min and worst >= GRAD_TENSOR_COS_MIN):
            raise AssertionError(f"{route}: gradients disagree")

        # throughput: CUDA events over 3 steps after 1 warm-up
        opt = adamw(model, 1e-5)
        state = TrainState(model, opt, const_lr(1e-5))
        step = make_clip_train_step(model)
        for bs in (TRAIN_BATCH, 64):
            tb = train_batch(bs, seed=2)
            torch.cuda.reset_peak_memory_stats()
            step(state, tb)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                metrics = step(state, tb)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            if not np.isfinite(float(metrics["loss"])):
                raise AssertionError(f"{route} b{bs}: loss not finite")
            print(f"[throughput] train_samples_per_s {route} b{bs}: "
                  f"{bs / ms * 1e3:.1f} ({ms:.2f} ms/step, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) "
                  f"on {gpu}")
            del tb
        del model, opt, state, step, grads
    return launches


def serving_routes(model, ref, images, texts, rng):
    """Phase 5's serving routes: name -> (items per call, call). Images b32
    through the CLI's bf16 route (composable + flash) and
    fused_encode_image, texts b256 through fused_encode_text, and the
    --int8 twins (calibrated on the first request, the fp parts read from
    the fp32 model ``ref``, as the CLI does). Call under inference mode."""
    from clip_embeds_tpu_torch.models.serving import (
        fused_encode_image, fused_encode_image_int8, fused_encode_text,
        fused_encode_text_int8, prepare_int8_text_tower, prepare_int8_tower)

    cfg, bs, bf16 = model.cfg, 32, torch.bfloat16
    px = torch.from_numpy(rng.standard_normal(
        (bs, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
            np.float32)).cuda()
    ids = torch.from_numpy(np.concatenate(texts * 11)[:256]).long().cuda()
    q_img = prepare_int8_tower(ref, torch.from_numpy(images[0]).cuda(), bf16)
    q_txt = prepare_int8_text_tower(
        ref, torch.from_numpy(texts[0]).long().cuda(), bf16)
    return {
        "images_per_s composable+flash": (
            bs, lambda: model.encode_image(px.bfloat16(), normalize=True)),
        "images_per_s fused_encode_image": (
            bs, lambda: fused_encode_image(model, px)),
        "texts_per_s fused_encode_text": (
            len(ids), lambda: fused_encode_text(model, ids)),
        "images_per_s fused_encode_image_int8": (
            bs, lambda: fused_encode_image_int8(ref, q_img, px)),
        "texts_per_s fused_encode_text_int8": (
            len(ids), lambda: fused_encode_text_int8(ref, q_txt, ids)),
    }


def write_photos(paths, seed):
    """640x480 JPEGs of smooth random fields with mild noise, one seed a
    file (pure noise decodes atypically slowly), written on all cores."""
    from PIL import Image

    def one(i):
        rng = np.random.default_rng([seed, i])
        low = Image.fromarray(rng.integers(0, 256, (6, 8, 3), np.uint8))
        img = np.asarray(low.resize(PHOTO[::-1], Image.BICUBIC), np.int16)
        img = img + rng.integers(-6, 7, img.shape, np.int16)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            paths[i], quality=90)

    os.makedirs(os.path.dirname(paths[0]), exist_ok=True)
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(one, range(len(paths))))


def write_whatsup(root, seed):
    """What'sUp-A format: object pairs x 4 prepositions, captions ground
    truth first (2 of the 4 options are kept for --dataset a)."""
    dataset, paths = [], []
    for p in range(WHATSUP_PAIRS):
        o1, o2 = f"{OBJECTS[p % len(OBJECTS)]}{p}", f"table{p}"
        for key in WHATSUP_KEYS:
            name = f"{o1}_{key}_of_the_{o2}.jpeg"
            gt = (f"A {o1} {key} of a {o2}" if key in ("left", "right")
                  else f"A {o1} {key} a {o2}")
            others = [k for k in WHATSUP_KEYS if k not in (key, OPPOSITE[key])]
            dataset.append({
                "image_path": f"data/controlled_images/{name}",
                "caption_options": [gt, gt.replace(key, OPPOSITE[key])]
                + [gt.replace(key, o) for o in others]})
            paths.append(os.path.join(root, "controlled_images", name))
    write_photos(paths, seed)
    with open(os.path.join(root, "controlled_images_dataset.json"), "w") as fh:
        json.dump(dataset, fh)


def write_mmvp_vlm(root, seed):
    """MMVP-VLM format: Questions.csv and MLLM_VLM_Images/<category>/."""
    import csv

    from clip_embeds_tpu_torch.evals.mmvp import MMVP_VLM_CATEGORIES

    rows, paths = [["qid", "type", "statement"]], []
    rng = np.random.default_rng(seed)
    for qid in range(1, 2 * MMVP_PAIRS + 1):
        cat = MMVP_VLM_CATEGORIES[(qid - 1) // 30]
        rows.append([str(qid), cat, f"the {OBJECTS[rng.integers(17)]} is "
                     f"{('left', 'open', 'red', 'two')[rng.integers(4)]}"])
        paths.append(os.path.join(root, "MLLM_VLM_Images", cat, f"{qid}.jpg"))
    for cat in MMVP_VLM_CATEGORIES:
        os.makedirs(os.path.join(root, "MLLM_VLM_Images", cat), exist_ok=True)
    write_photos(paths, seed)
    with open(os.path.join(root, "Questions.csv"), "w", newline="") as fh:
        csv.writer(fh).writerows(rows)


def run_main(fn, argv):
    """An entry point's main(argv), its return value and the JSON line it
    prints last (its output is also echoed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    return ret, json.loads(out.strip().splitlines()[-1])


def recorded(fn, log):
    def wrapped(*args):
        out = fn(*args)
        log.append(np.asarray(out, np.float64))
        return out
    return wrapped


def write_eval_fixtures(tmp, gpu):
    """Phase 7's fixtures, which phase 8 reads too: What'sUp-A under
    tmp/whatsup, MMVP-VLM under tmp/mmvp."""
    t0 = time.perf_counter()
    write_whatsup(os.path.join(tmp, "whatsup"), 7)
    write_mmvp_vlm(os.path.join(tmp, "mmvp"), 8)
    print(f"[eval] fixtures: {4 * WHATSUP_PAIRS} What'sUp-A and "
          f"{2 * MMVP_PAIRS} MMVP-VLM JPEGs at {PHOTO[1]}x{PHOTO[0]} "
          f"in {time.perf_counter() - t0:.1f} s on {gpu}'s host")


def check_decisions(runs, label):
    """Each scorer's decisions against the plain fp32 path's on every
    sample whose fp32 margin exceeds twice the largest score difference.
    ``runs``: dataset -> (run(scorer, log), ours, plain); "a" logs one
    score_batch call of [n_options] rows, "mmvpvlm" a [2, 2] probability
    matrix a pair."""
    for dataset, (run, ours, plain) in runs.items():
        logs = [], []
        for scorer, log in zip((ours, plain), logs):
            run(scorer, log)
        got, want = (np.concatenate(log) if dataset == "a"
                     else np.stack(log) for log in logs)
        if dataset == "a":  # option 0 against option 1
            margin = want[:, 0] - want[:, 1]
            agree = (got[:, 0] > got[:, 1]) == (margin > 0)
        else:  # P(image 1) of each statement against 0.5
            margin = (want[:, :, 0] - 0.5).ravel()
            agree = ((got[:, :, 0] > 0.5).ravel() == (margin > 0))
        diff = float(np.abs(got - want).max())
        clear = np.abs(margin) > 2 * diff
        print(f"[{label}] --dataset {dataset}: largest score difference "
              f"bf16 vs fp32 {diff:.3g}; decisions agree on "
              f"{int(agree[clear].sum())} of {int(clear.sum())} samples "
              f"with margin > 2x it ({int(agree.sum())} of {agree.size} "
              f"in all)")
        if not agree[clear].all():
            raise AssertionError(f"{label} {dataset}: a clear decision "
                                 "differs from the fp32 path's")


def decision_runs(ours, plain, tmp):
    """check_decisions' runs on the first AGREE_SAMPLES What'sUp-A samples
    and the first AGREE_PAIRS MMVP-VLM pairs of the fixtures in tmp."""
    from clip_embeds_tpu_torch.evals.mmvp import read_question_pairs
    from clip_embeds_tpu_torch.evals.whatsup import (
        eval_whatsup, load_annotation)

    root, mroot = os.path.join(tmp, "whatsup"), os.path.join(tmp, "mmvp")
    data, _ = load_annotation(root, "a")
    pairs = read_question_pairs(os.path.join(mroot, "Questions.csv"))
    pairs = pairs[:AGREE_PAIRS]

    def mmvp_pairs(scorer, log):
        """eval_mmvp's pair_score calls, on the first pairs."""
        for (q1, cat, t1), (q2, _, t2) in pairs:
            log.append(scorer.pair_score(
                [os.path.join(mroot, "MLLM_VLM_Images", cat, f"{q}.jpg")
                 for q in (q1, q2)],
                ["a photo of " + t1, "a photo of " + t2]))

    return {"a": (lambda s, log: eval_whatsup(
                recorded(s.score_batch, log), data[:AGREE_SAMPLES], root),
                  ours, plain),
            "mmvpvlm": (mmvp_pairs, ours, plain)}


def check_eval(model, ref, drive, tmp, gpu):
    """Phase 7 (a): the eval CLI on the card, then its scorer against the
    plain fp32 path, on the fixtures in tmp."""
    from clip_embeds_tpu_torch.cli.eval import main as eval_main
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation
    from clip_embeds_tpu_torch.scores.scorers import CLIPScorer

    cfg = model.cfg
    blocks = cfg.vision.layers - 1, cfg.text.layers  # CLS-only last: plain
    n_img = 4 * WHATSUP_PAIRS
    runs = {  # dataset: (root, the one call's fused_block launches)
        "a": ("whatsup", math.ceil(n_img / EVAL_BATCH) * blocks[0]
              + math.ceil(2 * n_img / EVAL_BATCH) * blocks[1]),
        "a4": ("whatsup", math.ceil(n_img / EVAL_BATCH) * blocks[0]
               + math.ceil(4 * n_img / EVAL_BATCH) * blocks[1]),
        # one pair_score call a pair: 2 images, 2 statements
        "mmvpvlm": ("mmvp", MMVP_PAIRS * sum(blocks)),
    }
    for dataset, (sub, want) in runs.items():
        root = os.path.join(tmp, sub)
        t0 = time.perf_counter()
        (results, info), counts = drive(f"eval --dataset {dataset}", (
            lambda: run_main(eval_main, [
                "--scorer", "clip", "--model", MODEL, "--pretrained",
                "openai", "--dataset", dataset, "--root-dir", root,
                "--results-file", os.path.join(tmp, "results.txt"),
                "--batch-size", str(EVAL_BATCH)])))
        expect = {k: (want if k == "fused_block" else 0) for k in counts}
        if counts != expect or info["route"] != "fused":
            raise AssertionError(f"eval {dataset}: route {info['route']},"
                                 f" launches {counts} != {expect}")
        if not all(0 <= v <= 100 for v in results.values()):
            raise AssertionError(f"eval {dataset}: {results}")
        print(f"[eval] --dataset {dataset}: {info['samples_per_s']} "
              f"samples/s ({info['samples']} samples, {info['decoder']} "
              f"decode, bf16 fused route; main took "
              f"{time.perf_counter() - t0:.1f} s with its model build) "
              f"on {gpu}")
        if info["decoder"] != EXPECTED_DECODER:
            raise AssertionError(f"decoder {info['decoder']} != "
                                 f"{EXPECTED_DECODER}")

    # the scorer (bf16, fused) against the plain fp32 composable path
    t0 = time.perf_counter()
    ours = CLIPScorer(model, batch_size=EVAL_BATCH)
    plain = CLIPScorer(ref, batch_size=EVAL_BATCH)
    root = os.path.join(tmp, "whatsup")
    data, _ = load_annotation(root, "a")
    paths = [os.path.join(root, d["image_path"][5:]) for d in data[:64]]
    texts = [t for d in data[:32] for t in d["caption_options"]]
    cos = {"image": float(row_cos(ours.encode_images(paths),
                                  plain.encode_images(paths)).min()),
           "text": float(row_cos(ours.encode_texts(texts),
                                 plain.encode_texts(texts)).min())}
    print(f"[eval] scorer min row cosine vs plain fp32 (limit 0.99): "
          f"{cos}")
    if min(cos.values()) < 0.99:
        raise AssertionError(f"scorer embeddings disagree: {cos}")
    # the fp32 path decodes and encodes every image again: the check is
    # cut to a part of each fixture to keep phase 7 near its budget
    print(f"[eval] decisions against fp32: the first "
          f"{min(AGREE_SAMPLES, len(data))} of {len(data)} What'sUp-A "
          f"samples and {AGREE_PAIRS} of "
          f"{MMVP_PAIRS} MMVP-VLM pairs (cut for time)")
    check_decisions(decision_runs(ours, plain, tmp), "eval")
    print(f"[eval] scorer checks took {time.perf_counter() - t0:.1f} s "
          f"on {gpu}")


@contextlib.contextmanager
def shared_models(bf16_model, fp32_model):
    """The entry points' create_model returns phase 4's models (ViT-L/14-336,
    OpenAI config, seed 0) instead of building the same weights again:
    bf16 for the eval CLI, fp32 computing in fp32 for the head trainer
    (--precision fp32). Any other request is an error."""
    from clip_embeds_tpu_torch.core import factory

    def create_model(name, pretrained=None, seed=0, dtype=torch.float32,
                     device="cpu", compute_dtype=None, **kw):
        if (name, pretrained, seed, torch.device(device).type, kw) != (
                MODEL, "openai", 0, "cuda", {}) or compute_dtype not in (
                    None, dtype):
            raise AssertionError(f"phase 8 shares no model for {name} "
                                 f"{pretrained} seed {seed} {device} {kw}")
        return {torch.bfloat16: bf16_model, torch.float32: fp32_model}[dtype]

    with patched(factory, "create_model", create_model):
        yield


def fixture_part(tmp, n):
    """A What'sUp-A root holding the first n samples of tmp/whatsup."""
    root = os.path.join(tmp, f"whatsup_{n}")
    os.makedirs(root)
    os.symlink(os.path.join(tmp, "whatsup", "controlled_images"),
               os.path.join(root, "controlled_images"))
    name = "controlled_images_dataset.json"
    with open(os.path.join(tmp, "whatsup", name)) as fh:
        data = json.load(fh)[:n]
    with open(os.path.join(root, name), "w") as fh:
        json.dump(data, fh)
    return root


def train_heads(drive, cfg, tmp, gpu):
    """Phase 8 (a): cli/train_pacl.py main on each frozen-tower route.
    Returns the saved head of each route."""
    from clip_embeds_tpu_torch.cli.train_pacl import main as train_pacl
    from clip_embeds_tpu_torch.core.convert import jax_params_from_head
    from clip_embeds_tpu_torch.core.factory import (
        flatten_params, load_params_npz)
    from clip_embeds_tpu_torch.models.heads import (
        PACLHead, SPARCHead, init_head)

    v, t = cfg.vision.layers, cfg.text.layers
    calls = HEAD_STEPS + 1  # the gate's feature call, then one a step
    saved = {}
    for label, (objective, route) in HEAD_ROUTES.items():
        # the launches of the run: the image blocks of each tower call
        # (fused_block, or fused_block_int8 after a calibration pass whose
        # bf16 composable image tower takes the flash kernel), and PACL's
        # fused text blocks; the gate's composable fp32 tower and SPARC's
        # composable text tower take plain attention
        want = {"fused_block": calls * (t if objective == "pacl" else 0)}
        if route == "int8":
            want.update(flash_attention=v, fused_block_int8=calls * v)
        else:
            want["fused_block"] += calls * v
        out = os.path.join(tmp, f"{label.replace(' ', '_')}.npz")
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, counts = drive(f"train_pacl {label}", lambda: train_pacl([
            "--objective", objective, "--frozen-tower", route,
            "--model", MODEL, "--pretrained", "openai", "--seed", "0",
            "--synthetic", "--batch-size", str(HEAD_BATCH),
            "--train-num-samples", str(HEAD_STEPS * HEAD_BATCH),
            "--proj-dim", str(cfg.embed_dim), "--log-every", "1",
            "--output", out]))
        wall = time.perf_counter() - t0
        rep = state.report
        expect = {k: want.get(k, 0) for k in counts}
        print(f"[heads] {label}: {HEAD_STEPS} steps of {HEAD_BATCH} through "
              f"cli.train_pacl.main in {wall:.1f} s; gate cosine "
              f"{rep['gate_cos']} (limit {HEAD_GATE_COS}); losses "
              f"{rep['losses']}; {rep['samples_per_s'][-1]} samples/s (the "
              f"CLI's, over the {HEAD_STEPS} steps); peak "
              f"{rep['peak_gib']:.2f} GiB ({resident / 2**30:.2f} GiB of it "
              f"the shared models); launches {counts} on {gpu}")
        if counts != expect or rep["route"] != route:
            raise AssertionError(f"{label}: route {rep['route']}, launches "
                                 f"{counts} != {expect}")
        if rep["gate_cos"] is None or rep["gate_cos"] < HEAD_GATE_COS:
            raise AssertionError(f"{label}: gate cosine {rep['gate_cos']}")
        if len(rep["losses"]) != HEAD_STEPS or not np.isfinite(
                rep["losses"]).all() or state.step != HEAD_STEPS:
            raise AssertionError(f"{label}: losses {rep['losses']}")
        # the .npz has the JAX layout, and every tensor moved from init
        # (proj_dim = embed_dim, the width the eval CLI's heads take)
        if objective == "pacl":
            head = PACLHead(cfg.vision.width, cfg.embed_dim, cfg.embed_dim,
                            pooling="weighted")
        else:
            head = SPARCHead(cfg.vision.width, cfg.text.width, cfg.embed_dim)
        init = flatten_params(jax_params_from_head(init_head(head, 0)))
        got = flatten_params(load_params_npz(out))
        if {k: a.shape for k, a in got.items()} != \
                {k: a.shape for k, a in init.items()}:
            raise AssertionError(f"{label}: .npz layout {sorted(got)}")
        still = [k for k in init if np.array_equal(got[k], init[k])]
        if still:
            raise AssertionError(f"{label}: not trained: {still}")
        saved[label] = out
        del state
    return saved


def check_heads(model, ref, drive, tmp, gpu):
    """Phase 8: the PACL/SPARC heads trained on the frozen tower through
    cli/train_pacl.py, then scored through cli/eval.py on phase 7's
    fixtures, and the scorers against the plain fp32 path."""
    from types import SimpleNamespace

    from clip_embeds_tpu_torch.cli.eval import build_head
    from clip_embeds_tpu_torch.cli.eval import main as eval_main
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation
    from clip_embeds_tpu_torch.scores.scorers import PACLScorer, SPARCScorer

    cfg, v = model.cfg, model.cfg.vision.layers
    with shared_models(model, ref):
        heads = train_heads(drive, cfg, tmp, gpu)
        root = os.path.join(tmp, "whatsup")
        part = fixture_part(tmp, HEAD_EVAL_SAMPLES)
        n_a = 4 * WHATSUP_PAIRS
        print(f"[heads] eval fixtures: What'sUp-A {n_a} samples (PACL), its "
              f"first {HEAD_EVAL_SAMPLES} (SPARC: one tower call a sample; "
              f"cut for time), MMVP-VLM {MMVP_PAIRS} pairs (PACL)")
        # bf16 composable towers: the 577-token image tower's attention is
        # the flash kernel; the text tower's is plain
        runs = (("pacl", [], "a", root, math.ceil(n_a / EVAL_BATCH) * v),
                ("pacl", [], "mmvpvlm", os.path.join(tmp, "mmvp"),
                 MMVP_PAIRS * v),
                ("sparc", ["--sparc-local"], "a", part,
                 HEAD_EVAL_SAMPLES * v))
        for kind, flags, dataset, data_root, want in runs:
            label = " ".join(["--scorer", kind, *flags, "--dataset",
                              dataset])
            t0 = time.perf_counter()
            (results, info), counts = drive(
                f"eval {label}", lambda: run_main(eval_main, [
                    "--scorer", kind, "--model", MODEL, "--pretrained",
                    "openai", "--model-path", heads[f"{kind} fused"],
                    "--dataset", dataset, "--root-dir", data_root,
                    "--results-file", os.path.join(tmp, "results.txt"),
                    "--batch-size", str(EVAL_BATCH), *flags]))
            expect = {k: (want if k == "flash_attention" else 0)
                      for k in counts}
            if counts != expect or info["route"] != "composable":
                raise AssertionError(f"eval {kind} {dataset}: route "
                                     f"{info['route']}, launches {counts} "
                                     f"!= {expect}")
            if not all(0 <= x <= 100 for x in results.values()):
                raise AssertionError(f"eval {kind} {dataset}: {results}")
            print(f"[heads] eval {label}: {info['samples_per_s']} samples/s "
                  f"({info['samples']} samples, {info['decoder']} decode, "
                  f"bf16 composable + flash; main took "
                  f"{time.perf_counter() - t0:.1f} s) on {gpu}")

    # the scorers (bf16 towers + fp32 head) against the plain fp32 path
    # (fp32 towers and head, no kernel)
    t0 = time.perf_counter()
    data, _ = load_annotation(root, "a")
    paths = [os.path.join(root, d["image_path"][5:]) for d in data[:64]]

    def scorers(kind, **kw):
        args = SimpleNamespace(scorer=kind, rope="none",
                               model_path=heads[f"{kind} fused"])
        cls = PACLScorer if kind == "pacl" else SPARCScorer
        return [cls(m, build_head(args, m), batch_size=EVAL_BATCH, **kw)
                for m in (model, ref)]

    def pacl_image_side(scorer):
        """The PACL head's pooled image embeddings (uniform pooling: the
        text does not enter them)."""
        patches = scorer._image_patches(paths)
        with torch.inference_mode():
            img, _ = scorer.head(scorer._to_head(patches), torch.zeros(
                len(paths), cfg.embed_dim, device=scorer.device))
        return img.cpu().numpy()

    def sparc_image_side(scorer):
        """The SPARC head's patch projections [n * P, D] of 16 images."""
        pixels = scorer._pixels(paths[:16])
        tokens = scorer.tokenizer([d["caption_options"][0]
                                   for d in data[:16]])
        with torch.inference_mode():
            vproj, _ = scorer.head_outputs(pixels, tokens)
        return vproj.reshape(-1, vproj.shape[-1]).cpu().numpy()

    pacl, sparc = scorers("pacl"), scorers("sparc", local=True)
    # the card's scorers (bf16 towers) through the flash kernel: one image
    # tower call for PACL's batch, one for SPARC's 16 images; the fp32
    # path's attention is plain (the kernel is bf16), with no launch
    sides = {}
    for i, label in enumerate(("bf16", "fp32")):
        sides[label], counts = drive(
            f"head scorers' image side, {label}",
            lambda: (pacl_image_side(pacl[i]), sparc_image_side(sparc[i])))
        want = (math.ceil(len(paths) / EVAL_BATCH) + 1) * v \
            if label == "bf16" else 0
        expect = {k: (want if k == "flash_attention" else 0) for k in counts}
        if counts != expect:
            raise AssertionError(f"head scorers' image side, {label}: "
                                 f"launches {counts} != {expect}")
    cos = {kind: float(row_cos(got, ref).min()) for kind, got, ref in zip(
        ("pacl", "sparc"), sides["bf16"], sides["fp32"])}
    print(f"[heads] image-side head outputs, least row cosine vs plain fp32 "
          f"(limit 0.99): {cos}")
    if min(cos.values()) < 0.99:
        raise AssertionError(f"head scorers disagree: {cos}")
    print(f"[heads] decisions against fp32: the first {AGREE_SAMPLES} "
          f"What'sUp-A samples (PACL, SPARC local) and {AGREE_PAIRS} "
          f"MMVP-VLM pairs (PACL)")
    pacl_runs = decision_runs(*pacl, tmp)
    sparc_runs = decision_runs(*sparc, tmp)
    check_decisions(pacl_runs, "heads pacl")
    check_decisions({"a": sparc_runs["a"]}, "heads sparc local")
    print(f"[heads] scorer checks took {time.perf_counter() - t0:.1f} s on "
          f"{gpu}")


def write_siglip_vocab(path, seed):
    """A sentencepiece unigram .model (the T5 layout: <pad>, </s>, <unk>)
    written from the seed: the fixtures' words as whole pieces, then
    letters and digits, with seeded scores."""
    from clip_embeds_tpu_torch.text.unigram import (
        CONTROL, NORMAL, UNKNOWN, write_model_proto)

    rng = np.random.default_rng(seed)
    words = sorted(set(OBJECTS) | set(WHATSUP_KEYS) | {
        "a", "of", "the", "table", "photo", "is", "open", "red", "two"})
    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
              ("<unk>", 0.0, UNKNOWN)]
    pieces += [("\u2581" + w, float(-2 - rng.random()), NORMAL)
               for w in words]
    pieces += [(c, float(-5 - rng.random()), NORMAL)
               for c in "\u2581abcdefghijklmnopqrstuvwxyz0123456789"]
    with open(path, "wb") as fh:
        fh.write(write_model_proto(pieces))


def siglip_requests(cfg):
    """Phase 9's requests on the card: SIGLIP_IMAGES images and
    SIGLIP_TEXTS token rows (64 ids, any of the vocabulary but pad and
    </s>), from the seed."""
    rng = np.random.default_rng(10)
    v, t = cfg.vision, cfg.text
    px = torch.from_numpy(rng.standard_normal(
        (SIGLIP_IMAGES, v.image_size, v.image_size, 3)).astype(
            np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(
        2, t.vocab_size, (SIGLIP_TEXTS, t.max_position_embeddings))).cuda()
    return px, ids


def siglip_routes(model, ref, px, ids, q_img, q_txt):
    """Phase 9's serving routes: name -> (items per call, call, the
    launches of one call). bf16 ``model``; the int8 twins read the fp parts
    of the fp32 ``ref`` and the calibrated towers ``q_img`` / ``q_txt``, as
    the CLIP --int8 route does. Call under inference mode."""
    from clip_embeds_tpu_torch.models.serving import (
        fused_encode_image_siglip, fused_encode_image_siglip_int8,
        fused_encode_text_siglip, fused_encode_text_siglip_int8)

    v, t = model.cfg.vision.layers, model.cfg.text.layers
    return {
        "images fused_encode_image_siglip": (
            len(px), lambda: fused_encode_image_siglip(model, px),
            {"fused_block": v}),
        "texts fused_encode_text_siglip": (
            len(ids), lambda: fused_encode_text_siglip(model, ids),
            {"fused_block": t}),
        "images composable+flash": (
            len(px), lambda: model.encode_image(px),
            {"flash_attention": v}),
        "images fused_encode_image_siglip_int8": (
            len(px), lambda: fused_encode_image_siglip_int8(ref, q_img, px),
            {"fused_block_int8": v}),
        "texts fused_encode_text_siglip_int8": (
            len(ids), lambda: fused_encode_text_siglip_int8(ref, q_txt, ids),
            {"fused_block_int8": t}),
    }


def check_siglip(drive, tmp, gpu):
    """Phase 9 (a) and (b): SO400M's serving routes with exact launches,
    agreement and rates; then SiglipScorer on phase 7's What'sUp-A
    fixture. (c), the --siglip train step, runs in check_training."""
    import copy

    from clip_embeds_tpu_torch.core.openclip_registry import (
        resolve_siglip_config)
    from clip_embeds_tpu_torch.evals.whatsup import (
        eval_whatsup, load_annotation)
    from clip_embeds_tpu_torch.models.serving import (
        prepare_int8_siglip_text_tower, prepare_int8_siglip_tower,
        siglip_fused_available)
    from clip_embeds_tpu_torch.models.siglip import cast_siglip, create_siglip
    from clip_embeds_tpu_torch.scores.scorers import SiglipScorer
    from clip_embeds_tpu_torch.text.tokenizer import SigLipTokenizer

    cfg = resolve_siglip_config(SIGLIP_MODEL)
    v, t = cfg.vision, cfg.text
    t0 = time.perf_counter()
    ref = create_siglip(cfg, seed=0, device="cuda")  # fp32: plain path
    model = cast_siglip(copy.deepcopy(ref), torch.bfloat16)
    params = sum(p.numel() for p in ref.parameters())
    print(f"[siglip] {SIGLIP_MODEL}: vision {v.layers}x{v.width} heads "
          f"{v.heads} (head dim {v.width // v.heads}) mlp "
          f"{v.intermediate_size}, {v.num_patches} tokens; text "
          f"{t.layers}x{t.width}, {t.max_position_embeddings} tokens; "
          f"{params / 1e6:.1f} M parameters; built in "
          f"{time.perf_counter() - t0:.1f} s")
    if not siglip_fused_available(v):
        raise AssertionError("SO400M would not take the fused route")
    px, ids = siglip_requests(cfg)
    embs = {}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        # int8: static scales calibrated on the first SIGLIP_CALIB of each
        # request (the image calibration's composable bf16 tower runs the
        # flash kernel, counted here)
        (q_img, q_txt), counts = drive("siglip int8 calibration", lambda: (
            prepare_int8_siglip_tower(ref, px[:SIGLIP_CALIB], torch.bfloat16),
            prepare_int8_siglip_text_tower(ref, ids[:SIGLIP_CALIB],
                                           torch.bfloat16)))
        if counts != {k: (v.layers if k == "flash_attention" else 0)
                      for k in counts}:
            raise AssertionError(f"siglip calibration: launches {counts}")
        routes = siglip_routes(model, ref, px, ids, q_img, q_txt)
        # the plain fp32 composable path: no kernel (fp32 attention)
        plain = {"images plain fp32": (SIGLIP_IMAGES,
                                       lambda: ref.encode_image(px), {}),
                 "texts plain fp32": (SIGLIP_TEXTS,
                                      lambda: ref.encode_text(ids), {})}
        for label, (n, fn, want) in {**routes, **plain}.items():
            out, counts = drive(f"siglip {label}", fn)
            expect = {k: want.get(k, 0) for k in counts}
            if counts != expect:
                raise AssertionError(f"siglip {label}: launches {counts} "
                                     f"!= {expect}")
            e = out.float()
            norms = e.norm(dim=-1)
            if e.shape != (n, v.width) or not torch.isfinite(e).all() \
                    or (norms - 1).abs().max().item() > 2e-2:
                raise AssertionError(f"siglip {label}: shape {e.shape}, "
                                     f"norms {norms.min()}..{norms.max()}")
            embs[label] = e
        peak = torch.cuda.max_memory_allocated() / 2**30

        def cos(a, b):
            return float(F.cosine_similarity(embs[a], embs[b], dim=-1).min())

        agree = {
            "fused image vs fp32": cos("images fused_encode_image_siglip",
                                       "images plain fp32"),
            "composable+flash image vs fp32": cos("images composable+flash",
                                                  "images plain fp32"),
            "fused text vs fp32": cos("texts fused_encode_text_siglip",
                                      "texts plain fp32"),
            "int8 image vs bf16": cos(
                "images fused_encode_image_siglip_int8",
                "images fused_encode_image_siglip"),
            "int8 text vs bf16": cos("texts fused_encode_text_siglip_int8",
                                     "texts fused_encode_text_siglip"),
        }
        print(f"[siglip] min row cosine (limit 0.99; int8 against bf16, "
              f"the JAX package's INT8_MIN_COS): {agree}; peak device "
              f"memory {peak:.2f} GiB on {gpu}")
        if min(agree.values()) < 0.99:
            raise AssertionError(f"siglip embeddings disagree: {agree}")
        for label, (count, fn, _) in routes.items():
            ms = cuda_ms(fn, iters=3, warmup=1)
            kind, name = label.split(" ", 1)
            print(f"[throughput] siglip {kind}_per_s {name}: "
                  f"{count / ms * 1e3:.1f} (batch {count}, {ms:.2f} ms) "
                  f"on {gpu}")
    del routes, plain, q_img, q_txt, embs
    gc.collect()

    # (b) the scorer on What'sUp-A: images through fused_block, texts
    # through the composable tower (64 tokens: plain attention)
    vocab = os.path.join(tmp, "siglip_c4.model")
    write_siglip_vocab(vocab, 11)
    tok = SigLipTokenizer(vocab)
    ours = SiglipScorer(model, tok, batch_size=EVAL_BATCH)
    plain = SiglipScorer(ref, tok, batch_size=EVAL_BATCH)
    if (ours.route, plain.route) != ("fused", "composable"):
        raise AssertionError(f"siglip scorer routes {ours.route}, "
                             f"{plain.route}")
    root = os.path.join(tmp, "whatsup")
    data, _ = load_annotation(root, "a")
    t0 = time.perf_counter()
    results, counts = drive("siglip eval a", lambda: eval_whatsup(
        ours.score_batch, data, root))
    seconds = time.perf_counter() - t0
    want = math.ceil(len(data) / EVAL_BATCH) * v.layers
    if counts != {k: (want if k == "fused_block" else 0) for k in counts}:
        raise AssertionError(f"siglip eval: launches {counts}, want "
                             f"{want} fused_block")
    if not all(0 <= r <= 100 for r in results.values()):
        raise AssertionError(f"siglip eval: {results}")
    print(f"[siglip] SiglipScorer on What'sUp-A: {len(data) / seconds:.2f} "
          f"samples/s ({len(data)} samples, PIL decode, bf16 fused "
          f"images) on {gpu}")
    paths = [os.path.join(root, d["image_path"][5:]) for d in data[:64]]
    img_cos = float(row_cos(ours.encode_images(paths),
                            plain.encode_images(paths)).min())
    print(f"[siglip] scorer image embeddings vs plain fp32 min row cosine "
          f"(limit 0.99): {img_cos}")
    if img_cos < 0.99:
        raise AssertionError(f"siglip scorer embeddings disagree: {img_cos}")
    check_decisions(decision_runs(ours, plain, tmp), "siglip")
    del ours, plain, model, ref
    gc.collect()
    torch.cuda.empty_cache()


def check_end_to_end(drive, device_ips, embed_dim, gpu):
    """Phase 7 (b): cli/embed.py main from JPEG files, bf16 and --int8."""
    from clip_embeds_tpu_torch.cli.embed import main as embed_main

    cores = os.cpu_count()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, "img", f"{i:04d}.jpg")
                 for i in range(E2E_IMAGES)]
        t0 = time.perf_counter()
        write_photos(paths, 9)
        print(f"[e2e] {E2E_IMAGES} JPEGs at {PHOTO[1]}x{PHOTO[0]} written in "
              f"{time.perf_counter() - t0:.1f} s on {gpu}'s host")
        n_batches = math.ceil(E2E_IMAGES / E2E_BATCH)
        embs = {}
        for label, flags, route, device_key, want in (
                ("bf16", [], "composable",
                 "images_per_s composable+flash",
                 {"flash_attention": 24 * n_batches}),
                ("int8", ["--int8"], "fused_int8",
                 "images_per_s fused_encode_image_int8",
                 # the int8 blocks (the last image block is CLS-only
                 # bf16), and the calibration pass of a dynamic-quant copy
                 # on the first 16 images, whose attention is the kernel
                 {"fused_block_int8": 23 * n_batches,
                  "flash_attention": 24})):
            out = os.path.join(tmp, f"{label}.npy")
            t0 = time.perf_counter()
            (rc, info), counts = drive(f"e2e {label}", lambda: run_main(
                embed_main, ["--model", MODEL, "--pretrained", "openai",
                             "--input", os.path.join(tmp, "img"),
                             "--output", out, "--batch-size",
                             str(E2E_BATCH), "--workers", str(cores),
                             *flags]))
            expect = {k: want.get(k, 0) for k in counts}
            if rc != 0 or info["route"] != route or counts != expect:
                raise AssertionError(f"e2e {label}: rc {rc}, route "
                                     f"{info['route']}, launches {counts} "
                                     f"!= {expect}")
            if info["decoder"] != EXPECTED_DECODER:
                raise AssertionError(f"decoder {info['decoder']} != "
                                     f"{EXPECTED_DECODER}")
            emb = np.load(out)
            with open(out + ".paths.json") as fh:
                kept = json.load(fh)
            norms = np.linalg.norm(emb, axis=-1)
            if kept != paths or emb.shape != (E2E_IMAGES, embed_dim) \
                    or not np.isfinite(emb).all() \
                    or np.abs(norms - 1).max() > 2e-2:
                raise AssertionError(f"e2e {label}: {emb.shape}, norms "
                                     f"{norms.min()}..{norms.max()}")
            embs[label] = emb
            e2e, dev = info["images_per_sec"], device_ips[device_key]
            print(f"[e2e] {label} ({route}): {e2e} img/s end to end from "
                  f"JPEG files ({info['decoder']} decode, --workers {cores}, "
                  f"{cores} cores, batch {E2E_BATCH}) against {dev:.1f} img/s "
                  f"device-only (phase 5, b32); device idle share ~ "
                  f"{1 - e2e / dev:.3f} (1 - end-to-end / device-only); main "
                  f"took {time.perf_counter() - t0:.1f} s with its model "
                  f"build, on {gpu}")
        cos8 = float(row_cos(embs["int8"], embs["bf16"]).min())
        print(f"[e2e] int8 vs bf16 min row cosine (limit 0.99): {cos8}")
        if cos8 < 0.99:
            raise AssertionError(f"e2e int8 embeddings disagree: {cos8}")


def word_tokenizer(seed, vocab):
    """A seeded word-hash tokenizer (BOS 1, pad 0, ids 2..vocab-1): the
    card's machine has no transformers and no LLaMA vocabulary, so the
    scorer takes it as ``tokenize``."""
    def tokenize(text):
        return [1] + [2 + zlib.crc32(f"{seed}:{w}".encode()) % (vocab - 2)
                      for w in text.split()]
    return tokenize


@torch.no_grad()
def cast_copy(model, dtype):
    """A copy of the LLaVA ``model`` on its device with every tensor in
    ``dtype`` (the plain fp32 path on the bf16 model's values), made on the
    card without a host copy."""
    from clip_embeds_tpu_torch.models.llava import Llava

    with torch.device("meta"):
        out = Llava(model.cfg).to(dtype)
    out.to_empty(device=next(model.parameters()).device)
    src = model.state_dict()
    for name, t in out.state_dict().items():
        t.copy_(src[name])
    return out.eval()


class GroupAdapter:
    """evals/whatsup.py's score_batch over VQAScorer.forward_groups: each
    sample's image against its own options, LLAVA_GROUP images a call
    (glue for this check, not a package feature)."""

    def __init__(self, scorer):
        self.scorer = scorer

    def score_batch(self, samples):
        out = []
        for s in range(0, len(samples), LLAVA_GROUP):
            chunk = samples[s : s + LLAVA_GROUP]
            out.extend(self.scorer.forward_groups(
                [p for p, _ in chunk], [list(o) for _, o in chunk]))
        return out


def event_times(fn, iters):
    """The wall time in ms of each of ``iters`` calls of fn(), between two
    CUDA events around each (the paths read scores back to the host)."""
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def counted(counters, label, fn, want):
    """fn() with every launch count set to 0 just before; the counts read
    just after must be ``want`` (0 for a kernel not named)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    expect = {k: want.get(k, 0) for k in counters}
    print(f"[vqascore] {label}: launches {got}")
    if got != expect:
        raise AssertionError(f"{label}: launches {got} != {expect}")
    return out


def check_scores(label, scores):
    if not (np.isfinite(scores).all() and (scores > 0).all()
            and (scores <= 1).all()):
        raise AssertionError(f"{label}: scores not in (0, 1]: {scores}")


def llava_paths(score, images, texts, label, counters, gpu):
    """The three VQAScore paths of ``score`` on images x texts, each with
    exact launches, then timed over LLAVA_TIME_ITERS more calls by CUDA
    events. Returns ({path:
    scores [k, n]}, {path: pairs/s})."""
    scorer = score.pair_forward.__self__
    cfg = scorer.model.cfg
    tb, layers = cfg.tower_blocks, cfg.llama.num_layers
    k, n, bs = len(images), len(texts), scorer.batch_size
    q = 7 * layers if label == "int8" else 0  # int8_linear a trunk pass
    chunks, groups = math.ceil(k * n / bs), math.ceil(k / score.group_size)
    paths = {
        "pair": (lambda: score.pair_forward(
            [im for im in images for _ in texts], list(texts) * k
        ).reshape(k, n),
            {"flash_attention": chunks * tb, "int8_linear": chunks * q}),
        "per-image": (lambda: np.stack([
            score.image_texts_forward(im, list(texts)) for im in images]),
            {"flash_attention": k * (tb + layers),
             "int8_linear": k * (1 + math.ceil(n / bs)) * q}),
        "groups": (lambda: score(list(images), list(texts)),
                   {"flash_attention": groups * (tb + layers),
                    "int8_linear": groups * 2 * q}),
    }
    scores, rates = {}, {}
    for name, (fn, want) in paths.items():
        scores[name] = counted(counters, f"{label} {name} path, {k} images "
                               f"x {n} texts", fn, want)
        check_scores(f"{label} {name}", scores[name])
        times = event_times(fn, LLAVA_TIME_ITERS)
        ms = sum(times) / len(times)
        rates[name] = k * n / ms * 1e3
        print(f"[vqascore] {label} {name}: {rates[name]:.2f} pairs/s "
              f"({k * n} pairs in {ms:.1f} ms, the mean of "
              f"{len(times)} calls; range {min(times):.1f}-"
              f"{max(times):.1f} ms) on {gpu}")
    return scores, rates


def prefill_times(scorer, images, texts, label, gpu):
    """ms of one Llava.prefill (vision tower, projector, causal trunk) at
    k = 1 and k = LLAVA_GROUP images, by CUDA events around each of
    LLAVA_PREFILL_ITERS calls after one to warm up: the mean and range."""
    for k in (1, LLAVA_GROUP):
        batch = scorer.pack_groups(images[:k], [list(texts)] * k)[2]
        ids = scorer._tensor(batch["prefix_ids"])
        valid = scorer._tensor(batch["prefix_valid"])
        px = scorer._pixels(batch["images"])
        with torch.inference_mode():
            times = event_times(lambda: scorer.model.prefill(ids, px, valid),
                                1 + LLAVA_PREFILL_ITERS)[1:]
        f = ids.shape[1] - 1 + scorer.model.cfg.n_image_tokens
        print(f"[vqascore] {label} prefill k={k} (F = {f} rows): "
              f"{sum(times) / len(times):.2f} ms, the mean of {len(times)} "
              f"calls (range {min(times):.2f}-{max(times):.2f} ms) on {gpu}")


def log_diff(a, b):
    return float(np.abs(np.log(a) - np.log(b)).max())


def answer_rows(batch):
    """[kb, n * ls] bool: the logits rows of a pack_groups batch that
    predict an answer token (each block's rows j < ls - 1 whose label
    j + 1 is kept), as forward_groups scores them."""
    from clip_embeds_tpu_torch.models.llava import IGNORE_INDEX

    ls, lab = batch["ls"], batch["labels"]
    rows = np.zeros(lab.shape, bool)
    for start in range(0, lab.shape[1], ls):
        rows[:, start : start + ls - 1] = (
            lab[:, start + 1 : start + ls] != IGNORE_INDEX)
    return torch.from_numpy(rows)


def check_plain_fp32(scorer, plain, images, texts, gpu):
    """The bf16 kernel route against the plain fp32 path (the same weights
    in fp32, plain attention, TF32 off) on LLAVA_PLAIN_IMAGES images x the
    texts through forward_groups: |delta log score| and the least cosine of
    the answer positions' logits rows, beside the bf16 no-kernel witness."""
    k = LLAVA_PLAIN_IMAGES
    batch = scorer.pack_groups(images[:k], [list(texts)] * k)[2]
    rows = answer_rows(batch)

    def run(s):
        return s._group_scores(batch), s.group_logits(batch)[
            rows.to(s.device)].float().cpu()

    (got, lg), (want, lw) = run(scorer), run(plain)
    with plain_attention():
        wit, lx = run(scorer)
    read = {"kernel": (log_diff(got, want),
                       float(F.cosine_similarity(lg, lw, dim=-1).min())),
            "witness": (log_diff(wit, want),
                        float(F.cosine_similarity(lx, lw, dim=-1).min()))}
    print(f"[vqascore] bf16 vs plain fp32 on {k} images x {len(texts)} "
          f"texts ({int(rows.sum())} answer rows): max |d log score|, min "
          f"row cosine: {read} (limits {LLAVA_FP32_LOG_TOL}, "
          f"{LLAVA_FP32_COS}) on {gpu}")
    if read["kernel"][0] > LLAVA_FP32_LOG_TOL or \
            read["kernel"][1] < LLAVA_FP32_COS:
        raise AssertionError(f"bf16 VQAScore disagrees with fp32: {read}")
    return batch, rows, lg


def write_winoground(root, n, seed):
    """Winoground format: examples.jsonl and images/<name>.png, two images
    and two captions a sample, drawn from ``seed``."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"))
    rows = []
    for i in range(n):
        for s in (0, 1):
            rng = np.random.default_rng([seed, i, s])
            low = Image.fromarray(rng.integers(0, 256, (6, 8, 3), np.uint8))
            low.resize((320, 240), Image.BICUBIC).save(
                os.path.join(root, "images", f"ex_{i}_img_{s}.png"))
        o1, o2 = OBJECTS[i % len(OBJECTS)], OBJECTS[(i + 3) % len(OBJECTS)]
        rows.append({"image_0": f"ex_{i}_img_0", "image_1": f"ex_{i}_img_1",
                     "caption_0": f"a {o1} to the left of a {o2}",
                     "caption_1": f"a {o2} to the left of a {o1}"})
    with open(os.path.join(root, "examples.jsonl"), "w") as fh:
        fh.write("\n".join(json.dumps(r) for r in rows))


def check_bundle(tmp, cfg, tokenize, counters, gpu):
    """Phase 10 (c): a score bundle in the JAX layout (config.json + fp32
    params.npz) at full width with the trunk and the tower cut to 2 layers
    each, written from the seed, loaded through the registry in bf16 and
    with quant=True, and run_benchmark on a Winoground fixture."""
    import dataclasses

    from clip_embeds_tpu_torch.core.convert import jax_params_from_llava
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.evals.benchmarks import (
        get_benchmark, run_benchmark)
    from clip_embeds_tpu_torch.scores.build import save_score_bundle
    from clip_embeds_tpu_torch.scores.registry import get_score_model

    bcfg = dataclasses.replace(
        cfg, llama=dataclasses.replace(cfg.llama, num_layers=2),
        vision=dataclasses.replace(cfg.vision, layers=2))
    t0 = time.perf_counter()
    src = init_llava(bcfg, seed=LLAVA_SEED, device="cuda",
                     dtype=torch.float32)
    n_params = sum(p.numel() for p in src.parameters())
    bundle = os.path.join(tmp, "bundle")
    save_score_bundle(bundle, "llava", bcfg, jax_params_from_llava(src),
                      conversation="chat")
    del src
    size = os.path.getsize(os.path.join(bundle, "params.npz"))
    print(f"[vqascore] bundle: {n_params / 1e9:.3f} B parameters, "
          f"params.npz {size / 2**30:.2f} GiB, written in "
          f"{time.perf_counter() - t0:.1f} s")
    root = os.path.join(tmp, "winoground")
    write_winoground(root, LLAVA_WINO, LLAVA_SEED)
    dataset = get_benchmark("winoground", root)
    calls = 2 * math.ceil(LLAVA_WINO / LLAVA_GROUP)  # 2 images a sample
    layers = bcfg.llama.num_layers
    for quant in (False, True):
        label = "int8" if quant else "bf16"
        t0 = time.perf_counter()
        score = get_score_model("llava-v1.5-7b", checkpoint=bundle,
                                tokenize=tokenize, quant=quant,
                                bos_token_id=1, pad_token_id=0)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        tensor, metrics = counted(
            counters, f"bundle {label} run_benchmark winoground",
            lambda: run_benchmark(score, dataset, batch_size=LLAVA_GROUP),
            {"flash_attention": calls * (bcfg.tower_blocks + layers),
             "int8_linear": calls * 2 * 7 * layers if quant else 0})
        check_scores(f"bundle {label}", tensor)
        metrics = {k: float(v) for k, v in metrics.items()}
        if set(metrics) != {"text", "image", "group"} or not all(
                0 <= v <= 1 for v in metrics.values()):
            raise AssertionError(f"bundle {label} metrics {metrics}")
        print(f"[vqascore] bundle {label}: loaded in {t_load:.1f} s; "
              f"winoground {LLAVA_WINO} samples {metrics} in "
              f"{time.perf_counter() - t0:.1f} s on {gpu}")
        del score
        gc.collect()
        torch.cuda.empty_cache()


def check_vqascore(counters, gpu):
    """Phase 10: LLaVA-1.5-7B VQAScore at full width and depth."""
    from clip_embeds_tpu_torch.core.factory import init_llava
    from clip_embeds_tpu_torch.evals.whatsup import (
        eval_whatsup, load_annotation)
    from clip_embeds_tpu_torch.models.llava import LlavaConfig
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear
    from clip_embeds_tpu_torch.scores.score import VQAScore
    from clip_embeds_tpu_torch.scores.vqa_score import VQAScorer

    counters = dict(counters, int8_linear=int8_linear)
    cfg = LlavaConfig()
    tok = word_tokenizer(LLAVA_SEED, cfg.llama.vocab_size)
    kw = dict(bos_token_id=1, pad_token_id=0)
    tb, layers = cfg.tower_blocks, cfg.llama.num_layers
    with tempfile.TemporaryDirectory() as tmp:
        # phase 7's What'sUp-A fixture, written again from its seed
        root = os.path.join(tmp, "whatsup")
        write_whatsup(root, 7)
        data, _ = load_annotation(root, "a")
        images = [os.path.join(root, d["image_path"][5:])
                  for d in data[:LLAVA_GROUP]]
        texts = data[0]["caption_options"][:LLAVA_TEXTS]

        # (a) bf16: the three paths
        t0 = time.perf_counter()
        model = init_llava(cfg, seed=LLAVA_SEED, device="cuda",
                           dtype=torch.bfloat16)
        torch.cuda.synchronize()
        print(f"[vqascore] LLaVA-1.5-7B (tower {tb} of "
              f"{cfg.vision.layers} blocks, trunk {layers}x"
              f"{cfg.llama.hidden_size} heads {cfg.llama.num_heads} hd "
              f"{cfg.llama.head_dim}) bf16 built on the card in "
              f"{time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        score = VQAScore(model, tok, group_size=LLAVA_GROUP, **kw)
        scorer = score.pair_forward.__self__
        bf16, _ = llava_paths(score, images, texts, "bf16", counters, gpu)
        peak_bf16 = torch.cuda.max_memory_allocated()
        prefill_times(scorer, images, texts, "bf16", gpu)
        agree = {k: log_diff(v, bf16["groups"]) for k, v in bf16.items()}
        print(f"[vqascore] bf16 paths against groups, max |d log score| "
              f"(limit {LLAVA_PATHS_LOG_TOL}): {agree}; peak "
              f"{peak_bf16 / 2**30:.2f} GiB on {gpu}")
        if max(agree.values()) > LLAVA_PATHS_LOG_TOL:
            raise AssertionError(f"the bf16 paths disagree: {agree}")

        # (b) What'sUp-A through forward_groups
        ours = GroupAdapter(scorer)
        n = LLAVA_WHATSUP
        t0 = time.perf_counter()
        res = counted(
            counters, f"What'sUp-A {n} samples",
            lambda: eval_whatsup(ours.score_batch, data[:n], root),
            {"flash_attention": math.ceil(n / LLAVA_GROUP) * (tb + layers)})
        dt = time.perf_counter() - t0
        print(f"[vqascore] What'sUp-A: {n / dt:.2f} samples/s ({n} "
              f"samples, 2 options, {dt:.1f} s) individual accuracy "
              f"{res['individual_accuracy']} on {gpu}")

        # the plain fp32 path: scores, logits rows and clear decisions
        ref = cast_copy(model, torch.float32)
        plain = VQAScorer(ref, tok, **kw)
        batch, rows, bf16_rows = check_plain_fp32(scorer, plain, images,
                                                  texts, gpu)
        check_decisions({"a": (lambda s, log: eval_whatsup(
            recorded(s.score_batch, log), data[:LLAVA_AGREE], root),
            ours, GroupAdapter(plain))}, "vqascore")
        del ref, plain
        gc.collect()
        torch.cuda.empty_cache()

        # W8A8: the trunk's seven projections a layer through int8_linear
        t0 = time.perf_counter()
        qmodel = quantize_llava_trunk(model)
        del score, scorer, ours, model
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        print(f"[vqascore] W8A8 trunk quantised on the card in "
              f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        qscore = VQAScore(qmodel, tok, group_size=LLAVA_GROUP, **kw)
        int8, _ = llava_paths(qscore, images, texts, "int8", counters, gpu)
        peak_int8 = torch.cuda.max_memory_allocated()
        prefill_times(qscore.pair_forward.__self__, images, texts, "int8",
                      gpu)
        vs = {k: log_diff(int8[k], bf16[k]) for k in int8}
        qscorer = qscore.pair_forward.__self__
        qrows = qscorer.group_logits(batch)[
            rows.to(qscorer.device)].float().cpu()
        cos = float(F.cosine_similarity(qrows, bf16_rows, dim=-1).min())
        print(f"[vqascore] int8 against bf16, max |d log score| (limit "
              f"{LLAVA_INT8_LOG_TOL}): {vs}; min answer-row logits cosine "
              f"{cos:.6f} (limit {LLAVA_INT8_COS}); peak "
              f"{peak_int8 / 2**30:.2f} GiB (bf16 {peak_bf16 / 2**30:.2f}) "
              f"on {gpu}")
        if (max(vs.values()) > LLAVA_INT8_LOG_TOL or cos < LLAVA_INT8_COS
                or peak_int8 >= peak_bf16):
            raise AssertionError(f"int8 VQAScore: {vs}, cosine {cos}, "
                                 f"peak {peak_int8} >= {peak_bf16}?")
        del qscore, qmodel
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the registry route from a score bundle
        check_bundle(tmp, cfg, tok, counters, gpu)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    # the port comes from the checkout this script sits in
    from clip_embeds_tpu_torch.cli.embed import (
        embed_image_batches, embed_text_batches, image_route, text_route)
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.models.serving import (
        fused_encode_image, fused_path_available)
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8, fused_block_residuals)

    # 1. device
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"[build] {lib._name} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    with torch.no_grad():
        kernel_results = check_kernels(rng)
        # its own inputs: the main path's requests below stay as they were
        check_gemms(np.random.default_rng(1), gpu)
        check_gemms_s8(np.random.default_rng(2), gpu)
        check_int8_linear(gpu)

    # 4. the main path at full width and depth
    t0 = time.perf_counter()
    model = create_model(MODEL, pretrained="openai", seed=0,
                         dtype=torch.bfloat16, device="cuda")
    # fp32: every attention takes the plain path (the kernel is bf16);
    # --int8 quantises from these fp32 weights, as the CLI does
    ref = create_model(MODEL, pretrained="openai", seed=0,
                       dtype=torch.float32, device="cuda")
    cfg = model.cfg
    print(f"[model] {MODEL} quick_gelu={cfg.quick_gelu} vision "
          f"{cfg.vision.layers}x{cfg.vision.width} heads {cfg.vision.heads} "
          f"text {cfg.text.layers}x{cfg.text.width}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    bf16 = torch.bfloat16
    if not (cfg.quick_gelu and fused_path_available(model)
            and text_route(model) == "fused"
            and image_route(ref, True, bf16) == "fused_int8"
            and text_route(ref, True, bf16) == "fused_int8"):
        raise AssertionError("the main paths would not reach the kernels")
    images, texts = synthetic_requests(rng, cfg)
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "fused_block": fused_block,
                "fused_block_residuals": fused_block_residuals,
                "fused_block_int8": fused_block_int8}

    def drive(label, serve):
        """Run one path with every launch count set to 0 just before."""
        for fn in counters.values():
            fn.launches = 0
        out = serve()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        print(f"[main path] {label}: launches {counts}")
        return out, counts

    n = REQUESTS * REQUEST_SIZE

    def check_embeddings(label, embs):
        for name, emb in zip(("image", "text"), embs):
            norms = np.linalg.norm(emb, axis=-1)
            if emb.shape != (n, cfg.embed_dim) or not np.isfinite(emb).all() \
                    or np.abs(norms - 1).max() > 2e-2:
                raise AssertionError(f"{label} {name} embeddings: shape "
                                     f"{emb.shape}, norms {norms.min()}.."
                                     f"{norms.max()}")

    requests = (f"{REQUESTS} image + {REQUESTS} text requests of "
                f"{REQUEST_SIZE}")
    (img, txt), launches = drive(f"bf16, {requests}", lambda: (
        embed_image_batches(model, images, REQUEST_SIZE),
        embed_text_batches(model, texts, REQUEST_SIZE)))
    if launches["flash_attention"] == 0 or launches["fused_block"] == 0:
        raise AssertionError(f"a kernel of the bf16 path never ran: "
                             f"{launches}")
    check_embeddings("bf16", (img, txt))
    img_ref = embed_image_batches(ref, images, REQUEST_SIZE)
    txt_ref = embed_text_batches(ref, texts, REQUEST_SIZE)
    with torch.inference_mode():
        fused_img = np.concatenate([
            fused_encode_image(model, torch.from_numpy(x).cuda()).float()
            .cpu().numpy() for x in images])
    cos = {"image_vs_fp32": float(row_cos(img, img_ref).min()),
           "text_vs_fp32": float(row_cos(txt, txt_ref).min()),
           "fused_image_vs_composable": float(row_cos(fused_img, img).min())}
    print(f"[main path] min row cosine (limit 0.99): {cos}")
    if min(cos.values()) < 0.99:
        raise AssertionError(f"embeddings disagree: {cos}")

    (img8, txt8), launches8 = drive(f"int8, {requests}", lambda: (
        embed_image_batches(ref, images, REQUEST_SIZE, int8=True,
                            dtype=bf16),
        embed_text_batches(ref, texts, REQUEST_SIZE, int8=True,
                           dtype=bf16)))
    # one int8 block per layer, but the last image block is CLS-only bf16
    want8 = REQUESTS * (cfg.vision.layers - 1 + cfg.text.layers)
    if launches8["fused_block_int8"] != want8:
        raise AssertionError(f"fused_block_int8 launches "
                             f"{launches8['fused_block_int8']} != {want8}")
    check_embeddings("int8", (img8, txt8))
    cos8 = {"int8_image_vs_bf16": float(row_cos(img8, img).min()),
            "int8_text_vs_bf16": float(row_cos(txt8, txt).min())}
    print(f"[main path] int8 min row cosine (limit 0.99, the JAX "
          f"package's INT8_MIN_COS): {cos8}")
    if min(cos8.values()) < 0.99:
        raise AssertionError(f"int8 embeddings disagree: {cos8}")

    # 5. throughput (device name and power limit beside every number)
    device_ips = {}
    with torch.inference_mode():
        routes = serving_routes(model, ref, images, texts, rng)
        for name, (count, fn) in routes.items():
            ms = cuda_ms(fn, iters=5, warmup=1)
            device_ips[name] = count / ms * 1e3
            print(f"[throughput] {name}: {count / ms * 1e3:.1f} "
                  f"(batch {count}, {ms:.2f} ms) on {gpu}")
    del routes, fn  # fn: the last route's call holds ref
    gc.collect()

    # 7. the eval CLI and the host image pipeline, end to end; and 8. the
    # PACL/SPARC heads, on 7's fixtures and models
    with tempfile.TemporaryDirectory() as fixtures:
        t0 = time.perf_counter()
        write_eval_fixtures(fixtures, gpu)
        check_eval(model, ref, drive, fixtures, gpu)
        t7 = time.perf_counter() - t0
        t0 = time.perf_counter()
        check_heads(model, ref, drive, fixtures, gpu)
        print(f"[phase 8] {time.perf_counter() - t0:.1f} s on {gpu}")
        t0 = time.perf_counter()
        check_siglip(drive, fixtures, gpu)
        t9 = time.perf_counter() - t0
        print(f"[phase 9] (a) and (b): {t9:.1f} s on {gpu}")
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_end_to_end(drive, device_ips, cfg.embed_dim, gpu)
    print(f"[phase 7] {t7 + time.perf_counter() - t0:.1f} s on {gpu}")
    gc.collect()
    torch.cuda.empty_cache()

    # 6. training at full width and depth, through the CLI; and 9 (c), the
    # --siglip step on the composable route
    train_launches = check_training(counters, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. LLaVA-1.5-7B VQAScore
    t0 = time.perf_counter()
    check_vqascore(counters, gpu)
    print(f"[phase 10] {time.perf_counter() - t0:.1f} s on {gpu}")

    def entry(name, source, replaces, path_launches, shape):
        """One kernel's line: the largest max |diff| over its shapes, and
        the times at ``shape``."""
        errs = [v["err"] for k, v in kernel_results.items()
                if k.split(" ")[0] == name]
        row = kernel_results[f"{name} {shape}"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path_launches[name],
                "max_abs_err": max(errs),
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}

    # times at the first serving shape for the serving kernels, at the b32
    # train step's vision shape for the training ones
    print(json.dumps({"kernels": [
        entry("fused_block", "clip_embeds_tpu_torch/csrc/fused_block.cu",
              "clip_embeds_tpu/ops/fused_block.py:170", launches,
              "4x592x1024 causal=False"),
        entry("fused_block_residuals",
              "clip_embeds_tpu_torch/csrc/fused_block.cu",
              "clip_embeds_tpu/ops/fused_block.py:286",
              train_launches["fused-train-res"], "32x577x1024 causal=False"),
        entry("fused_block_int8",
              "clip_embeds_tpu_torch/csrc/fused_block_int8.cu",
              "clip_embeds_tpu/ops/fused_block.py:442", launches8,
              "4x592x1024 causal=False"),
        entry("flash_attention", "clip_embeds_tpu_torch/csrc/attention.cu",
              "clip_embeds_tpu/ops/flash_attention.py:144", launches,
              "4x16x577x64 causal=False"),
        entry("flash_attention_bwd",
              "clip_embeds_tpu_torch/csrc/attention_bwd.cu",
              "clip_embeds_tpu/ops/flash_attention.py:160",
              train_launches["composable"], "32x16x577x64 causal=False"),
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
