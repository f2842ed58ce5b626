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
     to qdot rounded to bf16, with TOP/s and torch._int_mm's time; and
     the image tower's rows under --force-patch-dropout 0.5 (1 + 288 =
     289): fused_block and fused_block_residuals at 32x289x1024, the
     attention forward and backward at 32x16x289x64, under the limits of
     the 577-row cases; and phase 13's towers, the attention forward at
     EVA-g's 4x16x257x88 and 4x16x677x88 (blip2-itm-coco) and BLIP
     ViT-L/16's 4x16x197x64, beside scaled_dot_product_attention, and
     int8_linear at T5-XXL's projections (5120 and 64 rows; 4096 -> 4096,
     4096 -> 10240, 10240 -> 4096) with bf16 F.linear's time beside it,
     limits from scripts/chip_probe_t5.py; and phase 14's shapes: the
     attention forward at Phi-3's causal trunk (4x32x2555x96, head dim
     96, a partial last Q tile) and Phi-3-V's 68-crop tower call
     (68x16x577x64), and int8_linear at Qwen2-7B's W8A8 projections over
     1224 rows (q 3584 -> 3584 and k / v 3584 -> 512 with their biases,
     o, gate / up 3584 -> 18944, down 18944 -> 3584), limits from
     scripts/chip_probe_backbones.py; and phase 16's shapes: the attention
     forward and backward at CoCa ViT-L/14's b32 train step
     (32x16x257x64, a partial last Q tile) and the forward at a b4 tower
     call (4x16x257x64), beside scaled_dot_product_attention, and
     int8_linear at the W8A8 trunk's decode steps (1 and 8 rows: one row a
     prompt; 4096 -> 4096, 4096 -> 11008, 11008 -> 4096) with bf16
     F.linear's time beside it, limits from
     scripts/chip_probe_generate.py; and phase 17's shapes: the attention
     forward at EVA01-g-14's b32 tower call (32x16x257x88) beside
     scaled_dot_product_attention, and fused_block / fused_block_int8 at
     ViT-H-14-378's b4 image request (730 rows padded to 736, width 1280,
     16 heads of 80, MLP 5120, exact GELU) under the ViT-L limits;
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
 11. (run last, on phase 10's bf16 LLaVA-1.5-7B, which phase 10 keeps on
     the host while it measures its W8A8 twin, and that twin) VLM2Vec: (a)
     embed_last_token on image query rows and text target rows and
     embed_mixed on a mixed batch of the synthetic route (64 tokens a row,
     639 trunk rows with an image) at b8 and b16, bf16 and W8A8, with exact
     launches (flash_attention 23 a tower call, none in the padded trunk;
     int8_linear 224 a W8A8 trunk pass), finite unit-norm embeddings, the
     mixed batch against its rows on their own paths, bf16 against the
     plain fp32 path beside the no-kernel witness, W8A8 against bf16,
     embeds/s by CUDA events and peak memory; (b') the LoRA adapters'
     gradients on a 2-layer cut of the trunk at full width, bf16 against
     plain fp32 beside the witness and W8A8 against its witness; (b)
     cli/train_vlm2vec.py main on the synthetic mixed route, 3 steps at
     b64 with GradCache and LoRA r16 alpha 64 in bf16, on the bf16 base
     and with --quant_base, exact launches, finite losses, every adapter
     moved, the base bit-equal, samples/s and peak memory, on the 7B
     cut to its first 8 trunk layers at full width; (c)
     cli/eval_mmeb.py main on an MMEB fixture (2 subsets x 16 queries x 8
     candidates, JPEGs) with (b)'s adapters merged and over the W8A8
     trunk (the same cut), exact launches, accuracies in [0, 1], the embedding cache read
     back, items/s; (d) (b)'s merged bundle, cut to 2 + 2 layers, through
     scores/build.py load_score_bundle. Limits from
     scripts/chip_probe_vlm2vec.py.
 12. (run after 6, on its seed-0 ViT-L/14-336 weights, before 10) the
     source's CLIP fine-tune recipe and the real-data loaders through
     cli/train.py main, on fixtures written from the seed: (a) 256 JPEGs
     of mixed sizes (every eighth wider than 2:1, where RandomResizedCrop
     falls back to a centre crop), half under an LCS-558K root, half
     under a DataMix-665K root, a LLaVA annotation JSON (1-3 answer turns,
     a third with left/right phrases, a few entries without an image),
     leftright.json, a TSV and two tar shards with one undecodable
     member; (b) --lock-image --usehardtext --augfiles leftright.json
     --dataset-type datamix, 4 steps at b32 on the composable and
     fused-train-res routes: exact launches a step, finite losses, every
     visual.* tensor bit-equal and every other moved, each batch's
     hard_valid sum as the fixture implies, samples/s end to end and the
     host's share (time in next() of the data iterator), peak memory,
     beside phase 6's synthetic b32 rate; (c) the recipe's gradients at
     b8 on a datamix batch against the plain fp32 composable path, beside
     the no-kernel witness, under phase 6's limits; (d)
     --force-patch-dropout 0.5 unlocked, 2 steps at b32 on phase 6's
     three routes with their launches, the image blocks at 289 rows; (e)
     one step each of --dataset-type csv, webdataset (--no-train-aug: raw
     bytes through the batch decoder) and auto on the .tsv and the .tar,
     composable with --lock-image, the undecodable sample dropped and the
     batch refilled.
 13. (run last, after 11) the T5 and BLIP score families at full width,
     seeded random weights, on 8 What'sUp-A images x 4 texts: (a)
     CLIP-FlanT5-XXL (ViT-L/14-336 to layer -2, the projector to 4096,
     T5-v1.1-XXL 24 + 24 layers of 4096, 64 heads of 64, d_ff 10240)
     through the T5VQAScore Score's pair path, forward_image_texts and
     forward_groups, bf16 and with the W8A8 T5 trunk
     (quantize_clip_t5_trunk), with exact launches (flash_attention 23 a
     tower call, int8_linear 432 a T5 pass), scores in (0, 1] and spread,
     the paths against each other, bf16 against the plain fp32 path on
     the T5 cut to 4 + 4 layers beside the no-kernel witness (|delta log
     score| and the answer rows' logits cosine), W8A8 against bf16,
     pairs/s and peak memory; (b) InstructBLIP-FlanT5-XXL (EVA-g, the
     Q-Former, the same T5 trunk) through forward and
     forward_image_texts, flash_attention 39 an EVA-g call, the same
     checks; (c) blip2-itm, blip2-itc and image-reward-v1 from seeded
     fp32 bundles in the JAX layout, held in memory, through
     scores.registry.get_score_model in bf16, exact launches, against the
     plain fp32 path. Limits from scripts/chip_probe_t5.py.
 14. (run last, after 13) VLM2Vec's other backbones at full width from
     seeded weights, one at a time: Phi-3.5-V (Phi-3-mini 32 x 3072, 32
     heads of 96, ViT-L/14-336 to layer -2) and Qwen2-VL-7B (the 32 x
     1280 tower with 2-D RoPE, 28 x 3584 trunk layers, GQA 28/4, M-RoPE)
     at full depth, Qwen2-VL also with the W8A8 trunk
     (quantize_llava_trunk, int8_linear with q/k/v biases); LLaVA-NeXT
     (anyres 672^2, the 7B trunk) and Qwen2.5-VL-7B (the window tower)
     with their trunks cut to 8 layers. Each serves b4 image query rows
     (Phi-3-V: a square and a 2:1 image, 1 + 16 HD crops; LLaVA-NeXT: two
     square and two 2:1 images in one call; Qwen: 448^2, 16 windows),
     text target rows, a mixed batch and the forward's logits through
     embed_last_token / forward, each family's own host processor on
     seeded images, with exact launches (flash_attention 23 a CLIP tower
     call, the trunk's layers more on the unmasked forward, none in a
     masked trunk or a Qwen tower; int8_linear 196 a W8A8 trunk pass),
     finite unit-norm embeddings, the mixed batch against its rows each on
     its own, bf16 against the plain fp32 path on the trunk cut to 2
     layers (the witness beside it), W8A8 against bf16, embeds/s by CUDA
     events and peak memory. Limits from scripts/chip_probe_backbones.py.
 15. (run after 12, in its fixture directory on phase 6's seed-0
     weights) the rest of the CLIP training loop through cli/train.py
     main: (a) --distill-model ViT-L-14-336 --distill-pretrained with a
     teacher state dict written from the seed, 3 steps at b32 on the
     composable route with exact launches (the teacher's forward adds 24
     flash_attention a step), the teacher bit-equal and without gradients,
     distilled samples/s by CUDA events beside phase 6's plain rate, peak
     memory, and the distillation gradients at b8 against the plain fp32
     path beside the no-kernel witness under phase 6's limits; (b) one
     epoch at lr 0 on the recipe's TSV with --val-data (256 pairs) and
     --imagenet-val (10 classes x 8 JPEGs, the shipped 1000-class,
     80-template metadata: 100 classifier calls of 800 prompts) on the
     composable and fused-train-res routes, exact launches of the eval
     passes, validation samples/s, the classifier's seconds and prompts/s,
     the results.jsonl lines, and the val features, |delta clip_val_loss|,
     the classifier on 50 classes and the zero-shot logits against the
     plain fp32 path with their clear decisions; evals/flickr.py
     evaluate_retrieval on 64 JPEGs x 5 captions; (c) 2 epochs with
     --delete-previous-checkpoint, blocking saves, then --async-checkpoints
     with --remote-sync to a local mirror every second: each epoch's wall,
     the mirror byte-equal to the commits and without .tmp_* files. Limits
     from scripts/chip_probe_train_loop.py.
 16. (run after 11, on phase 10's bf16 LLaVA-1.5-7B and its W8A8 twin)
     generation and CoCa: (a) models/generate.py llava_greedy_generate
     at b1 and b8 on What'sUp-A images, one image a prompt of 64 ids (639
     trunk rows), 32 new tokens, no eos, bf16 and W8A8, with exact
     launches (flash_attention 23 + 32 a call, none in a decode step;
     int8_linear 224 x 32), the tokens against the argmax of the model's
     own teacher-forced full forward wherever its top-2 margin clears
     GEN_MARGIN, the same at b8 on the W8A8 twin with static activation
     scales (calibrated on that forward, so a row's quantisation does not
     depend on the rows beside it), bf16 against the plain fp32 path on
     the trunk cut to 2 layers beside the no-kernel witness (the first
     token's logits cosine, the tokens up to the first low-margin step),
     W8A8 against bf16 (a reading), tokens/s and ms a decode step from
     the median of 3 warm calls and prefill ms by CUDA events, peak
     memory with the cache; (b) coca_ViT-L-14 at full width and depth
     (24 x 1024 tower at 224/14, 12 x 768 text, 12 x 768 decoder, vocab
     49408), seeded on the card: encode_image at b32 and encode_text at
     b256 with exact launches (24 a tower call), finite unit-norm
     embeddings against the plain fp32 path; coca_sample_generate top-k 1
     and top-p 0.1 and coca_beam_generate with 6 beams at b8, seq_len 30:
     well-formed tokens, top-k 1 against the teacher-forced
     caption_logits' argmax where the margin clears COCA_MARGIN,
     captions/s; (c) cli/train.py main --model coca_ViT-L-14 with both
     loss weights, 3 steps at b32 in bf16: exact launches (#4 and #5, 24
     each a step), finite contrastive and caption losses, moved
     parameters, samples/s and peak memory by CUDA events, the b8
     gradients against the plain fp32 path beside the witness under
     phase 6's limits. Limits from scripts/chip_probe_generate.py.

 17. (run last, after 14) the open_clip tower zoo from seeded weights, at
     the published widths: (a) EVA01-g-14 at full width and depth through
     cli/embed.py main (64 JPEGs at b32, 256 captions at b256), bf16 and
     the plain fp32 path (--fp32: every attention plain), row cosine >=
     ZOO_COS, exact launches (#4 40 a tower call; the 77-token texts
     none), img/s and texts/s end to end and on the card; (b) one registry
     model per remaining family at b8 against its plain fp32 path:
     ViT-H-14-378 on the fused bf16 route and --int8 (int8 against bf16 >=
     ZOO_COS), EVA02-L-14-336, EVA02-E-14, RN50x64, convnext_xxlarge,
     ViTamin-L-336, swin_base_patch4_window7_224,
     vit_medium_patch16_gap_256, vit_relpos_medium_patch16_cls_224,
     MobileCLIP-B, MobileCLIP-S2, the hf-text CLIPs
     xlm-roberta-large-ViT-H-14, mt5-xl-ViT-H-14 and nllb-clip-large-siglip
     (images and masked texts), and LLM2CLIP (ViT-L/14-336 and its
     adapter); exact launches (#4 on the ViT / SigLIP towers, none on the
     plain towers and texts), row cosine >= ZOO_COS, img/s on the card.
     No depth is cut.
 18. training on the zoo towers and the last entry points (ROADMAP.md
     items 15c, 15b, 7b): (a) cli/train.py main --model EVA01-g-14 at full
     width and depth from seeded weights, Z18_STEPS steps at Z18_BATCH on
     composable blocks, bf16 over fp32 masters, exact #4 / #5 launches a
     step (Z18_ROUTES), samples/s and the peak, and one step's gradients at
     Z18_GRAD_BATCH against the same step with every attention plain,
     cosine >= Z18_GRAD_COS for each of the tower's 40 blocks; (b) the same
     with --fused-train-blocks --fused-train-backward residual (the text
     tower's #1 / #2), its first loss within Z18_LOSS_TOL of (a)'s; (c) one
     step at Z18_FAMILY_BATCH of each other zoo family at its registry size
     (no kernel launched) and EVA02-E-14 with --lock-image; unlocked, at
     Z18_BATCH, EVA02-E-14 runs out of the card's memory; (d) cli/profile.py
     --model EVA01-g-14 ViT-L-14-336 --trace: the CSV rows and the traces;
     (e) an EVA01-g-14 bundle through core/export.py, written and loaded
     on the card, the same embeddings; (f) image/preprocess.py
     jax_preprocess on the card against the CPU. Phase 3 holds #5 at
     EVA01-g-14's 32x16x257x88 (head dim 88, padded to the 128 kernel).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import logging
import math
import os
import shutil
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
# phase 3, the towers of the T5 and BLIP score families (phase 13): the
# attention forward at EVA-g's 257 rows (16 heads of 88, a partial last Q
# tile), at blip2-itm-coco's 677 and at BLIP ViT-L/16's 197 (head dim
# 64), b4; the limit on the mean |kernel - plain| between the sound
# readings on the H100 (8.1e-5 / 6.2e-5 / 8.1e-5) and the faults'
# (scripts/chip_probe_t5.py: logits at 1/sqrt(128) 0.0156 / 0.0102 /
# 0.0284; the last partial Q tile unwritten 3.1e-4 / 0.0027 / 0.032, which
# the max limit catches too); and int8_linear at T5-XXL's W8A8
# projections: the encoder's rows of a b8 call (5120 = 8 x 640) and the
# decoder's (64 = 8 x 8, a partial M tile) through q/k/v/o (4096 ->
# 4096), wi_0 / wi_1 (4096 -> 10240) and wo (10240 -> 4096)
T5_FAMILY_FLASH_CASES = (((4, 16, 257, 88), False, 2e-4),
                         ((4, 16, 677, 88), False, 2e-4),
                         ((4, 16, 197, 64), False, 2e-4))
T5_INT8_LINEAR_CASES = tuple((m, n, k) for m in (5120, 64)
                             for n, k in ((4096, 4096), (10240, 4096),
                                          (4096, 10240)))
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
# and one call's time spreads up to 1.8x from one machine to the next (one
# call after the counted one, not three, since phase 18 came: the script's
# time budget)
LLAVA_TIME_ITERS, LLAVA_PREFILL_ITERS = 1, 5
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
# phase 11: VLM2Vec over phase 10's LLaVA-1.5-7B and its W8A8 trunk:
# embeddings at V2V_BATCHES (64-token rows: 639 trunk rows with an image);
# the training CLI's synthetic mixed route, V2V_TRAIN_STEPS steps at the
# reference recipe's batch 64 with GradCache and LoRA at the JAX defaults
# (r 16, alpha 64; the CLI's default targets q/k/v/o/down), its chunk per
# route: 2 rows a side on the bf16 base (JAX's default; no remat, as in
# JAX: ~7.7 GB of activations a 639-token row by its widths, the plain
# fp32 attention's among them), 16 with --quant_base (remat);
# the adapters' gradients at V2V_GRAD_BATCH; the MMEB eval CLI on a
# fixture of 2 subsets x V2V_EVAL_QUERIES queries x V2V_EVAL_CANDS
# candidates in batches of V2V_EVAL_BATCH
V2V_SEED, V2V_TOKENS, V2V_BATCHES, V2V_TIME_ITERS = 11, 64, (8, 16), 3
V2V_TRAIN_BATCH, V2V_TRAIN_STEPS, V2V_RANK, V2V_ALPHA = 64, 3, 16, 64
# (b) and (c) run on the 7B cut to its first V2V_TRAIN_LAYERS trunk layers
# at full width (the tower whole): at all 32 they took 148 s of host-bound
# launches, time that phases 13 and 16 need
V2V_TRAIN_LAYERS = 4
V2V_CHUNK = {"bf16": 2, "quant_base": 16}
V2V_GRAD_BATCH = 2
V2V_EVAL_QUERIES, V2V_EVAL_CANDS, V2V_EVAL_BATCH = 16, 8, 8
# limits on the least row cosine of the embeddings at b8. Readings on the
# H100 (scripts/chip_probe_vlm2vec.py; PERF.md): the bf16 kernel route
# against plain fp32 0.99764, the no-kernel witness 0.99741, the mixed
# batch against its rows on their own paths 0.99922, where the imageless
# rows' image block left visible reads 0.0046 / 0.0064 and pooling one
# token past the last 0.063; W8A8 against bf16 0.8955 (the mixed batch:
# its per-tensor activation scales span the masked image blocks; image
# rows 0.9598), its codes at a quarter of their range 0.4586
V2V_SPLIT_COS = 0.99     # a mixed batch against its rows on their own paths
V2V_FP32_COS = 0.99      # bf16 kernel route against plain fp32
V2V_INT8_COS = 0.8       # W8A8 against bf16
# the gradient check runs on the 7B's first V2V_GRAD_LAYERS trunk layers
# (full width): through all 32 random layers bf16 rounding alone turns the
# adapters' gradients (cosine over all against plain fp32: kernel route
# 0.352, witness 0.382 at temperature 0.02; 0.459 / 0.478 for a linear
# readout of the embeddings). On the cut (readings on the H100,
# scripts/chip_probe_vlm2vec.py; PERF.md), cosine over all / least per
# tensor: the bf16 kernel route against plain fp32 0.99378 / 0.99112, the
# witness 0.99243 / 0.98959, the imageless rows' image block left visible
# 0.290 / 0.026; the W8A8 kernel route against its witness 0.98188 /
# 0.95342 (a tower's bf16 rounding moves some activation codes), with the
# dynamic scale's gradient dropped 0.95661 / 0.63816
V2V_GRAD_LAYERS = 2
V2V_GRAD_COS_MIN, V2V_GRAD_TENSOR_COS_MIN = 0.99, 0.95
V2V_GRAD_BELOW_WITNESS = 5e-4
V2V_INT8_GRAD_COS_MIN, V2V_INT8_GRAD_TENSOR_COS_MIN = 0.97, 0.85
# phase 13: the T5 and BLIP score families at full width, seeded random
# weights (ROADMAP item 13). (a) CLIP-FlanT5-XXL (ViT-L/14-336 to layer
# -2, 23 blocks; the projector to 4096; T5-v1.1-XXL 24 + 24 layers, 64
# heads of 64, d_ff 10240) through the three T5VQAScorer paths on
# T5_GROUP What'sUp-A images x T5_TEXTS texts, bf16 and W8A8; (b)
# InstructBLIP-FlanT5-XXL (EVA-g 39 x 1408, the 12-layer Q-Former, the
# same seeded T5-XXL trunk) through forward and forward_image_texts; (c)
# blip2-itm, blip2-itc and image-reward-v1 from seeded fp32 bundles
# through get_score_model, on the same images and texts
T5_SEED, T5_GROUP, T5_TEXTS, T5_TIME_ITERS = 13, 8, 4, 2
# the plain fp32 reference runs the T5 trunk cut to its first
# T5_CUT_LAYERS encoder and decoder layers at full width (the towers and
# the Q-Former whole: 44.6 GB of fp32 XXL would not sit beside the bf16
# model), on T5_PLAIN_IMAGES images x the texts; the bf16 kernel route
# and the no-kernel witness on the same cut
T5_CUT_LAYERS, T5_PLAIN_IMAGES = 4, 2
# the seeded scores must spread: (max - min) / max over the 32 pairs
T5_SPREAD_MIN = 1e-6
# limits on |delta log score| and the least cosine of the answer rows'
# logits. Readings on the H100 (scripts/chip_probe_t5.py; PERF.md): the
# bf16 paths against each other 0 (CLIP-FlanT5) and 0.0019
# (InstructBLIP); bf16 against plain fp32 on the cut 0.0118 / 0.99996
# and 0.0089 / 0.99995, the no-kernel witness 0.0076 / 0.99997 and
# 0.0145 / 0.99994, the T5 attention scaled by d_kv^-1/2 (a fault) 0.169
# / 0.956 and 0.174 / 0.950, InstructBLIP's Q-Former cross-attention
# skipped 0.508 / 0.753; the encoder's relative bias dropped reads 0.0152
# / 0.99995, which seeded weights cannot tell from sound (its table's
# std d_model^-1/2 moves the logits little). W8A8 against bf16 at full
# depth: CLIP-FlanT5 0.036-0.090 / 0.99820, InstructBLIP 0.089-0.175 /
# 0.99791; with every projection's codes at a quarter of their range
# 0.175 / 0.98796 and 0.265 / 0.98440. The cosine tells that fault from
# sound; |d log score| does not, and its limit holds gross faults only
T5_PATHS_LOG_TOL = 0.05        # the bf16 paths against each other
T5_FP32_LOG_TOL = 0.05         # bf16 kernel route against plain fp32 (cut)
T5_FP32_COS = 0.9995
T5_INT8_LOG_TOL = 0.3          # W8A8 against bf16
T5_INT8_COS = 0.995
# (c): limits on |delta| against the plain fp32 path of the ITM
# probability, the ITC cosine and the standardised reward. Readings:
# 0.0021, 0.0024, 0.0209; with the text mask ignored (a fault) ITM 0.033,
# the reward 0.504
BLIP_ITM_TOL, BLIP_ITC_TOL, REWARD_TOL = 0.01, 0.01, 0.1
# phase 14: VLM2Vec's other backbones at full width, seeded weights
# (ROADMAP item 14): Phi-3.5-V (Phi-3-mini 32 x 3072, 32 heads of 96, and
# ViT-L/14-336 to layer -2) and Qwen2-VL-7B (the 32 x 1280 tower, 28 x
# 3584 trunk layers, GQA 28/4 at hd 128, M-RoPE) at full depth, Qwen2-VL
# also with the W8A8 trunk; LLaVA-NeXT (ViT-L/14-336, anyres 672^2, the
# 7B trunk) and Qwen2.5-VL-7B (the window tower) with their trunks cut to
# VB_TRUNK_CUT layers. VB_BATCH rows a call: image query rows (8 to
# VB_TEXT text tokens after the image), text target rows (under
# VB_TARGET), a mixed batch; Phi-3-V images of PHI_SIZES (w, h) at
# hd_num PHI_HD_NUM (grids 4 x 4 and 3 x 5: 68 crops in a tower call),
# LLaVA-NeXT NEXT_SIZES, the Qwen towers QWEN_SIZE^2 (256 image tokens;
# 16 windows)
VB_SEED, VB_BATCH, VB_TIME_ITERS = 14, 4, 3
VB_TEXT, VB_TARGET = 45, 64
PHI_HD_NUM, QWEN_SIZE = 16, 448
PHI_SIZES = {"square": (480, 480), "2:1": (640, 320)}
NEXT_SIZES = ((600, 600), (800, 400))
VB_TRUNK_CUT, VB_PLAIN_LAYERS = 8, 2
# limits on the least row cosine (readings on the H100,
# scripts/chip_probe_backbones.py; PERF.md): a mixed batch against its rows
# each on its own, bf16 against the plain fp32 path on the trunk cut to
# VB_PLAIN_LAYERS layers (the witness printed beside it), W8A8 against bf16
VB_SPLIT_COS, VB_FP32_COS, VB_INT8_COS = 0.995, 0.9998, 0.8
# phase 3, the attention forward at phase 14's new shapes: Phi-3's causal
# trunk at hd 96 over a square-image batch (1 + 2509 + 45 = 2555 rows, a
# partial last Q tile) and Phi-3-V's tower call over 4 x (1 + 16) crops;
# limits on the mean |kernel - plain| from scripts/chip_probe_backbones.py
VB_FLASH_CASES = (((4, 32, 2555, 96), True, 5e-4),
                  ((68, 16, 577, 64), False, 5e-4))
# phase 3, int8_linear at Qwen2-7B's W8A8 projections over a b4 request's
# rows (4 x 306 = 1224): q (3584 -> 3584) and k / v (3584 -> 512) with
# their biases, o (3584 -> 3584), gate / up (3584 -> 18944) and down
# (18944 -> 3584); (M, N, K, bias)
QWEN_INT8_LINEAR_CASES = ((1224, 3584, 3584, True), (1224, 512, 3584, True),
                          (1224, 3584, 3584, False),
                          (1224, 18944, 3584, False),
                          (1224, 3584, 18944, False))
# phase 3, phase 16's shapes: CoCa ViT-L/14's tower (16 heads of 64 over
# 1 + 256 = 257 rows, a partial last Q tile) in the b32 train step,
# forward and backward, and at a b4 call; int8_linear at the W8A8 trunk's
# decode steps, one row a prompt at b1 and b8, through the trunk's three
# projection shapes. Mean limits: the backward's as FLASH_CASES', the
# forward's as T5_FAMILY_FLASH_CASES' at 257 rows, from
# scripts/chip_probe_generate.py
GEN_FLASH_TRAIN_CASES = (((32, 16, 257, 64), False, 2e-5),)
GEN_FLASH_CASES = (((4, 16, 257, 64), False, 2e-4),)
GEN_INT8_LINEAR_CASES = tuple((m, n, k) for m in (1, 8)
                              for n, k in ((4096, 4096), (11008, 4096),
                                           (4096, 11008)))
# phase 3, the zoo's new shapes (phase 17): the attention forward at
# EVA01-g-14's b32 tower call (257 rows, 16 heads of 88) under the EVA-g
# limit of T5_FAMILY_FLASH_CASES, and ViT-H-14-378's b4 image block (730
# rows padded to 736, width 1280, head dim 80, MLP 5120, exact GELU)
# through fused_block and fused_block_int8 under the ViT-L serving limits
ZOO_FLASH_CASES = (((32, 16, 257, 88), False, 2e-4),)
ZOO_BLOCK_CASES = (((4, 736, 1280, 16, 730, False), 0.004, None, 0.012),)
# phase 17: the open_clip tower zoo (ROADMAP.md item 15) from seeded
# weights at the published widths and depths. (a) EVA01-g-14 through
# cli/embed.py: ZOO_EVA_IMAGES JPEGs at ZOO_EVA_BATCH, ZOO_EVA_TEXTS
# captions at ZOO_EVA_TEXT_BATCH; (b) ZOO_CLIPS and ZOO_HF_TEXT at
# ZOO_BATCH, and LLM2CLIP; device times over ZOO_TIME_ITERS calls. Every
# route against its plain fp32 path at PERF.md §2's row cosine, and
# ViT-H-14-378's int8 route against its bf16 one at bench.py's
# INT8_MIN_COS (the same 0.99)
ZOO_SEED, ZOO_COS, ZOO_BATCH, ZOO_TIME_ITERS = 17, 0.99, 8, 3
ZOO_EVA_IMAGES, ZOO_EVA_BATCH, ZOO_EVA_TEXTS, ZOO_EVA_TEXT_BATCH = \
    64, 32, 256, 256
ZOO_CLIPS = ("EVA02-L-14-336", "EVA02-E-14", "RN50x64", "convnext_xxlarge",
             "ViTamin-L-336", "swin_base_patch4_window7_224",
             "vit_medium_patch16_gap_256",
             "vit_relpos_medium_patch16_cls_224", "MobileCLIP-B",
             "MobileCLIP-S2")
ZOO_HF_TEXT = ("xlm-roberta-large-ViT-H-14", "mt5-xl-ViT-H-14",
               "nllb-clip-large-siglip")
ZOO_TEXT_LEN = 32
# phase 3, phase 18's shape: the attention backward at EVA01-g-14's b32
# train step (32x16x257x88: head dim 88, which the backward pads to its
# 128-wide kernel), under the mean limit of FLASH_CASES
ZOO_FLASH_TRAIN_CASES = (((32, 16, 257, 88), False, 2e-5),)
# phase 18: training on the zoo towers (ROADMAP.md item 15c) and the last
# entry points (15b, 7b), from seeded weights drawn on the card. The
# training CLI's routes on EVA01-g-14 and each kernel's launches a step:
# the tower's 40 blocks on composable blocks (#4 forward, #5 backward), the
# 77-token text tower on plain attention, or with --fused-train-blocks
# --fused-train-backward residual on #1 (forward) and #2 (the residual
# backward's recompute), 12 blocks
Z18_MODEL, Z18_SEED = "EVA01-g-14", 18
Z18_STEPS, Z18_BATCH, Z18_GRAD_BATCH, Z18_FAMILY_BATCH = 3, 32, 8, 8
Z18_ROUTES = {
    "composable": ([], {"flash_attention": 40, "flash_attention_bwd": 40}),
    "fused-train-res": (["--fused-train-blocks", "--fused-train-backward",
                         "residual"],
                        {"flash_attention": 40, "flash_attention_bwd": 40,
                         "fused_block": 12, "fused_block_residuals": 12}),
}
# one step's gradients on the flash route against the same step with every
# attention plain (the bf16 model both times): the least cosine over a
# tower block's parameters; the routes' first losses (the same weights and
# batch) within bf16 noise
Z18_GRAD_COS, Z18_LOSS_TOL = 0.99, 0.02
Z18_FAMILIES = ("EVA02-L-14-336", "RN50x64", "convnext_xxlarge",
                "ViTamin-L-336", "swin_base_patch4_window7_224",
                "vit_medium_patch16_gap_256",
                "vit_relpos_medium_patch16_cls_224", "MobileCLIP-B")
# the export round trip's batch, and the preprocess check's photos (h, w)
# and its limit on |card - CPU| (fp32 filters summed in another order)
Z18_EXPORT_BATCH, Z18_PREPROCESS_PHOTO, Z18_PREPROCESS_TOL = 4, (480, 640), \
    1e-4
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12
# phase 3, the image tower under --force-patch-dropout 0.5: 1 + 288 = 289
# rows (a partial last tile where 577 had its own), fused_block and
# fused_block_residuals at b32 and the attention forward and backward at
# 32x16x289x64, under the limits of the 577-row cases; their own inputs
PATCH_DROP_BLOCK_CASES = (((32, 289, 1024, 16, 289, False), 0.004, 0.004,
                           None),)
PATCH_DROP_FLASH_CASES = (((32, 16, 289, 64), False, 2e-5),)
# phase 12: the source's CLIP fine-tune recipe (open_clip train-clip.sh:
# --lock-image --usehardtext --augfiles leftright.json on LLaVA's
# LCS-558K + DataMix-665K) through cli/train.py main on phase 6's
# ViT-L/14-336 weights, on fixtures written from RECIPE_SEED: RECIPE_JPEGS
# JPEGs of mixed sizes, RECIPE_SAMPLES annotated (RECIPE_STEPS steps at
# TRAIN_BATCH; 1-3 answer turns, every turn of a third of them with a
# left/right phrase, RECIPE_NO_IMAGE entries without an image), a TSV of
# RECIPE_TSV rows and two tar shards of RECIPE_TAR samples, one of them
# undecodable (one step each at TRAIN_BATCH). The recipe's routes and
# their launches a step: the locked image tower runs forward only (24
# blocks), the text tower twice (the 32 texts, then the 8 hard texts, 12
# blocks each, 77 tokens: plain attention)
RECIPE_SEED, RECIPE_JPEGS, RECIPE_SAMPLES, RECIPE_NO_IMAGE = 12, 256, 144, 6
RECIPE_STEPS, RECIPE_TSV, RECIPE_TAR = 4, 48, 33
RECIPE_ROUTES = {
    "composable": ([], {"flash_attention": 24}),
    "fused-train-res": (["--fused-train-blocks", "--fused-train-backward",
                         "residual"],
                        {"fused_block": 24 + 12 + 12,
                         "fused_block_residuals": 12 + 12}),
}
# phase 12 (d): --force-patch-dropout 0.5 unlocked, PATCH_DROP_STEPS steps
# at TRAIN_BATCH on each of phase 6's routes, with phase 6's launches
PATCH_DROP, PATCH_DROP_ROWS, PATCH_DROP_STEPS = 0.5, 289, 2
# phase 15: the rest of the CLIP training loop through cli/train.py main
# (ROADMAP items 5f, 5g and 5c's distillation half), in phase 12's fixture
# directory on phase 6's seed-0 weights. (a) --distill-model MODEL
# --distill-pretrained teacher.pt (phase 6's weights, each entry but the
# logit scale scaled by 1 + LOOP_TEACHER_NOISE x a seeded normal),
# LOOP_DISTILL_STEPS steps at TRAIN_BATCH, composable; (b) one epoch on
# the recipe's TSV (RECIPE_TSV // TRAIN_BATCH = 1 step) at lr 0, so that
# the evals see phase 6's weights on both RECIPE_ROUTES and one plain
# fp32 reference serves both,
# with --val-data over LOOP_VAL_SAMPLES of phase 12's JPEGs and
# --imagenet-val over LOOP_ZS_CLASSES class dirs x LOOP_ZS_PER_CLASS
# JPEGs on the shipped 1000-class, 80-template metadata (100 classifier
# calls of 800 prompts); the plain fp32 reference's classifier on
# LOOP_ZS_REF_CLASSES classes (the fixture's 10 and more drawn from
# LOOP_SEED: the 80,000 prompts in fp32 would take ~20 s a run), and
# evals/flickr.py evaluate_retrieval over LOOP_FLICKR_IMAGES JPEGs x 5
# captions; (c) LOOP_CKPT_EPOCHS epochs of the TSV with blocking saves,
# then with --async-checkpoints and a local --remote-sync mirror
LOOP_SEED, LOOP_TEACHER_NOISE, LOOP_DISTILL_STEPS = 15, 0.1, 3
LOOP_VAL_SAMPLES, LOOP_ZS_CLASSES, LOOP_ZS_PER_CLASS = 256, 10, 8
LOOP_ZS_REF_CLASSES, LOOP_FLICKR_IMAGES, LOOP_CKPT_EPOCHS = 50, 64, 2
# limits of (b) against the plain fp32 reference (readings on the H100,
# scripts/chip_probe_train_loop.py; PERF.md): the val features' least row
# cosine, |delta clip_val_loss|, the classifier columns' least cosine and
# the largest |delta| of the zero-shot logits (logit scale 100). Sound, on
# either route: 0.99990, 2.6e-5-1.4e-4, 0.99997, 0.19-0.20. Faults, each on
# the bf16 composable model: patch dropout 0.5 left on 0.99759 (image) and
# 0.489; the val loss at the logit scale's parameter instead of its exp
# 0.0155; the classes indexed one off 0.8918 and 3.70; the
# classifier's columns not renormalised 0.728 (its cosines are blind to it)
LOOP_VAL_COS, LOOP_VAL_LOSS_TOL = 0.999, 0.002
LOOP_ZS_COL_COS, LOOP_ZS_LOGIT_TOL = 0.999, 0.4


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


def card_randn(rng, *shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
    """mean + std x normal draws of ``shape``, made on the card from a
    CUDA generator seeded by the numpy ``rng``: drawn on the host, phase
    3's operands (tens of millions of draws a case) took most of the
    phase."""
    g = torch.Generator("cuda").manual_seed(int(rng.integers(2 ** 62)))
    return (mean + std * torch.randn(shape, generator=g,
                                     device="cuda")).to(dtype)


def block_inputs(rng, b, n, d, mlp, bias_std=0.5):
    """fused_block inputs at trained-like scales, bf16 on the card. The
    biases are large (std 0.5) so that a kernel which drops one moves the
    mean |diff| far past the limits below."""
    def t(*shape, std=1.0, mean=0.0):
        return card_randn(rng, *shape, std=std, mean=mean)

    ln = lambda: torch.stack([t(d, std=0.1, mean=1.0), t(d, std=0.1)])
    return (t(b, n, d), t(3 * d, d, std=d ** -0.5), t(3 * d, std=bias_std),
            t(d, d, std=0.02), t(d, std=bias_std),
            t(mlp, d, std=(2 * d) ** -0.5), t(mlp, std=bias_std),
            t(d, mlp, std=0.02), t(d, std=bias_std), ln(), ln())


def int8_block_inputs(args, heads, kv, causal, act="quick", eps=1e-5):
    """fused_block_int8 inputs from fused_block's: the weights quantised by
    the port's quantize_weight, the static scales calibrated by a dynamic
    pass over the same x of a quantised ResidualAttentionBlock (QuickGELU,
    or exact GELU for act "erf") or, for act "tanh", a quantised
    SiglipBlock (bidirectional)."""
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
        block = ResidualAttentionBlock(d, heads, mlp / d,
                                       quick_gelu=act == "quick",
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

    q, k, v = (card_randn(rng, *shape) for _ in range(3))
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


def flash_train_cases(rng, cases):
    """Phase 3's cases of the attention forward and backward at each
    ([B, H, N, D], causal, mean limit of the backward) of ``cases``. The
    backward's max limit is the edge tests': bf16 rounding flips of P and
    dS, which the online (kernel) and two-pass (plain) softmax round
    apart."""
    from clip_embeds_tpu_torch.ops.flash_attention import (
        _flash_forward, flash_attention_bwd, flash_attention_bwd_reference)

    out = []
    for shape, causal, mean_tol_bwd in cases:
        fwd, (q, k, v) = flash_forward_case(rng, shape, causal, 0.02)
        out.append(fwd)
        g = card_randn(rng, *shape)
        bh, n, hd = shape[0] * shape[1], shape[2], shape[3]
        pairs = bh * attention_pairs(n, causal) * hd
        io = bh * n * hd * 2
        name = f"{'x'.join(map(str, shape))} causal={causal}"
        o, lse = _flash_forward(q, k, v, causal, with_lse=True)
        with torch.enable_grad():
            lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        out.append((f"flash_attention_bwd {name}",
                    lambda a=(q, k, v, o, g, lse), c=causal:
                    flash_attention_bwd(*a, c),
                    lambda a=(q, k, v, o, g), c=causal:
                    flash_attention_bwd_reference(*a, c),
                    0.0625, n, mean_tol_bwd,
                    bound_ms(flops=10 * pairs, nbytes=8 * io + bh * n * 4),
                    lambda t=(lq, lk, lv), lo=lo, g=g:
                    torch.autograd.grad(lo, t, g, retain_graph=True),
                    10 * pairs))
    return out


def check_kernels(rng):
    """Phase 3: every kernel against its plain version on the same inputs;
    their times, the bound, and the library call's time where there is
    one. The SigLIP shapes draw from their own generator, so the earlier
    cases keep their inputs."""
    # (name, kernel call, plain call, tolerance on max |kernel - plain|,
    #  rows compared (axis 1), tolerance on the mean |kernel - plain|,
    #  (bound_ms, bound_by), library call or None, counted FLOPs or None)
    # Mean limits: BLOCK_CASES, FLASH_CASES, SIGLIP_*_CASES.
    cases = block_kernel_cases(rng, BLOCK_CASES, lambda d: 4 * d, "quick",
                               1e-5, "")
    cases += flash_train_cases(rng, FLASH_CASES)
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
    drop_rng = np.random.default_rng(11)
    cases += block_kernel_cases(drop_rng, PATCH_DROP_BLOCK_CASES,
                                lambda d: 4 * d, "quick", 1e-5, "")
    cases += flash_train_cases(drop_rng, PATCH_DROP_FLASH_CASES)
    t5_rng = np.random.default_rng(13)
    for shape, causal, mean_tol in T5_FAMILY_FLASH_CASES:
        cases.append(flash_forward_case(t5_rng, shape, causal, mean_tol)[0])
    vb_rng = np.random.default_rng(VB_SEED)
    for shape, causal, mean_tol in VB_FLASH_CASES:
        cases.append(flash_forward_case(vb_rng, shape, causal, mean_tol)[0])
    gen_rng = np.random.default_rng(GEN_SEED)
    cases += flash_train_cases(gen_rng, GEN_FLASH_TRAIN_CASES)
    for shape, causal, mean_tol in GEN_FLASH_CASES:
        cases.append(flash_forward_case(gen_rng, shape, causal, mean_tol)[0])
    cases += zoo_kernel_cases(np.random.default_rng(ZOO_SEED))
    return run_kernel_cases(cases)


def zoo_kernel_cases(rng):
    """Phase 3's cases at phase 17's new shapes (ZOO_FLASH_CASES,
    ZOO_BLOCK_CASES) and phase 18's backward (ZOO_FLASH_TRAIN_CASES, its
    forward already among ZOO_FLASH_CASES)."""
    cases = [flash_forward_case(rng, shape, causal, mean_tol)[0]
             for shape, causal, mean_tol in ZOO_FLASH_CASES]
    cases += block_kernel_cases(rng, ZOO_BLOCK_CASES, lambda d: 4 * d, "erf",
                                1e-5, " erf")
    return cases + [c for c in flash_train_cases(rng, ZOO_FLASH_TRAIN_CASES)
                    if c[0].startswith("flash_attention_bwd")]


def run_kernel_cases(cases):
    """Each case's kernel against its plain version under its limits, and
    the times: {name: dict(err, ms, plain_ms, bound_ms, bound_by,
    library_ms)}."""
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
    return (card_randn(rng, m, k), card_randn(rng, n, k, std=k ** -0.5),
            card_randn(rng, n, std=0.5), card_randn(rng, m, n))


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
        q = card_randn(rng, *shape, std=40.0, dtype=torch.float32)
        return q.round().clamp(-127, 127).to(torch.int8)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    wscale = (1 + 0.1 * rng.standard_normal(n)) / (30 * k ** 0.5)
    return (codes(m, k), codes(n, k), f32(wscale),
            f32(0.5 * rng.standard_normal(n)), f32(GEMM_S8_ACT_SCALES),
            card_randn(rng, m, n))


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


def check_int8_linear(gpu, cases=INT8_LINEAR_CASES, seed=3):
    """Phase 3, QuantLinear's card route at ``cases`` in both modes:
    bit-equal to qdot rounded to bf16, int8_linear ms (both kernels),
    TOP/s, share of the bound, the plain qdot's ms, _int_mm ms on the same
    codes and cuBLAS's bf16 F.linear ms at the same shape (yardsticks,
    timed only). Returns {(m, n, k): (ms, plain ms, bound ms, bound_by,
    F.linear ms)}."""
    from clip_embeds_tpu_torch.models.quant import QuantLinear, quantize_weight
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear, qdot

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for m, n, k, *has_bias in cases:
        has_bias = bool(has_bias and has_bias[0])
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = 0.02 * torch.randn(n, k, generator=g, device="cuda")
        bias = (0.5 * torch.randn(n, generator=g, device="cuda")
                if has_bias else None)
        for mode in ("dynamic", "static"):
            lin = QuantLinear(k, n, mode, bias=has_bias).cuda()
            lin.weight_q, lin.scale = quantize_weight(w)
            if has_bias:
                lin.bias.copy_(bias)
            amax = x.float().abs().max()
            lin.act_scale.copy_(INT8_LINEAR_STATIC * amax / 127.0)
            got = lin(x)
            a = (lin.act_scale if mode == "static"
                 else (lin.act_max / 127.0).clamp_min(1e-8))
            want = qdot(x.float(), a, lin.weight_q, lin.scale,
                        bias).to(torch.bfloat16)
            apart = int((got != want).sum())
            if got.shape != (m, n) or apart or (
                    mode == "dynamic" and lin.act_max != amax):
                raise AssertionError(
                    f"int8_linear {m}x{n}x{k} {mode}: {apart} of {m * n} "
                    f"entries differ from qdot, act_max "
                    f"{float(lin.act_max)} (abs-max {float(amax)})")
            del got, want
        ops = 2 * m * n * k
        nbytes = 2 * m * k + n * k + 4 * n * (1 + has_bias) + 2 * m * n
        bound, bound_by = bound_ms(int8_ops=ops, nbytes=nbytes)
        ms = cuda_ms(lambda: int8_linear(x, a, lin.weight_q, lin.scale,
                                         lin.bias))
        xq = torch.clamp(torch.round(x.float() / a), -127, 127).to(
            torch.int8)
        wb = w.bfloat16()
        bb = None if bias is None else bias.bfloat16()
        lin_ms = cuda_ms(lambda: F.linear(x, wb, bb))
        plain_ms = cuda_ms(lambda: qdot(x.float(), a, lin.weight_q,
                                        lin.scale, lin.bias), iters=2,
                           warmup=1)
        print(f"[int8_linear] {m}x{n}x{k}{' bias' if has_bias else ''}: "
              f"dynamic and static bit-equal to "
              f"qdot in bf16; kernel {ms:.4f} ms, {ops / ms / 1e9:.1f} "
              f"TOP/s, {100 * bound / ms:.1f}% of the bound {bound:.4f} ms "
              f"({bound_by}); plain qdot {plain_ms:.4f} ms; torch._int_mm "
              f"{int_mm_ms(xq, lin.weight_q)}, bf16 F.linear {lin_ms:.4f} "
              f"ms on {gpu}")
        out[(m, n, k, has_bias)] = (ms, plain_ms, bound, bound_by, lin_ms)
        del x, w, wb, bb, xq, lin
    return out


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


def train_grads(model, batch, use_hard_text=False, trainable=None):
    """Gradients of one batch's InfoNCE loss (with hard texts where asked),
    fp32, by parameter name: of every parameter, or of the names in
    ``trainable`` with the others frozen."""
    from clip_embeds_tpu_torch.train.steps import clip_train_loss

    model.zero_grad(set_to_none=True)
    if trainable is not None:
        for k, p in model.named_parameters():
            p.requires_grad_(k in trainable)
    loss, _ = clip_train_loss(model, batch, use_hard_text=use_hard_text)
    loss.backward()
    grads = {k: p.grad.float() for k, p in model.named_parameters()
             if p.requires_grad}
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


def check_training(counters, gpu, base):
    """Phase 6, inside :func:`seeded_from` ``base`` (the seed-0 state dict
    on the host). Returns each route's launch counts from its CLI run, its
    b32 train samples/s by CUDA events, and ``base``."""
    from clip_embeds_tpu_torch.cli.train import main as train_main
    from clip_embeds_tpu_torch.train.optim import adamw
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState, make_clip_train_step)

    logging.getLogger().setLevel(logging.INFO)
    launches, rates = {}, {}
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
            rates[route, bs] = bs / ms * 1e3
            print(f"[throughput] train_samples_per_s {route} b{bs}: "
                  f"{bs / ms * 1e3:.1f} ({ms:.2f} ms/step, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) "
                  f"on {gpu}")
            del tb
        del model, opt, state, step, grads
    return launches, rates, base


# -- phase 12: the fine-tune recipe and the real-data loaders ---------------


def recipe_jpeg(root, i):
    """(annotation name, path) of phase 12's JPEG ``i``: the even ones under
    the LCS-558K root, the odd ones under the DataMix-665K root."""
    if i % 2 == 0:
        name = f"{i // 2:05d}/{i:09d}.jpg"
        return name, os.path.join(root, "lcs", name)
    name = f"coco/train2017/{i:012d}.jpg"
    return name, os.path.join(root, "datamix", name)


def write_recipe_fixtures(root, seed):
    """Phase 12's fixtures under ``root``: RECIPE_JPEGS JPEGs of smooth
    random fields, of mixed sizes and aspect ratios (every eighth wider
    than 2:1, where RandomResizedCrop's ten area draws all fail and it
    falls back to a centre crop), half under an LCS-558K root with names
    from '0' and half under a DataMix-665K root; the LLaVA annotation JSON
    (ann.json) over the first RECIPE_SAMPLES, 1-3 answer turns each, every
    turn of a third of them with a left/right phrase, and RECIPE_NO_IMAGE
    entries without an image; leftright.json from the port's
    LEFTRIGHT_SWAPS; a TSV (data.tsv) of RECIPE_TSV rows; and two tar
    shards (shard-000.tar, shard-001.tar) of RECIPE_TAR samples together,
    one of them undecodable. Returns whether each annotated sample's
    captions carry a phrase, in annotation order."""
    import tarfile

    from PIL import Image

    from clip_embeds_tpu_torch.data.hard_negatives import LEFTRIGHT_SWAPS

    rng = np.random.default_rng(seed)
    names, paths = [], []
    for i in range(RECIPE_JPEGS):
        name, path = recipe_jpeg(root, i)
        names.append(name)
        paths.append(path)
    sizes = [(int(rng.integers(120, 300)), int(rng.integers(640, 900)))
             if i % 8 == 0 else tuple(int(x) for x in rng.integers(180, 640,
                                                                    2))
             for i in range(RECIPE_JPEGS)]

    def one(i):
        r = np.random.default_rng([seed, i])
        h, w = sizes[i]
        low = Image.fromarray(r.integers(0, 256, (6, 8, 3), np.uint8))
        img = np.asarray(low.resize((w, h), Image.BICUBIC), np.int16)
        img = img + r.integers(-6, 7, img.shape, np.int16)
        os.makedirs(os.path.dirname(paths[i]), exist_ok=True)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            paths[i], quality=90)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(one, range(RECIPE_JPEGS)))

    ann, phrased = [], []
    where = ("on the left of", "to the right of", "at the left of")
    for i in range(RECIPE_SAMPLES):
        has = i % 3 == 0
        conv = []
        for t in range(1 + i % 3):
            obj = OBJECTS[(i + t) % len(OBJECTS)]
            rel = where[(i + t) % 3] if has else "next to"
            conv += [{"from": "human", "value": "<image>\nWhere is it?"},
                     {"from": "gpt", "value": f"The {obj} is {rel} the "
                                              f"table{i}."}]
        ann.append({"id": str(i), "image": names[i], "conversations": conv})
        phrased.append(has)
    for j in range(RECIPE_NO_IMAGE):
        ann.insert(7 * j + 3, {"id": f"text{j}", "conversations": [
            {"from": "human", "value": "Hi"},
            {"from": "gpt", "value": "on the left"}]})
    with open(os.path.join(root, "ann.json"), "w") as fh:
        json.dump(ann, fh)
    with open(os.path.join(root, "leftright.json"), "w") as fh:
        json.dump(LEFTRIGHT_SWAPS, fh)
    rows = ["filepath\ttitle"] + [
        f"{paths[-1 - i]}\ta photo of the {OBJECTS[i % len(OBJECTS)]} {i}"
        for i in range(RECIPE_TSV)]
    with open(os.path.join(root, "data.tsv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    half = RECIPE_TAR // 2
    for s, span in enumerate((range(half), range(half, RECIPE_TAR))):
        with tarfile.open(os.path.join(root, f"shard-{s:03d}.tar"),
                          "w") as tf:
            for i in span:
                with open(paths[RECIPE_SAMPLES + i], "rb") as fh:
                    blob = fh.read()
                if i == 5:
                    blob = b"undecodable"
                for ext, data in (("jpg", blob),
                                  ("txt", f"a photo {i}".encode())):
                    info = tarfile.TarInfo(f"{i:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return phrased


class _Drops(logging.Handler):
    """Counts the loaders' 'dropping undecodable sample' warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.count = 0

    def emit(self, record):
        self.count += "dropping undecodable sample" in str(record.msg)


class _TimedData:
    """``cli.train.build_data`` wrapped: each batch's hard_valid sum, the
    time each next() of the data iterator begins and how long it takes
    (the CLI reads the loss after each step, so the span from one next()
    to the following one is one batch's host work plus its device
    step)."""

    def __init__(self, build_data):
        self.real = build_data
        self.hard, self.starts, self.host = [], [], []

    def __call__(self, *args, **kw):
        it, steps = self.real(*args, **kw)
        return self.iterate(it), steps

    def iterate(self, it):
        while True:
            self.starts.append(time.perf_counter())
            try:
                batch = next(it)
            except StopIteration:
                return
            self.host.append(time.perf_counter() - self.starts[-1])
            if "hard_valid" in batch:
                self.hard.append(int(batch["hard_valid"].sum()))
            yield batch

    def rates(self, batch_size, skip=0):
        """(samples/s, the host's share of the wall) over the steps after
        the first ``skip``."""
        wall = self.starts[-1] - self.starts[skip]
        return ((len(self.host) - skip) * batch_size / wall,
                sum(self.host[skip:]) / wall)


def _tower_rows():
    """A global forward pre-hook that records the rows every image-tower
    Transformer (width 1024) receives; returns (rows, handle)."""
    from clip_embeds_tpu_torch.models.layers import Transformer

    rows = []

    def hook(module, args):
        if isinstance(module, Transformer) and args[0].shape[-1] == 1024:
            rows.append(args[0].shape[1])

    return rows, torch.nn.modules.module.register_module_forward_pre_hook(
        hook)


def recipe_run(counters, label, argv, per_step, steps, gpu, extra=None,
               tag="recipe"):
    """cli/train.py main(argv) on ViT-L/14-336 (seed 0, phase 6's weights)
    with every launch count set to 0 just before: held to ``per_step``
    launches a step for ``steps`` steps, plus ``extra`` launches in all
    (phase 15's evals), finite losses; returns (state, _TimedData, peak
    GiB)."""
    from clip_embeds_tpu_torch.cli import train as train_cli

    gc.collect()
    torch.cuda.empty_cache()
    log, timed = _StepLog(), _TimedData(train_cli.build_data)
    logging.getLogger().addHandler(log)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with patched(train_cli, "build_data", timed):
            t0 = time.perf_counter()
            state = train_cli.main([
                "--model", MODEL, "--pretrained", "openai", "--seed", "0",
                "--batch-size", str(TRAIN_BATCH), "--lr", "1e-5",
                "--warmup", "1", "--log-every", "1", *argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        logging.getLogger().removeHandler(log)
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {k: steps * per_step.get(k, 0) + (extra or {}).get(k, 0)
            for k in counters}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{tag}] {label}: {state.step} steps of {TRAIN_BATCH} in "
          f"{wall:.1f} s; losses {log.losses}; launches {counts}")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    if state.step != steps or len(log.losses) != steps or not np.isfinite(
            log.losses).all():
        raise AssertionError(f"{label}: {state.step} steps, losses "
                             f"{log.losses}")
    return state, timed, peak


@torch.no_grad()
def card_empty_clip(cfg, **kw):
    """``core/factory.py _empty_clip`` with the storage on the card: a
    build there copies no weights from the host."""
    from torch import nn

    from clip_embeds_tpu_torch.models.clip import CLIP

    with torch.device("meta"):
        model = CLIP(cfg, **kw)
    model.to_empty(device="cuda")
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
    model.logit_scale.fill_(float(cfg.init_logit_scale))
    if model.logit_bias is not None:
        model.logit_bias.fill_(float(cfg.init_logit_bias))
    return model


@contextlib.contextmanager
def seeded_from(base):
    """Every seeded build of MODEL inside (``create_model``'s seed-0 init,
    which these phases alone use) takes the seed-0 weights ``base`` (a host
    state dict: the same values), built on the card from one copy there:
    no draw of 428M normals on the host, no weights copied, a build."""
    from clip_embeds_tpu_torch.core import factory

    on_card = {k: v.cuda() for k, v in base.items()}
    with patched(factory, "init_params",
                 lambda model, seed=0: model.load_state_dict(on_card)), \
            patched(factory, "_empty_clip", card_empty_clip):
        yield


@contextlib.contextmanager
def recipe_fixtures(base):
    """Phase 12 (a): its fixture directory (yields (root, phrased)), its
    models seeded from phase 6's ``base`` (:func:`seeded_from`). Phase 15
    runs inside it too."""
    with tempfile.TemporaryDirectory() as root, seeded_from(base):
        t0 = time.perf_counter()
        phrased = write_recipe_fixtures(root, RECIPE_SEED)
        print(f"[recipe] (a) fixtures: {RECIPE_JPEGS} JPEGs, "
              f"{RECIPE_SAMPLES} + {RECIPE_NO_IMAGE} annotations, "
              f"{RECIPE_TSV} TSV rows, {RECIPE_TAR} tar samples in "
              f"{time.perf_counter() - t0:.1f} s")
        yield root, phrased


def check_recipe(counters, base, train_rates, gpu, root, phrased):
    """Phase 12 in ``root`` (:func:`recipe_fixtures`): (b) the recipe on
    each of RECIPE_ROUTES; (c) its gradients at GRAD_BATCH on a real
    datamix batch against plain fp32 beside the witness; (d) patch dropout
    unlocked on phase 6's routes; (e) the CSV, WebDataset and auto
    loaders. ``base``: phase 6's seed-0 state dict on the host."""
    from clip_embeds_tpu_torch.cli import train as train_cli
    from clip_embeds_tpu_torch.core.config import get_model_config

    data = ["--train-data", f"{root}/ann.json", "--lcs-root",
            f"{root}/lcs", "--datamix-root", f"{root}/datamix"]
    recipe = ["--lock-image", "--usehardtext", "--augfiles",
              f"{root}/leftright.json", "--dataset-type", "datamix",
              *data]
    # the loader's order: default_rng(seed + epoch) over the samples,
    # max_hard_per_batch = TRAIN_BATCH // 4 rows a batch
    order = np.arange(RECIPE_SAMPLES)
    np.random.default_rng(0).shuffle(order)
    want_hard = [min(TRAIN_BATCH // 4, sum(phrased[i] for i in chunk))
                 for chunk in order.reshape(RECIPE_STEPS, -1)]

    # (b) the recipe
    for route, (flags, per_step) in RECIPE_ROUTES.items():
        state, timed, peak = recipe_run(
            counters, f"recipe {route}", recipe + flags, per_step,
            RECIPE_STEPS, gpu)
        (rate, share), (rate1, share1) = (timed.rates(TRAIN_BATCH),
                                          timed.rates(TRAIN_BATCH, 1))
        after = state.model.state_dict()
        kept = [k for k in base if torch.equal(after[k].cpu(), base[k])]
        visual = [k for k in base if k.startswith("visual.")]
        if kept != visual:
            raise AssertionError(f"recipe {route}: tensors left as they "
                                 f"were {len(kept)}, visual "
                                 f"{len(visual)}")
        if timed.hard != want_hard:
            raise AssertionError(f"recipe {route}: hard_valid sums "
                                 f"{timed.hard} != {want_hard}")
        print(f"[recipe] {route}: visual.* ({len(visual)} tensors) "
              f"bit-equal, the other {len(base) - len(visual)} moved; "
              f"hard_valid sums {timed.hard}; end to end "
              f"{rate:.1f} samples/s, host share {share:.3f} "
              f"(steps 2-{RECIPE_STEPS}: {rate1:.1f} samples/s, host "
              f"share {share1:.3f}; batches {timed.host} s in "
              f"next()); peak {peak:.2f} GiB; phase 6 synthetic "
              f"b{TRAIN_BATCH}, unlocked, device only: "
              f"{train_rates[route, TRAIN_BATCH]:.1f} samples/s; on "
              f"{gpu}")
        del state, after

    # (c) gradient agreement on a real datamix batch of GRAD_BATCH
    args = train_cli.parse_args(["--model", MODEL, "--batch-size",
                                 str(GRAD_BATCH), "--seed", "0",
                                 *recipe])
    cfg = get_model_config(MODEL, "openai")
    batch = train_cli._to_device(
        next(train_cli.build_data(args, cfg)[0]), torch.device("cuda"))
    trainable = {k for k in base if not k.startswith("visual.")}
    ref, ref_loss = train_grads(route_model("composable", None), batch,
                                True, trainable)
    with plain_attention():
        witness, _ = train_grads(route_model("composable"), batch, True,
                                 trainable)
    cos, worst, worst_name = grad_agreement(witness, ref)
    print(f"[recipe] (c) witness (bf16, plain attention) gradients vs "
          f"plain fp32 at b{GRAD_BATCH}, {int(batch['hard_valid'].sum())}"
          f" hard texts: cosine {cos:.6f}, least per tensor {worst:.6f} "
          f"({worst_name})")
    cos_min = max(GRAD_COS_MIN, cos - GRAD_COS_BELOW_WITNESS)
    for route in RECIPE_ROUTES:
        gc.collect()
        torch.cuda.empty_cache()
        grads, loss = train_grads(route_model(route), batch, True,
                                  trainable)
        cos, worst, worst_name = grad_agreement(grads, ref)
        print(f"[recipe] (c) {route} gradients vs plain fp32: cosine "
              f"{cos:.6f} (limit {cos_min:.6f}), least per tensor "
              f"{worst:.6f} ({worst_name}; limit "
              f"{GRAD_TENSOR_COS_MIN}); loss {loss:.6f} vs "
              f"{ref_loss:.6f}")
        if not (cos >= cos_min and worst >= GRAD_TENSOR_COS_MIN):
            raise AssertionError(f"recipe {route}: gradients disagree")
    del ref, witness, grads

    # (d) patch dropout, the image tower unlocked, on phase 6's routes
    for route, (flags, per_step) in ROUTES.items():
        rows, handle = _tower_rows()
        try:
            state, timed, peak = recipe_run(
                counters, f"patch dropout {route}",
                ["--force-patch-dropout", str(PATCH_DROP),
                 "--train-num-samples",
                 str(PATCH_DROP_STEPS * TRAIN_BATCH), *flags],
                per_step, PATCH_DROP_STEPS, gpu)
        finally:
            handle.remove()
        if rows != [PATCH_DROP_ROWS] * PATCH_DROP_STEPS:
            raise AssertionError(f"patch dropout {route}: image rows "
                                 f"{rows}")
        print(f"[recipe] (d) patch dropout {PATCH_DROP} {route}: image "
              f"blocks at {rows[0]} rows; synthetic, end to end: "
              f"{timed.rates(TRAIN_BATCH)[0]:.1f} samples/s, step 2 "
              f"{timed.rates(TRAIN_BATCH, 1)[0]:.1f}; peak {peak:.2f} "
              f"GiB on {gpu}")
        del state

    # (e) the other loaders, one step each, composable, image locked
    drops = _Drops()
    logging.getLogger().addHandler(drops)
    try:
        for label, argv, dropped in (
                ("csv", ["--dataset-type", "csv", "--train-data",
                         f"{root}/data.tsv"], 0),
                ("webdataset --no-train-aug (batch decode)",
                 ["--dataset-type", "webdataset", "--train-data",
                  f"{root}/shard-{{000..001}}.tar", "--no-train-aug"],
                 1),
                ("auto .tsv", ["--dataset-type", "auto", "--train-data",
                               f"{root}/data.tsv"], 0),
                ("auto .tar", ["--dataset-type", "auto", "--train-data",
                               f"{root}/shard-000.tar",
                               f"{root}/shard-001.tar"], 1)):
            drops.count = 0
            state, timed, _ = recipe_run(
                counters, label, ["--lock-image", "--train-num-samples",
                                  str(TRAIN_BATCH), *argv],
                RECIPE_ROUTES["composable"][1], 1, gpu)
            if drops.count != dropped:
                raise AssertionError(f"{label}: {drops.count} samples "
                                     f"dropped, want {dropped}")
            print(f"[recipe] (e) {label}: 1 step, undecodable samples "
                  f"dropped {dropped} (the batch refilled); "
                  f"%.1f samples/s, host share %.3f on {gpu}"
                  % timed.rates(TRAIN_BATCH))
            del state
    finally:
        logging.getLogger().removeHandler(drops)


# -- phase 15: the rest of the training loop ---------------------------------


def distill_grads(model, teacher, batch):
    """Gradients of one batch's distillation loss (the student's InfoNCE
    plus the KD term against ``teacher``), fp32, by parameter name."""
    from clip_embeds_tpu_torch.train.steps import distill_train_loss

    model.zero_grad(set_to_none=True)
    loss, _ = distill_train_loss(model, teacher, batch)
    loss.backward()
    grads = {k: p.grad.float() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads, loss.item()


def write_teacher(base, path):
    """Phase 15 (a)'s teacher state dict: ``base`` with each entry but the
    logit scale scaled by 1 + LOOP_TEACHER_NOISE x a normal drawn on the
    card from LOOP_SEED, in bf16 (the teacher's type; the logit scale
    fp32): half the bytes to write and read."""
    g = torch.Generator(device="cuda").manual_seed(LOOP_SEED)
    sd = {}
    for k, v in base.items():
        if k != "logit_scale":
            noise = torch.randn(v.shape, generator=g, device="cuda")
            v = (v.cuda() * (1 + LOOP_TEACHER_NOISE * noise)).to(
                torch.bfloat16).cpu()
        sd[k] = v
    torch.save(sd, path)


def loop_distill(counters, train_rates, gpu, root):
    """Phase 15 (a): distillation through the CLI, the teacher untouched,
    samples/s and peak memory by CUDA events, gradients against plain
    fp32 beside the witness."""
    from clip_embeds_tpu_torch.cli import train as train_cli
    from clip_embeds_tpu_torch.train.steps import make_distill_train_step

    t0 = time.perf_counter()
    tpath = os.path.join(root, "teacher.pt")
    write_teacher(route_model("composable").state_dict(), tpath)
    print(f"[loop] (a) teacher state dict written in "
          f"{time.perf_counter() - t0:.1f} s")
    made = []

    def build_teacher(*args, **kw):
        teacher = real(*args, **kw)
        made.append((teacher, {k: v.clone() for k, v in
                               teacher.state_dict().items()}))
        return teacher

    # the teacher's forward: the image tower's 24 flash forwards (its
    # 77-token text tower takes plain attention), no backward
    per_step = {"flash_attention": 2 * 24, "flash_attention_bwd": 24}
    with patched(train_cli, "build_teacher", build_teacher) as real:
        state, timed, peak = recipe_run(
            counters, "distill composable",
            ["--train-num-samples", str(LOOP_DISTILL_STEPS * TRAIN_BATCH),
             "--distill-model", MODEL, "--distill-pretrained", tpath],
            per_step, LOOP_DISTILL_STEPS, gpu, tag="loop")
    (teacher, before), = made
    params = dict(teacher.named_parameters())
    if any(p.requires_grad or p.grad is not None for p in params.values()) \
            or not all(torch.equal(v, before[k])
                       for k, v in teacher.state_dict().items()):
        raise AssertionError("distill: the teacher moved or has gradients")

    step = make_distill_train_step(state.model, teacher)
    tb = train_batch(TRAIN_BATCH, seed=2)
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
    if not all(np.isfinite(float(metrics[k])) for k in
               ("loss", "contrastive_loss", "distill_loss")):
        raise AssertionError(f"distill: losses {metrics}")
    print(f"[loop] (a) distill composable: teacher's {len(params)} "
          f"tensors bit-equal, none with a gradient; launches a step "
          f"{per_step}; contrastive {float(metrics['contrastive_loss']):.4f}"
          f" distill {float(metrics['distill_loss']):.4f}; "
          f"[throughput] distill_samples_per_s b{TRAIN_BATCH}: "
          f"{TRAIN_BATCH / ms * 1e3:.1f} ({ms:.2f} ms/step, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; the CLI "
          f"run's peak {peak:.2f} GiB, end to end "
          f"{timed.rates(TRAIN_BATCH, 1)[0]:.1f} samples/s); phase 6 plain "
          f"b{TRAIN_BATCH}: {train_rates['composable', TRAIN_BATCH]:.1f} "
          f"samples/s; on {gpu}")
    del step, tb, made

    # gradients at GRAD_BATCH against the plain fp32 path (the student's
    # weights as the steps left them, the teacher's as its file holds
    # them); the witness: both bf16 with no kernel
    model = state.model
    batch = train_batch(GRAD_BATCH, seed=1)
    ref_student, ref_teacher = (route_model("composable", None)
                                for _ in range(2))
    ref_student.load_state_dict(model.state_dict())
    ref_teacher.load_state_dict(teacher.state_dict())  # the file's values
    ref_teacher.requires_grad_(False)
    ref, ref_loss = distill_grads(ref_student, ref_teacher, batch)
    del ref_student, ref_teacher, state
    gc.collect()
    torch.cuda.empty_cache()
    with plain_attention():
        witness, _ = distill_grads(model, teacher, batch)
    cos, worst, worst_name = grad_agreement(witness, ref)
    print(f"[loop] (a) witness (bf16 student and teacher, plain attention) "
          f"distill gradients vs plain fp32 at b{GRAD_BATCH}: cosine "
          f"{cos:.6f}, least per tensor {worst:.6f} ({worst_name})")
    cos_min = max(GRAD_COS_MIN, cos - GRAD_COS_BELOW_WITNESS)
    grads, loss = distill_grads(model, teacher, batch)
    cos, worst, worst_name = grad_agreement(grads, ref)
    print(f"[loop] (a) composable distill gradients vs plain fp32: cosine "
          f"{cos:.6f} (limit {cos_min:.6f}), least per tensor {worst:.6f} "
          f"({worst_name}; limit {GRAD_TENSOR_COS_MIN}); loss {loss:.6f} "
          f"vs {ref_loss:.6f}")
    if not (cos >= cos_min and worst >= GRAD_TENSOR_COS_MIN):
        raise AssertionError("distill: gradients disagree")
    os.remove(tpath)


def write_loop_fixtures(root):
    """Phase 15 (b)'s files over phase 12's JPEGs: val.tsv (the first
    LOOP_VAL_SAMPLES), an ImageFolder inet/ of LOOP_ZS_CLASSES dirs x
    LOOP_ZS_PER_CLASS (hard links) and flickr/annotations.json (the first
    LOOP_FLICKR_IMAGES, 5 captions each)."""
    paths = [recipe_jpeg(root, i)[1] for i in range(RECIPE_JPEGS)]
    rows = ["filepath\ttitle"] + [
        f"{paths[i]}\ta photo of the {OBJECTS[i % len(OBJECTS)]} {i}"
        for i in range(LOOP_VAL_SAMPLES)]
    with open(os.path.join(root, "val.tsv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    for c in range(LOOP_ZS_CLASSES):
        d = os.path.join(root, "inet", f"n{c:08d}")
        os.makedirs(d)
        for j in range(LOOP_ZS_PER_CLASS):
            os.link(paths[c * LOOP_ZS_PER_CLASS + j],
                    os.path.join(d, f"{j:02d}.jpg"))
    ann = [{"image": os.path.relpath(paths[i], root),
            "captions": [f"the {OBJECTS[(i + j) % len(OBJECTS)]} of photo "
                         f"{i}, view {j}" for j in range(5)]}
           for i in range(LOOP_FLICKR_IMAGES)]
    os.makedirs(os.path.join(root, "flickr"))
    with open(os.path.join(root, "flickr", "annotations.json"), "w") as fh:
        json.dump(ann, fh)


def loop_eval_launches(route, cfg):
    """The eval passes' launches on a route: LOOP_VAL_SAMPLES val pairs and
    the zero-shot images in batches of TRAIN_BATCH, and 100 classifier
    calls of the text tower (77 tokens: plain attention on composable
    blocks, fused_block on the fused route)."""
    v, t = cfg.vision.layers, cfg.text.layers
    val = -(-LOOP_VAL_SAMPLES // TRAIN_BATCH)
    zs = -(-LOOP_ZS_CLASSES * LOOP_ZS_PER_CLASS // TRAIN_BATCH)
    calls = 1000 // 10
    if route == "composable":
        return {"flash_attention": v * (val + zs)}
    return {"fused_block": (v + t) * val + v * zs + t * calls}


def loop_reference_subset():
    """The classes the plain fp32 classifier covers: the fixture's and
    more drawn from LOOP_SEED, sorted."""
    rng = np.random.default_rng(LOOP_SEED)
    more = rng.choice(np.arange(LOOP_ZS_CLASSES, 1000),
                      LOOP_ZS_REF_CLASSES - LOOP_ZS_CLASSES, replace=False)
    return np.sort(np.concatenate([np.arange(LOOP_ZS_CLASSES), more]))


def loop_eval_outputs(model, args, subset, classifier=None):
    """The eval passes' outputs of ``model`` as the CLI computes them: the
    val features, the logit scale, the classifier over ``subset`` (built
    here where ``classifier`` is None: 800 prompts a call) and the
    zero-shot images' features."""
    from clip_embeds_tpu_torch.cli import train as train_cli
    from clip_embeds_tpu_torch.evals import zero_shot
    from clip_embeds_tpu_torch.text.tokenizer import get_tokenizer

    dev = torch.device("cuda")
    img, txt = train_cli.validation_features(model, args, dev)
    if classifier is None:
        classnames, templates = train_cli.imagenet_prompts(
            zero_shot.load_imagenet_metadata())
        tok = get_tokenizer(model.cfg.text.context_length)
        classifier = zero_shot.build_zero_shot_classifier(
            lambda p: train_cli.encode_prompts(model, tok, p, dev),
            [classnames[i] for i in subset], templates)
    samples, _ = train_cli.imagefolder_samples(args.imagenet_val)
    zs = np.concatenate([
        train_cli.encode_image_paths(model, samples[i:i + TRAIN_BATCH], dev)
        for i in range(0, len(samples), TRAIN_BATCH)])
    return {"img": img, "txt": txt, "classifier": classifier, "zs": zs,
            "scale": model.logit_scale.detach().float().cpu().numpy()}


def clear_decisions(got, want):
    """(agree, clear) over rows: argmax of ``got`` against ``want``'s, on
    rows whose ``want`` margin (top 1 - top 2) exceeds twice the largest
    |got - want| (phase 7's rule)."""
    diff = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * diff
    agree = got.argmax(1) == want.argmax(1)
    return int(agree[clear].sum()), int(clear.sum()), diff


def loop_readings(got, want):
    """Phase 15 (b)'s agreement of one eval run ``got`` with the plain fp32
    reference ``want`` (both from :func:`loop_eval_outputs`, classifiers
    over the same classes)."""
    from clip_embeds_tpu_torch.cli.train import validation_metrics

    losses = [validation_metrics(o["img"], o["txt"], o["scale"])[
        "clip_val_loss"] for o in (got, want)]
    zs_got, zs_want = (100.0 * o["zs"] @ o["classifier"]
                       for o in (got, want))
    sims_got, sims_want = (o["img"] @ o["txt"].T for o in (got, want))
    return {
        "val_image_cos": float(row_cos(got["img"], want["img"]).min()),
        "val_text_cos": float(row_cos(got["txt"], want["txt"]).min()),
        "val_loss_diff": abs(losses[0] - losses[1]),
        "classifier_cos": float(row_cos(got["classifier"].T,
                                        want["classifier"].T).min()),
        "zs_logit_diff": float(np.abs(zs_got - zs_want).max()),
        "zs_decisions": clear_decisions(zs_got, zs_want),
        "i2t_decisions": clear_decisions(sims_got, sims_want),
        "t2i_decisions": clear_decisions(sims_got.T, sims_want.T)}


def check_loop_readings(label, r):
    print(f"[loop] (b) {label} vs plain fp32: val least row cosine image "
          f"{r['val_image_cos']:.6f} text {r['val_text_cos']:.6f} (limit "
          f"{LOOP_VAL_COS}), |d clip_val_loss| {r['val_loss_diff']:.3g} "
          f"(limit {LOOP_VAL_LOSS_TOL}), classifier columns' least cosine "
          f"{r['classifier_cos']:.6f} (limit {LOOP_ZS_COL_COS}), zero-shot "
          f"logits max |d| {r['zs_logit_diff']:.3g} (limit "
          f"{LOOP_ZS_LOGIT_TOL}); clear decisions agree (agree, clear, "
          f"largest |d|): zero-shot {r['zs_decisions']}, image->text "
          f"{r['i2t_decisions']}, text->image {r['t2i_decisions']}")
    if not (min(r["val_image_cos"], r["val_text_cos"]) >= LOOP_VAL_COS
            and r["val_loss_diff"] <= LOOP_VAL_LOSS_TOL
            and r["classifier_cos"] >= LOOP_ZS_COL_COS
            and r["zs_logit_diff"] <= LOOP_ZS_LOGIT_TOL
            and all(r[k][0] == r[k][1] for k in
                    ("zs_decisions", "i2t_decisions", "t2i_decisions"))):
        raise AssertionError(f"{label}: the evals disagree with fp32")


def loop_evals(counters, base, gpu, root):
    """Phase 15 (b): validation and zero-shot after one epoch through the
    CLI on RECIPE_ROUTES, held to the plain fp32 reference; Flickr
    retrieval on the composable route's model."""
    from clip_embeds_tpu_torch.cli import train as train_cli
    from clip_embeds_tpu_torch.core.config import get_model_config
    from clip_embeds_tpu_torch.evals.flickr import (
        evaluate_retrieval, load_flickr_annotations)
    from clip_embeds_tpu_torch.text.tokenizer import get_tokenizer

    write_loop_fixtures(root)
    subset = loop_reference_subset()
    cfg = get_model_config(MODEL, "openai")
    dev = torch.device("cuda")
    argv = ["--dataset-type", "csv", "--train-data", f"{root}/data.tsv",
            "--lr", "0", "--val-data", f"{root}/val.tsv",
            "--val-num-samples", str(LOOP_VAL_SAMPLES), "--imagenet-val",
            f"{root}/inet", "--report-to", "jsonl", "--logs",
            f"{root}/logs"]
    runs, flickr_model = {}, None
    for route in RECIPE_ROUTES:
        flags = RECIPE_ROUTES[route][0]
        rec, secs = {}, {}

        def recorder(name, real):
            def fn(*args, **kw):
                t = time.perf_counter()
                out = real(*args, **kw)
                secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
                rec.setdefault(name, []).append(out)
                return out
            return fn

        with contextlib.ExitStack() as stack:
            for name in ("validation_features", "zero_shot_classifier",
                         "encode_image_paths"):
                stack.enter_context(patched(train_cli, name, recorder(
                    name, getattr(train_cli, name))))
            state, _, peak = recipe_run(
                counters, f"evals {route}",
                [*argv, "--name", f"evals-{route}", *flags],
                ROUTES[route][1], RECIPE_TSV // TRAIN_BATCH, gpu,
                tag="loop", extra=loop_eval_launches(route, cfg))
        after = state.model.state_dict()
        if not all(torch.equal(after[k].cpu(), v) for k, v in base.items()):
            raise AssertionError(f"evals {route}: lr 0 moved a weight")
        (img, txt), = rec["validation_features"]
        (classifier,) = rec["zero_shot_classifier"]
        runs[route] = {"img": img, "txt": txt, "zs": np.concatenate(
            rec["encode_image_paths"]), "classifier": classifier[:, subset],
            "scale": state.model.logit_scale.detach().float().cpu().numpy()}
        with open(f"{root}/logs/evals-{route}/results.jsonl") as fh:
            lines = [json.loads(line) for line in fh]
        if [sorted(x) for x in lines] != [
                sorted(["epoch", "clip_val_loss", "num_samples",
                        *(f"{d}_{m}" for d in ("image_to_text",
                                               "text_to_image")
                          for m in ("mean_rank", "median_rank", "R@1",
                                    "R@5", "R@10"))]),
                ["epoch", "imagenet-zeroshot-val-top1",
                 "imagenet-zeroshot-val-top5"]] or classifier.shape != (
                    state.model.cfg.embed_dim, 1000):
            raise AssertionError(f"evals {route}: results.jsonl {lines}, "
                                 f"classifier {classifier.shape}")
        prompts = 1000 * 80
        print(f"[loop] (b) {route}: results.jsonl {lines}; "
              f"[throughput] validation {LOOP_VAL_SAMPLES} pairs in "
              f"{secs['validation_features']:.2f} s "
              f"({LOOP_VAL_SAMPLES / secs['validation_features']:.1f} "
              f"samples/s from JPEGs); classifier {prompts} prompts in "
              f"{secs['zero_shot_classifier']:.2f} s "
              f"({prompts / secs['zero_shot_classifier']:.0f} prompts/s); "
              f"peak {peak:.2f} GiB; on {gpu}")
        if route == "composable":
            flickr_model = state.model
        del state, after

    # the plain fp32 reference, with phase 6's weights
    t0 = time.perf_counter()
    ref = route_model("composable", None)
    args = train_cli.parse_args(["--model", MODEL, "--batch-size",
                                 str(TRAIN_BATCH), *argv])
    want = loop_eval_outputs(ref, args, subset)
    del ref
    print(f"[loop] (b) plain fp32 reference: val, {len(subset)} classes' "
          f"classifier, zero-shot images in {time.perf_counter() - t0:.1f} "
          f"s")
    for route, got in runs.items():
        check_loop_readings(route, loop_readings(got, want))

    # Flickr retrieval on the composable route's model
    t0 = time.perf_counter()
    tok = get_tokenizer(flickr_model.cfg.text.context_length)
    ann = load_flickr_annotations(f"{root}/flickr")
    out = evaluate_retrieval(
        lambda paths: np.concatenate([
            train_cli.encode_image_paths(flickr_model,
                                         paths[i:i + TRAIN_BATCH], dev)
            for i in range(0, len(paths), TRAIN_BATCH)]),
        lambda caps: train_cli.encode_prompts(flickr_model, tok, caps, dev),
        ann, root)
    if not all(0.0 <= v <= 1.0 for v in out.values()):
        raise AssertionError(f"flickr: {out}")
    print(f"[loop] (b) evals/flickr.py evaluate_retrieval, "
          f"{len(ann)} images x 5 captions (composable, bf16): {out} in "
          f"{time.perf_counter() - t0:.2f} s on {gpu}")
class _EpochWalls(logging.Handler):
    """Collects the training CLI's 'epoch %d done in %.2f s' records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.walls = []

    def emit(self, record):
        if str(record.msg).startswith("epoch %d done in"):
            self.walls.append(float(record.args[1]))


def same_bytes(a, b, chunk=1 << 26):
    """Whether files ``a`` and ``b`` hold the same bytes (64 MiB reads)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def loop_checkpoints(counters, gpu, root):
    """Phase 15 (c): LOOP_CKPT_EPOCHS epochs through the CLI with
    --delete-previous-checkpoint, blocking saves, then async saves with a
    local mirror every second: each epoch's wall, the mirror holding the
    kept checkpoint and every checkpoint a pass caught before its prune,
    byte-equal to what was committed, and no .tmp_* file."""
    from clip_embeds_tpu_torch.core import checkpoint as ckpt

    kept = os.path.join(root, "committed")
    os.makedirs(kept)
    mirror = os.path.join(root, "mirror")
    walls = {}
    for label, extra in (
            ("blocking", []),
            ("async", ["--async-checkpoints", "--remote-sync", mirror,
                       "--remote-sync-frequency", "1", "--report-to",
                       "jsonl", "--logs", f"{root}/logs", "--name",
                       "async"])):
        directory = os.path.join(root, f"ckpt-{label}")

        def write(d, path, state, keep_n):
            real(d, path, state, keep_n)
            # a second name for each committed file: the prune removes
            # the first one
            os.link(path, os.path.join(kept, f"{label}-"
                                             f"{os.path.basename(path)}"))

        log = _EpochWalls()
        logging.getLogger().addHandler(log)
        try:
            with patched(ckpt, "_write", write) as real:
                recipe_run(counters, f"checkpoints {label}", [
                    "--dataset-type", "csv", "--train-data",
                    f"{root}/data.tsv", "--epochs", str(LOOP_CKPT_EPOCHS),
                    "--checkpoint-dir", directory,
                    "--delete-previous-checkpoint", *extra],
                    ROUTES["composable"][1],
                    LOOP_CKPT_EPOCHS * (RECIPE_TSV // TRAIN_BATCH), gpu,
                    tag="loop")
        finally:
            logging.getLogger().removeHandler(log)
        last = f"{ckpt.CKPT_PREFIX}{LOOP_CKPT_EPOCHS}.pt"
        if sorted(os.listdir(directory)) != [last]:
            raise AssertionError(f"checkpoints {label}: "
                                 f"{os.listdir(directory)}")
        walls[label] = log.walls
    names = sorted(os.listdir(mirror))
    caught = [n for n in names if same_bytes(os.path.join(mirror, n),
                                             os.path.join(kept, f"async-{n}"))]
    # the kept checkpoint's second name is the file itself
    if last not in names or caught != names or not os.path.samefile(
            os.path.join(kept, f"async-{last}"),
            os.path.join(root, "ckpt-async", last)):
        raise AssertionError(f"mirror {names}: byte-equal {caught}")
    size = os.path.getsize(os.path.join(mirror, last)) / 2 ** 30
    print(f"[loop] (c) --delete-previous-checkpoint, {LOOP_CKPT_EPOCHS} "
          f"epochs of {RECIPE_TSV // TRAIN_BATCH} step(s), {size:.2f} GiB a "
          f"checkpoint: epoch walls "
          f"blocking {walls['blocking']} s, async {walls['async']} s; the "
          f"mirror holds {names}, each byte-equal to its commit (no .tmp_*"
          f" file); on {gpu}")
    for d in ("ckpt-blocking", "ckpt-async", "committed", "mirror"):
        shutil.rmtree(os.path.join(root, d))


def check_train_loop(counters, base, train_rates, gpu, root):
    """Phase 15 in phase 12's fixture directory ``root``: (a) distillation,
    (b) validation, zero-shot and Flickr retrieval, (c) checkpoints and
    the mirror."""
    for part in (lambda: loop_distill(counters, train_rates, gpu, root),
                 lambda: loop_evals(counters, base, gpu, root),
                 lambda: loop_checkpoints(counters, gpu, root)):
        t0 = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[loop] part in {time.perf_counter() - t0:.1f} s on {gpu}")


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


def smooth_photo(rng, w, h):
    """A smooth random RGB field [h, w, 3] uint8 with mild noise, drawn
    from ``rng`` (pure noise decodes atypically slowly)."""
    from PIL import Image

    low = Image.fromarray(rng.integers(0, 256, (6, 8, 3), np.uint8))
    img = np.asarray(low.resize((w, h), Image.BICUBIC), np.int16)
    img = img + rng.integers(-6, 7, img.shape, np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_photos(paths, seed):
    """640x480 JPEGs of :func:`smooth_photo`, one seed a file, written on
    all cores."""
    from PIL import Image

    def one(i):
        Image.fromarray(smooth_photo(np.random.default_rng([seed, i]),
                                     PHOTO[1], PHOTO[0])).save(
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
    """A copy of ``model`` (LLaVA, or a T5 / BLIP family model) on its
    device with every tensor in ``dtype`` (the plain fp32 path on the bf16
    model's values), made on the card without a host copy."""
    with torch.device("meta"):
        out = type(model)(model.cfg).to(dtype)
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


def counted(counters, label, fn, want, tag="vqascore"):
    """fn() with every launch count set to 0 just before; the counts read
    just after must be ``want`` (0 for a kernel not named)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    expect = {k: want.get(k, 0) for k in counters}
    print(f"[{tag}] {label}: launches {got}")
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

    from clip_embeds_tpu_torch.core.convert import jax_params_from_module
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
    save_score_bundle(bundle, "llava", bcfg, jax_params_from_module(src),
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
    """Phase 10: LLaVA-1.5-7B VQAScore at full width and depth. Returns
    the bf16 model (on the host) and its W8A8 twin (on the card) for
    phase 11."""
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
        del score, scorer, ours
        # phase 11 takes the bf16 model back; off the card meanwhile (its
        # tower and embeddings stay there, shared with qmodel)
        model.to("cpu")
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
        del qscore
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the registry route from a score bundle
        check_bundle(tmp, cfg, tok, counters, gpu)
    return model, qmodel


# -- phase 11: VLM2Vec ----------------------------------------------------------


def v2v_requests(b, seed, image_size):
    """``b`` image query rows (64 tokens, the sentinel after BOS, right
    padded: 639 rows in the trunk) and ``b`` text target rows, drawn from
    ``seed`` as the synthetic route draws its rows."""
    from clip_embeds_tpu_torch.models.llava import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    out = {}
    for side in ("qry", "tgt"):
        ids = rng.integers(2, 90, (b, V2V_TOKENS)).astype(np.int32)
        mask = np.zeros((b, V2V_TOKENS), bool)
        for i in range(b):
            n = int(rng.integers(8, V2V_TOKENS))
            ids[i, n:] = 0
            mask[i, :n] = True
        ids[:, 0] = 1
        if side == "qry":
            ids[:, 1] = IMAGE_TOKEN_INDEX
        out[f"{side}_ids"], out[f"{side}_mask"] = ids, mask
    out["qry_pixels"] = rng.standard_normal(
        (b, image_size, image_size, 3)).astype(np.float32)
    return out


def v2v_cast(model, dtype, **llava_kw):
    """A copy of the LLaVA ``model`` on its device with its floating
    tensors in ``dtype`` (``llava_kw``: lora_rank, lora_alpha, remat)."""
    from clip_embeds_tpu_torch.models.llava import Llava

    with torch.device("meta"):
        out = Llava(model.cfg, **llava_kw).to(dtype)
    out.to_empty(device=next(model.parameters()).device)
    src = model.state_dict()
    with torch.no_grad():
        for name, t in out.state_dict().items():
            t.copy_(src[name])
    return out.requires_grad_(False).eval()


def model_view(model, cfg=None, strict=True, **kw):
    """``model`` rebuilt on its own tensors (nothing copied) as
    ``type(model)(cfg or model.cfg, **kw)``: its first layers where ``cfg``
    cuts depth; with ``strict=False`` the tensors it lacks stay on the meta
    device, for the caller to replace."""
    with torch.device("meta"):
        out = type(model)(cfg or model.cfg, **kw)
    keep = out.state_dict()
    out.load_state_dict({k: v for k, v in model.state_dict().items()
                         if k in keep}, assign=True, strict=strict)
    return out.requires_grad_(False).eval()


def cut_config(cfg, trunk, tower=None):
    """``cfg`` with its Llama trunk (``llama``, or ``text`` in Phi-3-V and
    the Qwen families) cut to ``trunk`` layers and, given ``tower``, its
    CLIP tower to that many."""
    name = "llama" if hasattr(cfg, "llama") else "text"
    cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
        getattr(cfg, name), num_layers=trunk)})
    if tower is not None:
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=tower))
    return cfg


def fingerprint(model):
    """Two exact integer checksums of each tensor's bits (the activation
    statistics left out), to hold a frozen base bit-equal without a copy."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    out = {}
    for k, t in model.state_dict().items():
        if k.endswith("act_max"):
            continue
        v = t.detach().contiguous().view(-1)
        v = v.view(ints[v.element_size()]).long()
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        out[k] = (int(v.sum()), int((v * w).sum()))
    return out


def v2v_embed(model, qmodel, ref, counters, gpu):
    """Phase 11 (a): embed_last_token on image query rows and text target
    rows, and embed_mixed on a mixed batch of the synthetic route, at
    batch 8 and 16, bf16 and W8A8, with exact launches; unit norm; the
    mixed batch against its rows on their own paths; bf16 against the
    plain fp32 path beside the no-kernel witness; W8A8 against bf16;
    embeds/s and peak memory."""
    from clip_embeds_tpu_torch.cli.train_vlm2vec import (
        _synthetic_mixed_batches, to_device)

    cfg = model.cfg
    tb, q = cfg.tower_blocks, 7 * cfg.llama.num_layers
    size = cfg.vision.image_size
    bf16 = torch.bfloat16
    outs = {}
    for label, m in (("bf16", model), ("int8", qmodel)):
        n8 = q if label == "int8" else 0
        torch.cuda.reset_peak_memory_stats()
        for b in V2V_BATCHES:
            req = to_device(v2v_requests(b, V2V_SEED, size), "cuda", bf16)
            mix = to_device(next(_synthetic_mixed_batches(b, size, V2V_SEED)),
                            "cuda", bf16)
            calls = {
                "image rows": (lambda: m.embed_last_token(
                    req["qry_ids"], req["qry_pixels"], req["qry_mask"]),
                    {"flash_attention": tb, "int8_linear": n8}),
                "text rows": (lambda: m.embed_last_token(
                    req["tgt_ids"], None, req["tgt_mask"]),
                    {"int8_linear": n8}),
                "mixed": (lambda: m.embed_mixed(
                    mix["qry_ids"], mix["qry_pixels"],
                    mix["qry_image_valid"], mix["qry_mask"]),
                    {"flash_attention": tb, "int8_linear": n8}),
            }
            with torch.inference_mode():
                for name, (fn, want) in calls.items():
                    emb = counted(counters, f"{label} {name} b{b}", fn, want,
                                  tag="vlm2vec").float()
                    norms = emb.norm(dim=-1)
                    if not (torch.isfinite(emb).all() and (
                            norms - 1).abs().max() < 2e-2):
                        raise AssertionError(f"{label} {name} b{b}: norms "
                                             f"{norms}")
                    outs[label, name, b] = emb
                    times = event_times(fn, V2V_TIME_ITERS)
                    ms = sum(times) / len(times)
                    print(f"[vlm2vec] {label} {name} b{b}: "
                          f"{b / ms * 1e3:.2f} embeds/s ({ms:.1f} ms, the "
                          f"mean of {len(times)} calls; range "
                          f"{min(times):.1f}-{max(times):.1f}) on {gpu}")
        print(f"[vlm2vec] {label} embedding peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {gpu}")

    b = V2V_BATCHES[0]
    mix = next(_synthetic_mixed_batches(b, size, V2V_SEED))
    on = to_device(mix, "cuda", bf16)
    args = ("qry_ids", "qry_pixels", "qry_image_valid", "qry_mask")
    got = outs["bf16", "mixed", b]
    with torch.inference_mode():
        split = []
        for i in range(b):
            n = int(mix["qry_mask"][i].sum())
            if mix["qry_image_valid"][i]:
                one = model.embed_last_token(on["qry_ids"][i:i + 1],
                                             on["qry_pixels"][i:i + 1],
                                             on["qry_mask"][i:i + 1])
            else:
                one = model.embed_last_token(on["qry_ids"][i:i + 1, :n],
                                             None, on["qry_mask"][i:i + 1, :n])
            split.append(one.float())
        split = torch.cat(split)
        plain = ref.embed_mixed(*(to_device(mix, "cuda", torch.float32)[k]
                                  for k in args))
        with plain_attention():
            witness = model.embed_mixed(*(on[k] for k in args)).float()
    read = {
        "mixed vs split rows": row_cos(got.cpu().numpy(),
                                       split.cpu().numpy()).min(),
        "bf16 vs plain fp32": row_cos(got.cpu().numpy(),
                                      plain.cpu().numpy()).min(),
        "witness vs plain fp32": row_cos(witness.cpu().numpy(),
                                         plain.cpu().numpy()).min(),
        "int8 vs bf16 (mixed)": row_cos(outs["int8", "mixed", b].cpu().numpy(),
                                        got.cpu().numpy()).min(),
        "int8 vs bf16 (image rows)": row_cos(
            outs["int8", "image rows", b].cpu().numpy(),
            outs["bf16", "image rows", b].cpu().numpy()).min(),
    }
    read = {k: float(v) for k, v in read.items()}
    print(f"[vlm2vec] least row cosine at b{b}: {read} (limits: split "
          f"{V2V_SPLIT_COS}, fp32 {V2V_FP32_COS}, int8 {V2V_INT8_COS}) on "
          f"{gpu}")
    if (read["mixed vs split rows"] < V2V_SPLIT_COS
            or read["bf16 vs plain fp32"] < V2V_FP32_COS
            or min(read["int8 vs bf16 (mixed)"],
                   read["int8 vs bf16 (image rows)"]) < V2V_INT8_COS):
        raise AssertionError(f"VLM2Vec embeddings disagree: {read}")


def v2v_train_launches(cfg, chunks, int8):
    """Each kernel's launches in one GradCache step of the synthetic mixed
    route: every embed_mixed call runs the tower (flash forward only: the
    frozen tower builds no graph) in the no-grad pass and the re-forward;
    the W8A8 trunk runs in both and again in the backward (remat)."""
    calls = 2 * chunks  # the two sides of each chunk
    want = {"flash_attention": 2 * calls * cfg.tower_blocks}
    if int8:
        want["int8_linear"] = 3 * calls * 7 * cfg.llama.num_layers
    return want


@contextlib.contextmanager
def shared_llava(model, qmodel, tokenize, saved):
    """The VLM2Vec entry points' load_base returns phase 10's models
    instead of building the tiny smoke model: the bf16 LLaVA-1.5-7B, or
    its W8A8 trunk with the LoRA side-path asked for; init_lora keeps a
    copy of the adapters it draws in ``saved``; a merged export is cut to
    2 + 2 layers first (phase 11 (d))."""
    from clip_embeds_tpu_torch.cli import train_vlm2vec
    from clip_embeds_tpu_torch.models import lora

    def load_base(ckpt, seed, device, dtype, quant=False, **llava_kw):
        if (ckpt, torch.device(device).type, dtype) != (
                None, "cuda", torch.bfloat16):
            raise AssertionError(f"phase 11 shares no model for {ckpt} "
                                 f"{device} {dtype}")
        m = (model_view(qmodel, quant_llm="dynamic", **llava_kw) if quant
             else model)
        return model.cfg, m, (tokenize, 1, 0)

    def init_lora(*a, **kw):
        tree = real_init(*a, **kw)
        saved.append({k: {n: t.clone() for n, t in ab.items()}
                      for k, ab in tree.items()})
        return tree

    def save_merged(path, cfg, merged):
        cut = cut_config(cfg, 2, 2)
        real_save(path, cut, model_view(merged, cut))

    real_init, real_save = lora.init_lora, train_vlm2vec.save_merged
    with patched(train_vlm2vec, "load_base", load_base), \
            patched(lora, "init_lora", init_lora), \
            patched(train_vlm2vec, "save_merged", save_merged):
        yield


def v2v_grads(model, adapters, batch, alpha, dtype, temperature=None):
    """The adapters' gradients through the train step's adapter path
    (train/vlm2vec.py adapter_runner: merged weights on an fp base, the
    side-path where the model has one) on the mixed ``batch``, of a fixed
    linear readout of the embeddings (the sum over rows of <embedding, u>,
    u drawn from V2V_SEED), or with ``temperature`` of the contrastive
    loss."""
    from clip_embeds_tpu_torch.cli.train_vlm2vec import to_device
    from clip_embeds_tpu_torch.losses.clip_loss import (
        embedding_contrastive_loss)
    from clip_embeds_tpu_torch.train.vlm2vec import adapter_runner

    t = {k: {n: v.detach().float().clone().requires_grad_()
             for n, v in ab.items()} for k, ab in adapters.items()}
    on = to_device(batch, "cuda", dtype)
    g = torch.Generator(device="cuda").manual_seed(V2V_SEED)
    u = torch.randn(2, len(batch["qry_ids"]), model.cfg.llama.hidden_size,
                    generator=g, device="cuda")

    def step_fn(call, flush):
        q, p = (call("embed_mixed", on[f"{s}_ids"], on[f"{s}_pixels"],
                     on[f"{s}_image_valid"], on[f"{s}_mask"]).float()
                for s in ("qry", "tgt"))
        loss = ((q * u[0]).sum() + (p * u[1]).sum() if temperature is None
                else embedding_contrastive_loss(q, p, temperature))
        loss.backward()
        flush()

    adapter_runner(model, alpha, True)(t, step_fn)
    return {f"{k}/{n}": t[k][n].grad for k in sorted(t) for n in "ab"}


def v2v_adapters(model):
    """LoRA adapters of the CLI's default targets (q/k/v/o/down) at
    V2V_RANK, seeded, with b drawn off zero so that every tensor has a
    gradient."""
    from clip_embeds_tpu_torch.models import lora

    g = torch.Generator(device="cuda").manual_seed(V2V_SEED)
    tree = lora.init_lora(model, rank=V2V_RANK, generator=g, targets=(
        "q_proj", "k_proj", "v_proj", "o_proj", "down_proj"))
    for ab in tree.values():
        ab["b"] = 0.02 * torch.randn(ab["b"].shape, generator=g,
                                     device="cuda")
    return tree


def v2v_gradients(model, qmodel, gpu):
    """Phase 11 (b'): the adapters' gradients (v2v_grads) of the
    contrastive loss at the recipe's temperature on a mixed batch of
    V2V_GRAD_BATCH rows, on views of the 7B with the trunk cut to
    V2V_GRAD_LAYERS layers at full width: the bf16 materialized kernel
    route (flash_attention in the tower) against the plain fp32 path (an
    fp32 copy of the cut with the side-path: the same function), beside
    the no-kernel witness; the W8A8 side-path route (int8_linear) against
    its witness (no plain int8 route on the card)."""
    from clip_embeds_tpu_torch.cli.train_vlm2vec import (
        _synthetic_mixed_batches)

    cut = cut_config(model.cfg, V2V_GRAD_LAYERS)
    small = model_view(model, cut)
    ref = v2v_cast(small, torch.float32, lora_rank=V2V_RANK,
                   lora_alpha=float(V2V_ALPHA))
    qsmall = model_view(qmodel, cut, quant_llm="dynamic", lora_rank=V2V_RANK,
                        lora_alpha=float(V2V_ALPHA))
    batch = next(_synthetic_mixed_batches(V2V_GRAD_BATCH,
                                          cut.vision.image_size, V2V_SEED))
    tree, bf16 = v2v_adapters(small), torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    want = v2v_grads(ref, tree, batch, V2V_ALPHA, torch.float32, 0.02)
    got = v2v_grads(small, tree, batch, V2V_ALPHA, bf16, 0.02)
    qgot = v2v_grads(qsmall, tree, batch, V2V_ALPHA, bf16, 0.02)
    with plain_attention():
        wit = v2v_grads(small, tree, batch, V2V_ALPHA, bf16, 0.02)
        qwit = v2v_grads(qsmall, tree, batch, V2V_ALPHA, bf16, 0.02)
    read = {"kernel": grad_agreement(got, want),
            "witness": grad_agreement(wit, want),
            "int8 kernel vs its witness": grad_agreement(qgot, qwit)}
    print(f"[vlm2vec] adapter gradients at b{V2V_GRAD_BATCH}, trunk cut to "
          f"{V2V_GRAD_LAYERS} layers (cosine over all, least per tensor, "
          f"its name): {read} (limits {V2V_GRAD_COS_MIN} over all, "
          f"{V2V_GRAD_BELOW_WITNESS} under the witness, "
          f"{V2V_GRAD_TENSOR_COS_MIN} per tensor; int8 "
          f"{V2V_INT8_GRAD_COS_MIN}, {V2V_INT8_GRAD_TENSOR_COS_MIN}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {gpu}")
    (k_all, k_min, _), (w_all, _, _) = read["kernel"], read["witness"]
    q_all, q_min, _ = read["int8 kernel vs its witness"]
    if (k_all < V2V_GRAD_COS_MIN or k_all < w_all - V2V_GRAD_BELOW_WITNESS
            or k_min < V2V_GRAD_TENSOR_COS_MIN
            or q_all < V2V_INT8_GRAD_COS_MIN
            or q_min < V2V_INT8_GRAD_TENSOR_COS_MIN):
        raise AssertionError(f"adapter gradients disagree: {read}")


def v2v_train(model, qmodel, tmp, tokenize, counters, gpu):
    """Phase 11 (b): cli/train_vlm2vec.py main on the synthetic mixed route,
    V2V_TRAIN_STEPS steps at batch V2V_TRAIN_BATCH with GradCache, LoRA r16
    alpha 64, bf16, on the bf16 base (materialized adapters) and with
    --quant_base; exact launches, finite losses, every adapter moved, the
    base bit-equal. Returns each route's adapter file."""
    from clip_embeds_tpu_torch.cli.train_vlm2vec import main as train_main
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    counters = dict(counters, int8_linear=int8_linear)
    cfg = model.cfg
    files = {}
    for route, base in (("bf16", model), ("quant_base", qmodel)):
        chunks = V2V_TRAIN_BATCH // V2V_CHUNK[route]
        out = os.path.join(tmp, f"train_{route}")
        argv = ["--lora", "--lora_r", str(V2V_RANK), "--lora_alpha",
                str(V2V_ALPHA), "--bf16", "--grad_cache", "--gc_q_chunk_size",
                str(V2V_CHUNK[route]), "--per_device_train_batch_size",
                str(V2V_TRAIN_BATCH), "--max_steps", str(V2V_TRAIN_STEPS),
                "--logging_steps", "1", "--output_dir", out,
                "--data_parallel", "1"]
        if route == "quant_base":
            argv.append("--quant_base")
        want = {k: V2V_TRAIN_STEPS * v for k, v in v2v_train_launches(
            cfg, chunks, route == "quant_base").items()}
        before = fingerprint(base)
        saved = []
        t0 = time.perf_counter()
        with shared_llava(model, qmodel, tokenize, saved):
            state, report = counted(
                counters, f"train {route}: {V2V_TRAIN_STEPS} steps at b"
                f"{V2V_TRAIN_BATCH}, {chunks} grad-cache chunks",
                lambda: train_main(argv), want, tag="vlm2vec")
        took = time.perf_counter() - t0
        losses = report["losses"]
        if len(losses) != V2V_TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"train {route}: losses {losses}")
        moved = [k for k, ab in state.params.items() for n in "ab"
                 if torch.equal(ab[n].detach(), saved[0][k][n])]
        if moved:
            raise AssertionError(f"train {route}: adapters that did not "
                                 f"move: {moved[:3]}")
        if fingerprint(base) != before:
            raise AssertionError(f"train {route}: the frozen base changed")
        print(f"[vlm2vec] train {route}: losses {losses}; samples/s "
              f"{[round(r, 2) for r in report['samples_per_s']]} (the "
              f"running rate after each step); peak "
              f"{report['peak_gib']:.2f} GiB; {len(state.params)} adapted "
              f"kernels all moved; base bit-equal; main took {took:.1f} s "
              f"on {gpu}")
        files[route] = os.path.join(out, "adapter-final.npz")
        del state
        gc.collect()
        torch.cuda.empty_cache()

    return files


def write_mmeb_eval(root, seed):
    """An MMEB-eval fixture: I2T (image queries, text candidates) and T2I
    (text queries, image candidates), V2V_EVAL_QUERIES queries of
    V2V_EVAL_CANDS candidates each, gold first, JPEGs as phase 7 writes
    them."""
    n_photos = 2 * V2V_EVAL_QUERIES
    write_photos([os.path.join(root, "images", f"p{i}.jpg")
                  for i in range(n_photos)], seed)
    words = [f"a {o} {p} a {o2}" for o in OBJECTS[:6] for o2 in OBJECTS[:3]
             for p in ("on", "under")]
    i2t = [{"qry_text": f"what is in photo {i}", "qry_img_path": f"p{i}.jpg",
            "tgt_text": [words[(i + 5 * j) % len(words)]
                         for j in range(V2V_EVAL_CANDS)],
            "tgt_img_path": [""] * V2V_EVAL_CANDS}
           for i in range(V2V_EVAL_QUERIES)]
    t2i = [{"qry_text": f"find the photo of {words[i]}", "qry_img_path": "",
            "tgt_text": ["<image>\na photo"] * V2V_EVAL_CANDS,
            "tgt_img_path": [f"p{(i + 3 * j) % n_photos}.jpg"
                             for j in range(V2V_EVAL_CANDS)]}
           for i in range(V2V_EVAL_QUERIES)]
    for name, rows in (("I2T", i2t), ("T2I", t2i)):
        with open(os.path.join(root, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)


def v2v_eval_launches(root, cfg, int8):
    """The eval CLI's launches on the fixture: per subset and side, the
    deduplicated image rows and text rows in batches of V2V_EVAL_BATCH,
    the tower once a batch of image rows, the W8A8 trunk once a batch."""
    from clip_embeds_tpu_torch.evals.mmeb import dedup_pairs

    want = {"flash_attention": 0, "int8_linear": 0}
    for name in ("I2T", "T2I"):
        with open(os.path.join(root, f"{name}.json")) as fh:
            rows = json.load(fh)
        sides = (dedup_pairs([(r["qry_text"], r["qry_img_path"])
                              for r in rows]),
                 dedup_pairs([p for r in rows
                              for p in zip(r["tgt_text"], r["tgt_img_path"])]))
        for pairs in sides:
            n_img = sum(1 for _, im in pairs if im)
            batches = [math.ceil(n_img / V2V_EVAL_BATCH),
                       math.ceil((len(pairs) - n_img) / V2V_EVAL_BATCH)]
            want["flash_attention"] += batches[0] * cfg.tower_blocks
            if int8:
                want["int8_linear"] += sum(batches) * 7 * cfg.llama.num_layers
    return want


def v2v_eval(model, qmodel, tmp, files, tokenize, counters, gpu):
    """Phase 11 (c): cli/eval_mmeb.py main on the fixture with (b)'s
    adapters, merged on the bf16 base and served over the W8A8 trunk:
    exact launches, accuracies in [0, 1], a second run reads the embedding
    cache back to the same table with no launch; items/s."""
    from clip_embeds_tpu_torch.cli.eval_mmeb import main as eval_main
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    counters = dict(counters, int8_linear=int8_linear)
    root = os.path.join(tmp, "mmeb_eval")
    write_mmeb_eval(root, V2V_SEED)
    for how, flag, adapter in (("merged", "--lora", files["bf16"]),
                               ("quant_base", "--quant_base",
                                files["quant_base"])):
        out = os.path.join(tmp, f"eval_{how}")
        argv = [flag, "--checkpoint_path", adapter, "--lora_r", str(V2V_RANK),
                "--lora_alpha", str(V2V_ALPHA), "--dataset_name", root,
                "--subset_name", "I2T", "T2I", "--image_dir",
                os.path.join(root, "images"), "--encode_output_path", out,
                "--per_device_train_batch_size", str(V2V_EVAL_BATCH)]
        want = v2v_eval_launches(root, model.cfg, how == "quant_base")
        with shared_llava(model, qmodel, tokenize, []):
            table, report = counted(counters, f"eval_mmeb {how}",
                                    lambda: eval_main(argv), want,
                                    tag="vlm2vec")
            again, cached = counted(counters, f"eval_mmeb {how}, cached",
                                    lambda: eval_main(argv), {},
                                    tag="vlm2vec")
        accs = [r["acc"] for r in table["subsets"].values()]
        if (len(accs) != 2 or not all(0 <= a <= 1 for a in accs)
                or again != table or cached["items"] != 0):
            raise AssertionError(f"eval_mmeb {how}: {table} / {again} "
                                 f"{cached}")
        print(f"[vlm2vec] eval_mmeb {how}: {table}; "
              f"{report['items_per_s']:.2f} items/s ({report['items']} "
              f"items in {report['seconds']:.1f} s, dedup'd, batch "
              f"{V2V_EVAL_BATCH}); the cached run read them back on {gpu}")
        gc.collect()
        torch.cuda.empty_cache()


def check_vlm2vec(model, qmodel, counters, gpu):
    """Phase 11: VLM2Vec over phase 10's LLaVA-1.5-7B (bf16) and its W8A8
    trunk: (a) embedding, (b) training through the CLI, (c) the MMEB eval
    through the CLI, (d) the merged bundle of (b), cut to 2 + 2 layers."""
    from clip_embeds_tpu_torch.cli.train_vlm2vec import to_device
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear
    from clip_embeds_tpu_torch.scores.build import (
        config_from_dict, llava_from_params, load_score_bundle)
    from clip_embeds_tpu_torch.models.llava import LlavaConfig

    counters = dict(counters, int8_linear=int8_linear)
    tok = word_tokenizer(V2V_SEED, model.cfg.llama.vocab_size)
    # the plain fp32 path (plain attention, TF32 off)
    ref = v2v_cast(model, torch.float32)
    t0 = time.perf_counter()
    v2v_embed(model, qmodel, ref, counters, gpu)
    print(f"[phase 11] (a) {time.perf_counter() - t0:.1f} s on {gpu}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v2v_gradients(model, qmodel, gpu)
    print(f"[phase 11] gradients {time.perf_counter() - t0:.1f} s on {gpu}")
    cut = cut_config(model.cfg, V2V_TRAIN_LAYERS)
    mcut = model_view(model, cut)
    qcut = model_view(qmodel, cut, quant_llm="dynamic")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = v2v_train(mcut, qcut, tmp, tok, counters, gpu)
        print(f"[phase 11] (b) {time.perf_counter() - t0:.1f} s on {gpu} "
              f"(trunk cut to {V2V_TRAIN_LAYERS} layers)")
        t0 = time.perf_counter()
        v2v_eval(mcut, qcut, tmp, files, tok, counters, gpu)
        print(f"[phase 11] (c) {time.perf_counter() - t0:.1f} s on {gpu}")

        # (d) the merged bundle of (b), cut to 2 + 2 layers
        path = os.path.join(tmp, "train_bf16", "merged")
        meta, params = load_score_bundle(path)
        cfg = config_from_dict(LlavaConfig, meta["model"])
        small = llava_from_params(params, cfg, "cuda", torch.bfloat16)
        batch = to_device(v2v_requests(2, V2V_SEED, cfg.vision.image_size),
                          "cuda", torch.bfloat16)
        with torch.inference_mode():
            emb = small.embed_last_token(batch["qry_ids"],
                                         batch["qry_pixels"],
                                         batch["qry_mask"]).float()
        size = os.path.getsize(os.path.join(path, "params.npz"))
        if (cfg.llama.num_layers, cfg.tower_blocks) != (2, 1) or \
                not torch.isfinite(emb).all():
            raise AssertionError(f"merged bundle: {cfg} {emb}")
        print(f"[vlm2vec] merged bundle (cut to 2 + 2 layers, "
              f"{size / 2**30:.2f} GiB) loaded through load_score_bundle; "
              f"its embeddings finite, shape {tuple(emb.shape)}")
        del small, params


# -- phase 13: the T5 and BLIP score families ----------------------------------


def t5_word_tokenizer(seed, vocab):
    """A seeded word-hash tokenizer in T5's manner: no BOS, ids
    2..vocab-1, the EOS id 1 last (the card's machine has no
    sentencepiece model)."""
    def tokenize(text):
        return [2 + zlib.crc32(f"{seed}:{w}".encode()) % (vocab - 2)
                for w in text.split()] + [1]
    return tokenize


def t5_cut(cfg, layers):
    """``cfg`` with its T5 trunk cut to ``layers`` encoder and decoder
    layers."""
    return dataclasses.replace(cfg, t5=dataclasses.replace(
        cfg.t5, num_layers=layers, num_decoder_layers=layers))


def t5_int8_per_pass(cfg):
    """int8_linear launches a W8A8 T5 pass: 7 an encoder layer (q, k, v, o,
    wi_0, wi_1, wo), 11 a decoder layer (and the cross-attention's 4)."""
    return 7 * cfg.t5.num_layers + 11 * cfg.t5.decoder_layers


def spread(label, scores):
    """(max - min) / max of the scores, printed beside their range;
    raises where they collapse to one value."""
    lo, hi = float(scores.min()), float(scores.max())
    rel = (hi - lo) / hi
    print(f"[t5] {label} scores {lo:.6g}..{hi:.6g}, log spread "
          f"{math.log(hi / lo):.4f}, relative spread {rel:.3g} (limit "
          f"{T5_SPREAD_MIN})")
    if rel < T5_SPREAD_MIN:
        raise AssertionError(f"{label}: every score equal: {scores}")


def timed_paths(paths, k, n, label, counters, gpu):
    """Each (fn, launches) of ``paths``: run once with exact launches, its
    scores checked in (0, 1], then timed over T5_TIME_ITERS calls by CUDA
    events. Returns {path: scores [k, n]}."""
    scores = {}
    for name, (fn, want) in paths.items():
        scores[name] = counted(counters, f"{label} {name} path, {k} images "
                               f"x {n} texts", fn, want, tag="t5")
        check_scores(f"{label} {name}", scores[name])
        times = event_times(fn, T5_TIME_ITERS)
        ms = sum(times) / len(times)
        print(f"[t5] {label} {name}: {k * n / ms * 1e3:.2f} pairs/s "
              f"({k * n} pairs in {ms:.1f} ms, the mean of {len(times)} "
              f"calls; range {min(times):.1f}-{max(times):.1f} ms) on {gpu}")
    return scores


def clip_t5_paths(score, images, texts, label, counters, gpu, int8):
    """The three T5VQAScore paths with their launches: #4 23 a tower call
    (one a chunk of pairs, one an image, one a group), int8_linear 432 a
    W8A8 T5 pass (a chunk of batch_size pairs)."""
    scorer = score.pair_forward.__self__
    cfg = scorer.model.cfg
    tb, bs = cfg.tower_blocks, scorer.batch_size
    q = t5_int8_per_pass(cfg) if int8 else 0
    k, n = len(images), len(texts)
    chunks = math.ceil(k * n / bs)
    return timed_paths({
        "pair": (lambda: score.pair_forward(
            [im for im in images for _ in texts], list(texts) * k
        ).reshape(k, n), {"flash_attention": chunks * tb,
                          "int8_linear": chunks * q}),
        "per-image": (lambda: np.stack([
            score.image_texts_forward(im, list(texts)) for im in images]),
            {"flash_attention": k * tb,
             "int8_linear": k * math.ceil(n / bs) * q}),
        "groups": (lambda: score(list(images), list(texts)),
                   {"flash_attention": math.ceil(k / score.group_size) * tb,
                    "int8_linear": chunks * q}),
    }, k, n, label, counters, gpu)


def instructblip_paths(score, images, texts, label, counters, gpu, int8):
    """InstructBLIP's pair path and forward_image_texts: #4 39 an EVA-g
    call (one a chunk of pairs, one an image), int8_linear 432 a W8A8 T5
    pass."""
    scorer = score.pair_forward.__self__
    cfg = scorer.model.cfg
    layers, bs = cfg.vision.layers, scorer.batch_size
    q = t5_int8_per_pass(cfg) if int8 else 0
    k, n = len(images), len(texts)
    chunks = math.ceil(k * n / bs)
    return timed_paths({
        "pair": (lambda: score.pair_forward(
            [im for im in images for _ in texts], list(texts) * k
        ).reshape(k, n), {"flash_attention": chunks * layers,
                          "int8_linear": chunks * q}),
        "per-image": (lambda: score(list(images), list(texts)),
                      {"flash_attention": k * layers,
                       "int8_linear": k * math.ceil(n / bs) * q}),
    }, k, n, label, counters, gpu)


@torch.inference_mode()
def answer_logits(scorer, images, texts):
    """One batch of k x n pairs: (scores [k * n], the answer positions'
    logits rows, fp32 on the host). CLIP-FlanT5 through its features,
    InstructBLIP through its full forward."""
    from clip_embeds_tpu_torch.models.llava import IGNORE_INDEX
    from clip_embeds_tpu_torch.scores.vqa_score import (
        DEFAULT_ANSWER_TEMPLATE, DEFAULT_QUESTION_TEMPLATE, _exp_neg_mean_ce)

    pairs = [(im, t) for im in images for t in texts]
    model = scorer.model
    if hasattr(scorer, "encode_image_features"):
        feats = scorer.encode_image_features(images)
        q_ids, a_ids = scorer._tokenize_pairs(
            [t for _, t in pairs], DEFAULT_QUESTION_TEMPLATE,
            DEFAULT_ANSWER_TEMPLATE)
        ids, enc_mask, labels, dec_mask = scorer.batch_inputs(q_ids, a_ids)
        idx = torch.arange(len(images), device=scorer.device
                           ).repeat_interleave(len(texts))
        logits = model.forward_with_features(ids, feats[idx], labels,
                                             enc_mask, dec_mask)
    else:
        from clip_embeds_tpu_torch.scores.vqa_score import (
            INSTRUCTBLIP_ANSWER_TEMPLATE, INSTRUCTBLIP_QUESTION_TEMPLATE)

        q_ids, t_ids, a_ids = scorer._tokenize(
            [t for _, t in pairs], INSTRUCTBLIP_QUESTION_TEMPLATE,
            INSTRUCTBLIP_ANSWER_TEMPLATE)
        q, t, labels, q_mask, t_mask, dec_mask = scorer._inputs(
            q_ids, t_ids, a_ids)
        logits = model(scorer._pixels([im for im, _ in pairs]), q, t,
                       labels, q_mask, t_mask, dec_mask)
    scores = _exp_neg_mean_ce(logits.float(), labels).cpu().numpy()
    return scores, logits[labels != IGNORE_INDEX].float().cpu()


def agreement(ours, ref):
    """(max |delta log score|, least row cosine) of two answer_logits."""
    return (log_diff(ours[0], ref[0]),
            float(F.cosine_similarity(ours[1], ref[1], dim=-1).min()))


def plain_fp32_check(label, make_scorer, model, images, texts, gpu):
    """The bf16 kernel route against the plain fp32 path on the T5 trunk
    cut to T5_CUT_LAYERS + T5_CUT_LAYERS layers (full width, the towers
    whole), beside the bf16 no-kernel witness on the same cut: max |delta
    log score| and the least cosine of the answer rows' logits."""
    cut = model_view(model, t5_cut(model.cfg, T5_CUT_LAYERS))
    ref = cast_copy(cut, torch.float32)
    imgs = images[:T5_PLAIN_IMAGES]
    want = answer_logits(make_scorer(ref), imgs, texts)
    got = answer_logits(make_scorer(cut), imgs, texts)
    with plain_attention():
        wit = answer_logits(make_scorer(cut), imgs, texts)
    read = {"kernel": agreement(got, want), "witness": agreement(wit, want)}
    print(f"[t5] {label} bf16 vs plain fp32, T5 cut to {T5_CUT_LAYERS} + "
          f"{T5_CUT_LAYERS} layers, {len(imgs)} images x {len(texts)} texts "
          f"({want[1].shape[0]} answer rows): max |d log score|, min row "
          f"cosine: {read} (limits {T5_FP32_LOG_TOL}, {T5_FP32_COS}) on "
          f"{gpu}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return read


def check_t5_vqascore(counters, gpu, images, texts):
    """Phase 13 (a) and (b): CLIP-FlanT5-XXL and InstructBLIP-FlanT5-XXL,
    bf16 then W8A8 (the T5 trunk quantised from the bf16 model's seeded
    values, shared by both)."""
    from clip_embeds_tpu_torch.core.factory import init_score_model
    from clip_embeds_tpu_torch.models.clip_t5 import CLIPT5
    from clip_embeds_tpu_torch.models.instructblip import InstructBlipT5
    from clip_embeds_tpu_torch.models.quant import quantize_clip_t5_trunk
    from clip_embeds_tpu_torch.scores.build import default_model_config
    from clip_embeds_tpu_torch.scores.score import (
        InstructBlipVQAScore, T5VQAScore)
    from clip_embeds_tpu_torch.scores.vqa_score import (
        InstructBlipVQAScorer, T5VQAScorer)

    cfg = default_model_config("clip-flant5-xxl")
    ib_cfg = default_model_config("instructblip-flant5-xxl")
    tok = t5_word_tokenizer(T5_SEED, cfg.t5.vocab_size)
    qtok = word_tokenizer(T5_SEED, ib_cfg.qformer.vocab_size)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = CLIPT5(cfg)
    model = init_score_model(model, T5_SEED, "cuda", bf16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[t5] CLIP-FlanT5-XXL (tower {cfg.tower_blocks} of "
          f"{cfg.vision.layers} blocks, T5 {cfg.t5.num_layers} + "
          f"{cfg.t5.decoder_layers} x {cfg.t5.d_model}, {cfg.t5.num_heads} "
          f"heads of {cfg.t5.d_kv}, d_ff {cfg.t5.d_ff}; {n_params / 1e9:.2f} "
          f"B parameters) bf16 built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (a) bf16: the three paths, their spread and agreement
    score = T5VQAScore(model, tok, group_size=T5_GROUP)
    s_bf16 = clip_t5_paths(score, images, texts, "clip-flant5 bf16",
                           counters, gpu, False)
    peak_bf16 = torch.cuda.max_memory_allocated()
    spread("clip-flant5 bf16", s_bf16["groups"])
    agree = {k: log_diff(v, s_bf16["groups"]) for k, v in s_bf16.items()}
    print(f"[t5] clip-flant5 bf16 paths against groups, max |d log score| "
          f"(limit {T5_PATHS_LOG_TOL}): {agree}; peak "
          f"{peak_bf16 / 2**30:.2f} GiB on {gpu}")
    if max(agree.values()) > T5_PATHS_LOG_TOL:
        raise AssertionError(f"the bf16 CLIP-FlanT5 paths disagree: {agree}")
    read = plain_fp32_check(
        "clip-flant5", lambda m: T5VQAScorer(m, tok), model, images, texts,
        gpu)
    if read["kernel"][0] > T5_FP32_LOG_TOL or read["kernel"][1] < T5_FP32_COS:
        raise AssertionError(f"bf16 CLIP-FlanT5 disagrees with fp32: {read}")
    rows_bf16 = answer_logits(score.pair_forward.__self__,
                              images[:T5_PLAIN_IMAGES], texts)

    # (b) InstructBLIP-FlanT5-XXL on the same T5 trunk
    t0 = time.perf_counter()
    with torch.device("meta"):
        ib = InstructBlipT5(ib_cfg)
    ib = init_score_model(ib, T5_SEED + 1, "cuda", bf16, t5=model.t5)
    torch.cuda.synchronize()
    print(f"[t5] InstructBLIP-FlanT5-XXL (EVA-g {ib_cfg.vision.layers} x "
          f"{ib_cfg.vision.width}, {ib_cfg.vision.heads} heads of "
          f"{ib_cfg.vision.head_width}, {ib_cfg.vision.num_patches + 1} "
          f"rows; Q-Former {ib_cfg.qformer.num_layers} layers, "
          f"{ib_cfg.num_query_tokens} queries; the T5-XXL above) built in "
          f"{time.perf_counter() - t0:.1f} s")
    ib_score = InstructBlipVQAScore(ib, qtok, tok)
    ib_bf16 = instructblip_paths(ib_score, images, texts,
                                 "instructblip bf16", counters, gpu, False)
    spread("instructblip bf16", ib_bf16["pair"])
    d = log_diff(ib_bf16["per-image"], ib_bf16["pair"])
    print(f"[t5] instructblip bf16 per-image against pair, max |d log "
          f"score| {d:.4g} (limit {T5_PATHS_LOG_TOL})")
    if d > T5_PATHS_LOG_TOL:
        raise AssertionError(f"the bf16 InstructBLIP paths disagree: {d}")
    read = plain_fp32_check(
        "instructblip",
        lambda m: InstructBlipVQAScorer(m, qtok, tok), ib, images, texts,
        gpu)
    if read["kernel"][0] > T5_FP32_LOG_TOL or read["kernel"][1] < T5_FP32_COS:
        raise AssertionError(f"bf16 InstructBLIP disagrees with fp32: {read}")
    ib_rows_bf16 = answer_logits(ib_score.pair_forward.__self__,
                                 images[:T5_PLAIN_IMAGES], texts)

    # W8A8: the T5 trunk's 432 projections a pass through int8_linear
    t0 = time.perf_counter()
    qmodel = quantize_clip_t5_trunk(model)
    qib = model_view(ib, strict=False, quant_t5="dynamic")
    qib.t5 = qmodel.t5
    del score, ib_score, model, ib
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"[t5] W8A8 T5 trunk quantised on the card in "
          f"{time.perf_counter() - t0:.1f} s; the bf16 trunk freed")
    torch.cuda.reset_peak_memory_stats()
    qscore = T5VQAScore(qmodel, tok, group_size=T5_GROUP)
    s_int8 = clip_t5_paths(qscore, images, texts, "clip-flant5 int8",
                           counters, gpu, True)
    peak_int8 = torch.cuda.max_memory_allocated()
    vs = {k: log_diff(s_int8[k], s_bf16[k]) for k in s_int8}
    cos = agreement(answer_logits(qscore.pair_forward.__self__,
                                  images[:T5_PLAIN_IMAGES], texts),
                    rows_bf16)[1]
    print(f"[t5] clip-flant5 int8 against bf16, max |d log score| (limit "
          f"{T5_INT8_LOG_TOL}): {vs}; min answer-row logits cosine "
          f"{cos:.6f} (limit {T5_INT8_COS}); peak {peak_int8 / 2**30:.2f} "
          f"GiB (bf16 {peak_bf16 / 2**30:.2f}) on {gpu}")
    if (max(vs.values()) > T5_INT8_LOG_TOL or cos < T5_INT8_COS
            or peak_int8 >= peak_bf16):
        raise AssertionError(f"int8 CLIP-FlanT5: {vs}, cosine {cos}, peak "
                             f"{peak_int8} >= {peak_bf16}?")
    qib_score = InstructBlipVQAScore(qib, qtok, tok)
    ib_int8 = instructblip_paths(qib_score, images, texts,
                                 "instructblip int8", counters, gpu, True)
    vs = {k: log_diff(ib_int8[k], ib_bf16[k]) for k in ib_int8}
    cos = agreement(answer_logits(qib_score.pair_forward.__self__,
                                  images[:T5_PLAIN_IMAGES], texts),
                    ib_rows_bf16)[1]
    print(f"[t5] instructblip int8 against bf16, max |d log score| "
          f"{vs}; min answer-row logits cosine {cos:.6f} (limits "
          f"{T5_INT8_LOG_TOL}, {T5_INT8_COS}) on {gpu}")
    if max(vs.values()) > T5_INT8_LOG_TOL or cos < T5_INT8_COS:
        raise AssertionError(f"int8 InstructBLIP: {vs}, cosine {cos}")
    del qscore, qib_score, qmodel, qib
    gc.collect()
    torch.cuda.empty_cache()


def check_blip_scores(counters, gpu, images, texts):
    """Phase 13 (c): blip2-itm, blip2-itc and image-reward-v1 at full
    width from seeded fp32 bundles in the JAX layout (held in memory, not
    written: the loader is patched to hand them over), through
    get_score_model in bf16 with exact launches (#4 39 an EVA-g call, 24 a
    BLIP ViT-L call: one an image of the m x n broadcast), against the
    plain fp32 path (the bundle's source model, fp32 on the card)."""
    from clip_embeds_tpu_torch.core.convert import jax_params_from_module
    from clip_embeds_tpu_torch.core.factory import init_score_model
    from clip_embeds_tpu_torch.models.blip import ImageReward
    from clip_embeds_tpu_torch.models.blip2 import Blip2ITM
    from clip_embeds_tpu_torch.scores import build as score_build
    from clip_embeds_tpu_torch.scores.build import (
        _blip2_itc_score, config_to_dict, default_model_config)
    from clip_embeds_tpu_torch.scores.registry import get_score_model
    from clip_embeds_tpu_torch.scores.score import ITMScore, ImageRewardScore

    k = len(images)
    for family, cls, names in (
            ("blip2", Blip2ITM, (("blip2-itm", BLIP_ITM_TOL, ITMScore),
                                 ("blip2-itc", BLIP_ITC_TOL,
                                  _blip2_itc_score))),
            ("image_reward", ImageReward,
             (("image-reward-v1", REWARD_TOL, ImageRewardScore),))):
        cfg = default_model_config(names[0][0])
        tok = word_tokenizer(T5_SEED, (cfg.qformer if family == "blip2"
                                       else cfg.text).vocab_size)
        t0 = time.perf_counter()
        with torch.device("meta"):
            src = cls(cfg)
        src = init_score_model(src, T5_SEED + 2, "cuda", torch.float32)
        # the bundle's contents, held in memory: the registry route reads
        # them through the loader's place instead of 4.4 GB of .npz
        bundle = ({"family": family, "model": config_to_dict(cfg)},
                  jax_params_from_module(src))
        print(f"[t5] {family} bundle: {sum(p.numel() for p in src.parameters()) / 1e9:.3f} "
              f"B parameters in the JAX layout, in memory, made in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, tol, factory in names:
            t0 = time.perf_counter()
            with patched(score_build, "load_score_bundle",
                         lambda path, b=bundle: b):
                score = get_score_model(name, checkpoint=f"<{family}>",
                                        tokenize=tok)
            t_load = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = counted(counters, f"{name} bf16, {k} images x "
                          f"{len(texts)} texts",
                          lambda: score(list(images), list(texts)),
                          {"flash_attention": k * cfg.vision.layers},
                          tag="t5")
            dt = time.perf_counter() - t0
            want = factory(src, tok, image_size=cfg.vision.image_size)(
                list(images), list(texts))
            diff = float(np.abs(got - want).max())
            lo, hi = float(want.min()), float(want.max())
            print(f"[t5] {name}: loaded in {t_load:.1f} s; {k * len(texts)} "
                  f"pairs in {dt:.2f} s ({k * len(texts) / dt:.2f} pairs/s, "
                  f"the first call); plain fp32 {lo:.4g}..{hi:.4g}, max "
                  f"|bf16 - fp32| {diff:.4g} (limit {tol}) on {gpu}")
            if not np.isfinite(got).all() or diff > tol or hi - lo <= 0:
                raise AssertionError(f"{name}: {got} against {want}")
            del score
            gc.collect()
            torch.cuda.empty_cache()
        del src
        gc.collect()
        torch.cuda.empty_cache()


def check_t5_family(counters, gpu):
    """Phase 13: (a), (b) and (c) on phase 7's What'sUp-A fixture, written
    again from its seed: its first T5_GROUP images x T5_TEXTS options."""
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    counters = dict(counters, int8_linear=int8_linear)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "whatsup")
        write_whatsup(root, 7)
        data, _ = load_annotation(root, "a")
        images = [os.path.join(root, d["image_path"][5:])
                  for d in data[:T5_GROUP]]
        texts = data[0]["caption_options"][:T5_TEXTS]
        t0 = time.perf_counter()
        check_t5_vqascore(counters, gpu, images, texts)
        print(f"[phase 13] (a) and (b) {time.perf_counter() - t0:.1f} s on "
              f"{gpu}")
        t0 = time.perf_counter()
        check_blip_scores(counters, gpu, images, texts)
        print(f"[phase 13] (c) {time.perf_counter() - t0:.1f} s on {gpu}")


# -- phase 14: VLM2Vec's other backbones ---------------------------------------


def vb_pack(rows, width):
    """Token rows (int lists) -> right-padded ids [B, width] (pad 0) and
    the bool mask of the real tokens."""
    ids = np.zeros((len(rows), width), np.int64)
    mask = np.zeros((len(rows), width), bool)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
        mask[i, :len(row)] = True
    return ids, mask


def vb_texts(rng, b, lo, hi, vocab, full=False):
    """b seeded text token lists of [lo, hi) tokens (``hi - 1`` each with
    ``full``), ids in [2, vocab)."""
    return [rng.integers(2, vocab, hi - 1 if full else int(
        rng.integers(lo, hi))).tolist() for _ in range(b)]


def phi3v_family(model):
    """Phi-3-V's requests through its own host processor on seeded images:
    b4 query rows (BOS, the image's negative ids, 8-45 text tokens,
    right-padded) of a square and of a 2:1 image (grids 4 x 4 and 3 x 5 at
    hd_num 16), the square batch again with 45 text tokens a row for the
    unmasked forward (2555 rows), b4 text-only target rows, and a mixed
    batch (two square-image rows, two text rows). Returns (the calls: name
    -> (f(model, inputs), launches), the inputs, the split call: the mixed
    batch's rows each on its own)."""
    from clip_embeds_tpu_torch.models.phi3_v import (
        phi3v_num_image_tokens, phi3v_process_image)

    rng = np.random.default_rng(VB_SEED)
    cfg, b = model.cfg, VB_BATCH
    vocab = cfg.text.vocab_size - 64
    inputs, grids = {}, {}
    for name, (w, h) in PHI_SIZES.items():
        crops = [phi3v_process_image(smooth_photo(rng, w, h), PHI_HD_NUM,
                                     PHI_HD_NUM) for _ in range(b)]
        grid = crops[0][1]
        assert all(g == grid for _, g in crops), [g for _, g in crops]
        grids[name] = grid
        image = [1] + [-1] * phi3v_num_image_tokens(*grid)
        width = len(image) + VB_TEXT
        ids, mask = vb_pack([image + t for t in vb_texts(
            rng, b, 8, VB_TEXT + 1, vocab)], width)
        inputs[name] = dict(ids=ids, mask=mask,
                            px=np.stack([c for c, _ in crops]))
        if name == "square":
            inputs["full"] = dict(ids=vb_pack([image + t for t in vb_texts(
                rng, b, 0, VB_TEXT + 1, vocab, full=True)], width)[0],
                px=inputs[name]["px"])
    ids, mask = vb_pack(vb_texts(rng, b, 8, VB_TARGET, vocab), VB_TARGET)
    inputs["tgt"] = dict(ids=ids, mask=mask)
    sq = inputs["square"]
    rows = [sq["ids"][i][sq["mask"][i]].tolist() for i in range(2)] + \
        vb_texts(rng, b - 2, 8, VB_TARGET, vocab)
    ids, mask = vb_pack(rows, sq["ids"].shape[1])
    px = sq["px"].copy()
    px[2:] = 0
    inputs["mixed"] = dict(ids=ids, mask=mask, px=px)
    tb, layers = cfg.tower_blocks, cfg.text.num_layers
    g_sq, g_wide = grids["square"], grids["2:1"]

    def embed(key, grid):
        return lambda m, r: m.embed_last_token(
            r[key]["ids"], r[key]["px"], *grid, r[key]["mask"])

    calls = {
        "image rows square": (embed("square", g_sq),
                              {"flash_attention": tb}),
        "image rows 2:1": (embed("2:1", g_wide), {"flash_attention": tb}),
        "text rows": (lambda m, r: m.embed_last_token(
            r["tgt"]["ids"], None, 1, 1, r["tgt"]["mask"]), {}),
        "mixed": (embed("mixed", g_sq), {"flash_attention": tb}),
        "forward": (lambda m, r: m(r["full"]["ids"], r["full"]["px"],
                                   *g_sq)[:, -1],
                    {"flash_attention": tb + layers}),
    }

    def split(m, r):
        mix, out = r["mixed"], []
        for i in range(b):
            n = len(rows[i])
            out.append(m.embed_last_token(
                mix["ids"][i:i + 1, :n],
                mix["px"][i:i + 1] if i < 2 else None, *g_sq,
                mix["mask"][i:i + 1, :n]))
        return torch.cat(out)

    return calls, inputs, split


def llava_next_family(model):
    """LLaVA-NeXT's requests (anyres at 672^2, the default pinpoints): b4
    query rows (BOS, the sentinel, 8-45 text tokens) of two square and two
    2:1 images in one call (5 crops a row, 2928 feature slots), b4
    text-only target rows, and a mixed batch (two image rows; two text
    rows holding the sentinel in their padding, their slots all
    invalid). ``forward`` reads the last valid row of the query rows,
    under the merge's mask as always."""
    from clip_embeds_tpu_torch.core.constants import (
        OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
    from clip_embeds_tpu_torch.models.llava import IMAGE_TOKEN_INDEX
    from clip_embeds_tpu_torch.models.llava_next import (
        anyres_pack_plan, process_anyres_image)

    rng = np.random.default_rng(VB_SEED + 1)
    cfg, b = model.cfg, VB_BATCH
    vocab = cfg.llama.vocab_size
    size, patch = cfg.vision.image_size, cfg.vision.patch_size
    px, plans = [], []
    for w, h in NEXT_SIZES * (b // 2):
        crops, hw = process_anyres_image(
            smooth_photo(rng, w, h), size, cfg.grid_pinpoints,
            OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
        px.append(crops)
        plans.append(anyres_pack_plan(hw, cfg.grid_pinpoints, size, patch,
                                      cfg.max_features))
    width = 2 + VB_TEXT
    texts = vb_texts(rng, b, 8, VB_TEXT + 1, vocab)
    ids, mask = vb_pack([[1, IMAGE_TOKEN_INDEX] + t for t in texts], width)
    stack = lambda k: np.stack([getattr(p, k) for p in plans])
    qry = dict(ids=ids, mask=mask, px=np.stack(px), gather=stack("gather"),
               newline=stack("is_newline"), valid=stack("valid"))
    ids, mask = vb_pack(vb_texts(rng, b, 8, VB_TARGET, vocab), VB_TARGET)
    tgt = dict(ids=ids, mask=mask)
    rows = [[1, IMAGE_TOKEN_INDEX] + t for t in texts[:2]] + [
        [1] + t for t in vb_texts(rng, b - 2, 8, VB_TEXT, vocab)]
    ids, mask = vb_pack(rows, width)
    for i in range(2, b):  # the sentinel in the padding, its slots invalid
        ids[i, len(rows[i])] = IMAGE_TOKEN_INDEX
    valid = qry["valid"].copy()
    valid[2:] = False
    inputs = dict(qry=qry, tgt=tgt,
                  mixed=dict(qry, ids=ids, mask=mask, valid=valid))
    tb = cfg.tower_blocks
    args = ("ids", "px", "gather", "newline", "valid", "mask")

    def embed(key):
        return lambda m, r: m.embed_last_token(*(r[key][k] for k in args))

    def forward(m, r):
        q = r["qry"]
        logits = m(*(q[k] for k in args))
        last = q["mask"].sum(1) - 2 + cfg.max_features  # the last text
        return logits[torch.arange(b, device=last.device), last]

    calls = {
        "image rows": (embed("qry"), {"flash_attention": tb}),
        "text rows": (lambda m, r: m.embed_last_token(
            r["tgt"]["ids"], attention_mask=r["tgt"]["mask"]), {}),
        "mixed": (embed("mixed"), {"flash_attention": tb}),
        "forward": (forward, {"flash_attention": tb}),
    }

    def split(m, r):
        mix, out = r["mixed"], []
        for i in range(b):
            if i < 2:
                out.append(m.embed_last_token(*(mix[k][i:i + 1]
                                                for k in args)))
            else:
                n = len(rows[i])
                out.append(m.embed_last_token(
                    mix["ids"][i:i + 1, :n],
                    attention_mask=mix["mask"][i:i + 1, :n]))
        return torch.cat(out)

    return calls, inputs, split


def qwen_pixels(img, vcfg):
    """One image through Qwen2-VL's host processing: smart_resize, a
    bicubic resize, CLIP normalisation, the merge-grouped patches."""
    from PIL import Image

    from clip_embeds_tpu_torch.core.constants import (
        OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
    from clip_embeds_tpu_torch.models.qwen2_vl import (
        image_to_patches, smart_resize)

    h, w = smart_resize(img.shape[0], img.shape[1])
    arr = np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC),
                     np.float32) / 255.0
    arr = (arr - np.asarray(OPENAI_DATASET_MEAN, np.float32)) / np.asarray(
        OPENAI_DATASET_STD, np.float32)
    return image_to_patches(arr.transpose(2, 0, 1), vcfg)


def qwen_family(model):
    """Qwen2-VL's or Qwen2.5-VL's requests (448^2 images: 32 x 32 patches,
    256 merged tokens; 16 windows in Qwen2.5's tower): b4 query rows (3
    text tokens, vision start, 256 image pads, vision end, 8-45 text
    tokens) with get_rope_index's 3-D positions, the same with 45 text
    tokens a row for the unmasked forward (305 rows), b4 text-only target
    rows, and a mixed batch (two image rows, two text rows whose patches
    are zeros)."""
    from clip_embeds_tpu_torch.models.qwen2_vl import get_rope_index

    cfg, b = model.cfg, VB_BATCH
    rng = np.random.default_rng(VB_SEED + 2)
    vocab = cfg.vision_start_token_id - 8
    pairs = [qwen_pixels(smooth_photo(rng, QWEN_SIZE, QWEN_SIZE), cfg.vision)
             for _ in range(b)]
    grid = pairs[0][1]
    n_img = int(np.prod(grid)) // cfg.vision.spatial_merge_size ** 2
    patches = np.stack([p for p, _ in pairs])

    def image_row(text):
        return (rng.integers(2, vocab, 3).tolist()
                + [cfg.vision_start_token_id]
                + [cfg.image_token_id] * n_img
                + [cfg.vision_start_token_id + 1] + text)

    width = 5 + n_img + VB_TEXT
    inputs = {}
    for key, full in (("qry", False), ("full", True)):
        rows = [image_row(t) for t in vb_texts(rng, b, 8, VB_TEXT + 1, vocab,
                                                full=full)]
        ids, mask = vb_pack(rows, width)
        inputs[key] = dict(ids=ids, mask=mask, patches=patches,
                           pos=get_rope_index(ids, [grid] * b, mask, cfg))
    ids, mask = vb_pack(vb_texts(rng, b, 8, VB_TARGET, vocab), VB_TARGET)
    inputs["tgt"] = dict(ids=ids, mask=mask,
                         pos=get_rope_index(ids, [], mask, cfg))
    q = inputs["qry"]
    rows = [q["ids"][i][q["mask"][i]].tolist() for i in range(2)] + \
        vb_texts(rng, b - 2, 8, VB_TEXT, vocab)
    ids, mask = vb_pack(rows, width)
    mixed_patches = patches.copy()
    mixed_patches[2:] = 0
    inputs["mixed"] = dict(ids=ids, mask=mask, patches=mixed_patches,
                           pos=get_rope_index(ids, [grid] * 2, mask, cfg))
    layers = cfg.text.num_layers

    def embed(key, image=True):
        return lambda m, r: m.embed_last_token(
            r[key]["ids"], r[key]["patches"] if image else None,
            grid if image else None, r[key]["mask"], r[key]["pos"])

    calls = {
        "image rows": (embed("qry"), {}),
        "text rows": (embed("tgt", False), {}),
        "mixed": (embed("mixed"), {}),
        "forward": (lambda m, r: m(r["full"]["ids"], r["full"]["patches"],
                                   grid, None, r["full"]["pos"])[:, -1],
                    {"flash_attention": layers}),
    }

    def split(m, r):
        mix, out = r["mixed"], []
        for i in range(b):
            n = len(rows[i])
            ids, mask = mix["ids"][i:i + 1, :n], mix["mask"][i:i + 1, :n]
            pos = torch.from_numpy(get_rope_index(
                ids.cpu().numpy(), [grid] if i < 2 else [],
                mask.cpu().numpy(), cfg)).to(ids.device)
            out.append(m.embed_last_token(
                ids, mix["patches"][i:i + 1] if i < 2 else None,
                grid if i < 2 else None, mask, pos))
        return torch.cat(out)

    return calls, inputs, split


def vb_to_device(inputs, dtype):
    """Every request's arrays on the card: ids and positions int64, masks
    bool, pixels and patches in ``dtype``."""
    out = {}
    for key, req in inputs.items():
        out[key] = {}
        for k, v in req.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[key][k] = (t.to(dtype) if t.is_floating_point() else t).to(
                "cuda")
    return out


def vb_serve(label, family, routes, counters, gpu):
    """Each call of ``family`` on each of ``routes`` ({route: (model,
    launches added to every call)}) with its launches held exactly,
    embeddings finite and unit-norm, logits finite; embeds/s by CUDA
    events and peak memory. Returns {(route, call): output, fp32}."""
    calls, inputs, _ = family
    outs = {}
    on = vb_to_device(inputs, torch.bfloat16)
    for route, (m, extra) in routes.items():
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            for name, (fn, want) in calls.items():
                out = counted(counters, f"{label} {route} {name}",
                              lambda: fn(m, on), {**want, **extra},
                              tag="backbones").float()
                bad = not bool(torch.isfinite(out).all())
                if name != "forward":
                    bad |= bool((out.norm(dim=-1) - 1).abs().max() > 2e-2)
                if bad:
                    raise AssertionError(f"{label} {route} {name}: not "
                                         f"finite, or not unit-norm")
                outs[route, name] = out
                times = event_times(lambda: fn(m, on), VB_TIME_ITERS)
                ms = sum(times) / len(times)
                rate = ("" if name == "forward" else
                        f"{VB_BATCH / ms * 1e3:.2f} embeds/s, ")
                print(f"[backbones] {label} {route} {name} b{VB_BATCH}: "
                      f"{rate}{ms:.1f} ms (the mean of {len(times)} calls; "
                      f"range {min(times):.1f}-{max(times):.1f}) on {gpu}")
        print(f"[backbones] {label} {route} peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {gpu}")
    return outs


def vb_agreement(model, family, outs):
    """Least row cosines of ``family`` on the bf16 ``model``: the mixed
    batch against its rows each on its own; the first image rows'
    embeddings and the forward's last logits row on the trunk cut to
    VB_PLAIN_LAYERS layers (full width, the tower whole), the bf16 kernel
    route and the no-kernel witness each against the plain fp32 path."""
    calls, inputs, split = family
    on = vb_to_device(inputs, torch.bfloat16)
    with torch.inference_mode():
        alone = split(model, on).float()
    read = {"mixed vs split rows": row_cos(
        outs["bf16", "mixed"].cpu().numpy(), alone.cpu().numpy()).min()}
    cut = model_view(model, cut_config(model.cfg, VB_PLAIN_LAYERS))
    ref = cast_copy(cut, torch.float32)
    on32 = vb_to_device(inputs, torch.float32)
    image = next(k for k in calls if k.startswith("image rows"))
    for name in (image, "forward"):
        fn = calls[name][0]
        with torch.inference_mode():
            got = fn(cut, on).float().cpu().numpy()
            plain = fn(ref, on32).float().cpu().numpy()
            with plain_attention():
                witness = fn(cut, on).float().cpu().numpy()
        read[f"{name} bf16 vs plain fp32"] = row_cos(got, plain).min()
        read[f"{name} witness vs plain fp32"] = row_cos(witness,
                                                         plain).min()
    del cut, ref, on32
    gc.collect()
    torch.cuda.empty_cache()
    return {k: float(v) for k, v in read.items()}


def vb_check(label, read, gpu):
    """Holds the readings to VB_SPLIT_COS, VB_FP32_COS and VB_INT8_COS
    (the witness's are printed beside the kernel route's)."""
    print(f"[backbones] {label} least row cosine: {read} (limits: split "
          f"{VB_SPLIT_COS}, fp32 {VB_FP32_COS}, int8 {VB_INT8_COS}) on "
          f"{gpu}")
    bad = {k: v for k, v in read.items() if "witness" not in k and v < (
        VB_SPLIT_COS if k.startswith("mixed") else
        VB_INT8_COS if k.startswith("int8") else VB_FP32_COS)}
    if bad:
        raise AssertionError(f"{label} disagrees: {bad}")


def vb_family_run(label, model, make_family, counters, gpu, qmodel=None):
    """One family of phase 14: every call with its launches, rates and
    peak, then the agreement readings held to their limits. With
    ``qmodel`` (the W8A8 twin) each call runs there too (int8_linear 7 a
    trunk layer a pass) and its image and text rows are held to bf16's."""
    t0 = time.perf_counter()
    family = make_family(model)
    routes = {"bf16": (model, {})}
    if qmodel is not None:
        routes["int8"] = (qmodel, {
            "int8_linear": 7 * qmodel.cfg.text.num_layers})
    outs = vb_serve(label, family, routes, counters, gpu)
    read = vb_agreement(model, family, outs)
    if qmodel is not None:
        for name in ("image rows", "text rows"):
            read[f"int8 vs bf16 ({name})"] = float(row_cos(
                outs["int8", name].cpu().numpy(),
                outs["bf16", name].cpu().numpy()).min())
    vb_check(label, read, gpu)
    print(f"[backbones] {label}: {time.perf_counter() - t0:.1f} s on {gpu}")
    return read


def vb_models():
    """Phase 14's four families: (label, a seeded constructor on the
    card, the request maker, with a W8A8 twin)."""
    from clip_embeds_tpu_torch.core.factory import init_vlm
    from clip_embeds_tpu_torch.models.llava_next import LlavaNextConfig
    from clip_embeds_tpu_torch.models.qwen2_vl import Qwen25VLConfig

    return (
        ("phi3.5-v", lambda: init_vlm("phi3_v", seed=VB_SEED),
         phi3v_family, False),
        ("llava-next", lambda: init_vlm("llava_next", cut_config(
            LlavaNextConfig(), VB_TRUNK_CUT), seed=VB_SEED),
         llava_next_family, False),
        ("qwen2-vl-7b", lambda: init_vlm("qwen2_vl", seed=VB_SEED),
         qwen_family, True),
        ("qwen2.5-vl-7b", lambda: init_vlm("qwen2_5_vl", cut_config(
            Qwen25VLConfig(), VB_TRUNK_CUT), seed=VB_SEED),
         qwen_family, False),
    )


def check_vlm_backbones(counters, gpu):
    """Phase 14: VLM2Vec's other backbones at full width from seeded
    weights: Phi-3.5-V (full depth), LLaVA-NeXT (the trunk cut to
    VB_TRUNK_CUT layers), Qwen2-VL-7B (full depth, bf16 and W8A8) and
    Qwen2.5-VL-7B (the trunk cut to VB_TRUNK_CUT layers), one at a time.
    Returns the readings by family."""
    from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
    from clip_embeds_tpu_torch.ops.fused_block import int8_linear

    counters = dict(counters, int8_linear=int8_linear)
    out = {}
    for label, build, make_family, int8 in vb_models():
        t0 = time.perf_counter()
        model = build()
        qmodel = quantize_llava_trunk(model, "dynamic") if int8 else None
        print(f"[backbones] {label} built in "
              f"{time.perf_counter() - t0:.1f} s on {gpu}")
        out[label] = vb_family_run(label, model, make_family, counters, gpu,
                                   qmodel)
        del model, qmodel
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 16: generation and CoCa ---------------------------------------------

# (a) LLaVA-1.5-7B greedy decoding: prompts of GEN_PROMPT ids (BOS, the
# image, 62 seeded word ids: 63 + 576 = 639 trunk rows, phase 3's prefill
# shape), GEN_NEW_TOKENS new tokens without eos, at GEN_BATCHES; after the
# counted call (the first at its shape, so also the warm-up), the whole
# call and the prefill alone each timed over GEN_TIME_ITERS calls (the
# median); the agreement on the trunk cut to GEN_CUT_LAYERS layers at full
# width (the tower whole)
GEN_SEED, GEN_PROMPT, GEN_NEW_TOKENS, GEN_BATCHES = 16, 64, 32, (1, 8)
GEN_TIME_ITERS, GEN_CUT_LAYERS = 2, 2  # 2 timed calls since phase 18
# limits (readings on the H100, scripts/chip_probe_generate.py; PERF.md):
# a decoded token must equal the argmax of the model's own teacher-forced
# full forward wherever that forward's top-2 logit margin exceeds
# GEN_MARGIN (bf16: the decode steps' plain attention over the cache and
# the forward's flash kernel round apart) or GEN_STATIC_MARGIN (the W8A8
# twin with static scales: its int8 products exact, but inputs a bf16
# rounding apart can land an int8 level apart) or
# GEN_INT8_MARGIN (W8A8 with dynamic scales, gross faults only: the scale
# is the abs-max of each call's rows, a decode step's 1-8 against the
# forward's 670 a prompt, so the sound reading is as large as JAX's
# position fault's); on the cut, bf16's tokens equal plain fp32's before
# fp32's first step under GEN_FP32_MARGIN, and the first token's logits
# cosine clears GEN_FP32_COS
GEN_MARGIN, GEN_STATIC_MARGIN, GEN_INT8_MARGIN = 0.5, 1.0, 2.0
GEN_FP32_MARGIN, GEN_FP32_COS = 0.5, 0.999
# (b) CoCa ViT-L/14 (open_clip's coca_ViT-L-14), seeded: COCA_IMAGES
# images and COCA_TEXTS texts a serving call, generation at COCA_GEN_BATCH
# over COCA_SEQ_LEN slots (timed as (a) is), top-p COCA_TOP_P, COCA_BEAMS
# beams; the top-k 1 tokens against the teacher-forced caption logits
# where the margin exceeds COCA_MARGIN; bf16 embeddings against plain
# fp32, least row cosine COCA_COS
COCA_MODEL, COCA_SEED = "coca_ViT-L-14", 16
COCA_IMAGES, COCA_TEXTS, COCA_GEN_BATCH, COCA_SEQ_LEN = 32, 256, 8, 30
COCA_TOP_P, COCA_BEAMS, COCA_MIN_LEN = 0.1, 6, 5
COCA_MARGIN, COCA_COS = 0.5, 0.99


def gen_prompts(b, vocab, seed):
    """``b`` prompts of GEN_PROMPT ids on the card: BOS, the image
    sentinel, then seeded word ids (one image a row, no padding)."""
    from clip_embeds_tpu_torch.models.llava import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    ids = np.empty((b, GEN_PROMPT), np.int64)
    ids[:, 0], ids[:, 1] = 1, IMAGE_TOKEN_INDEX
    ids[:, 2:] = rng.integers(2, vocab, (b, GEN_PROMPT - 2))
    return torch.from_numpy(ids).cuda()


@torch.inference_mode()
def teacher_forced(model, ids, px, tokens):
    """fp32 logits [B, T, V] of the LLaVA ``model``'s own full forward over
    the prompt and ``tokens`` [B, T] at the positions that predict each
    token (the unpadded trunk: the flash kernel's causal route in bf16 on
    the card)."""
    embeds = model.merge(ids, model.encode_images(px))
    lm = model.language_model
    hidden = lm.trunk(torch.cat([embeds, lm.embed(tokens[:, :-1])], 1))
    return lm.logits(hidden[:, embeds.shape[1] - 1:]).float()


def margins(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def forced_agreement(label, tokens, logits, bound, valid=None):
    """The decoded ``tokens`` [B, T] against the argmax of ``logits`` [B,
    T, V] at every step whose top-2 margin exceeds ``bound`` (and is
    ``valid``); returns (steps held, steps, the largest margin of a step
    whose token differs: the reading behind ``bound``) and raises on a
    mismatch above ``bound``."""
    m = margins(logits)
    if valid is None:
        valid = torch.ones_like(tokens, dtype=torch.bool)
    differ = valid & (logits.argmax(-1) != tokens)
    worst = float(m[differ].max()) if differ.any() else 0.0
    clear = valid & (m > bound)
    held, total = int(clear.sum()), int(valid.sum())
    if worst > bound:
        raise AssertionError(f"{label}: {int((differ & clear).sum())} "
                             f"decoded tokens differ from the "
                             f"teacher-forced argmax at a margin above "
                             f"{bound} (up to {worst})")
    return held, total, worst


@contextlib.contextmanager
def static_scales(qmodel, calibrate):
    """``qmodel``'s QuantLinear layers in static mode, each activation
    scale the abs-max that calibrate() shows it over 127
    (models/quant.py inject_act_scales); dynamic again on exit."""
    from clip_embeds_tpu_torch.models.quant import (
        inject_act_scales, quant_layers)

    layers = quant_layers(qmodel)
    for q in layers:
        q.act_max.zero_()
    calibrate()
    inject_act_scales(qmodel)
    try:
        yield qmodel
    finally:
        for q in layers:
            q.mode = "dynamic"


def first_low_margin(logits, bound):
    """Per row, the first step whose top-2 margin is at most ``bound``
    (the row's length where none is)."""
    low = margins(logits) <= bound
    idx = torch.arange(low.shape[1], device=low.device).expand_as(low)
    return torch.where(low, idx, low.shape[1]).amin(dim=1)


def gen_llava(model, qmodel, counters, gpu):
    """Phase 16 (a): greedy answers of LLaVA-1.5-7B and its W8A8 twin."""
    from clip_embeds_tpu_torch.evals.whatsup import load_annotation
    from clip_embeds_tpu_torch.image.preprocess import preprocess_batch
    from clip_embeds_tpu_torch.models.generate import llava_greedy_generate

    cfg = model.cfg
    layers, tb = cfg.llama.num_layers, cfg.tower_blocks
    int8_per_pass = 7 * layers
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "whatsup")
        write_whatsup(root, 7)
        data, _ = load_annotation(root, "a")
        paths = [os.path.join(root, d["image_path"][5:])
                 for d in data[:max(GEN_BATCHES)]]
        pixels = torch.from_numpy(preprocess_batch(
            paths, cfg.vision.image_size, "llava")).to("cuda", torch.bfloat16)
    first, decoded = {}, {}
    for b in GEN_BATCHES:
        ids = gen_prompts(b, cfg.llama.vocab_size, GEN_SEED)
        px = pixels[:b]
        for route, m in (("bf16", model), ("W8A8", qmodel)):
            want = {"flash_attention": tb + layers}
            if route == "W8A8":
                want["int8_linear"] = int8_per_pass * GEN_NEW_TOKENS
            label = f"{route} b{b}, {GEN_NEW_TOKENS} new tokens"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tokens = counted(counters, label, lambda: llava_greedy_generate(
                m, ids, px, GEN_NEW_TOKENS), want, tag="generate")
            peak = torch.cuda.max_memory_allocated()
            if tokens.shape != (b, GEN_NEW_TOKENS) or not (
                    (tokens >= 0) & (tokens < cfg.llama.vocab_size)).all():
                raise AssertionError(f"{label}: tokens {tokens}")
            logits = teacher_forced(m, ids, px, tokens)
            bound = GEN_MARGIN if route == "bf16" else GEN_INT8_MARGIN
            held, total, worst = forced_agreement(label, tokens, logits,
                                                  bound)
            first[route, b], decoded[route, b] = logits[:, 0], tokens
            full = event_times(lambda: llava_greedy_generate(
                m, ids, px, GEN_NEW_TOKENS), GEN_TIME_ITERS)
            full_ms = float(np.median(full))
            pre_ms = float(np.median(event_times(
                lambda: llava_greedy_generate(m, ids, px, 1),
                GEN_TIME_ITERS)))
            step_ms = (full_ms - pre_ms) / (GEN_NEW_TOKENS - 1)
            print(f"[generate] {label}: {held} of {total} steps clear the "
                  f"margin {bound} and equal the teacher-forced argmax "
                  f"(the largest margin of a differing step {worst:.4f}); "
                  f"{b * GEN_NEW_TOKENS / full_ms * 1e3:.1f} tokens/s "
                  f"({full_ms:.1f} ms a call, the median of {len(full)} "
                  f"after the counted one; range {min(full):.1f}-"
                  f"{max(full):.1f}), prefill {pre_ms:.2f} ms, "
                  f"{step_ms:.2f} ms a decode step, peak "
                  f"{peak / 2**30:.2f} GiB on {gpu}")
    b = max(GEN_BATCHES)
    cos = float(F.cosine_similarity(first["W8A8", b], first["bf16", b],
                                    dim=-1).min())
    print(f"[generate] W8A8 against bf16 at b{b}: the first token's logits "
          f"least row cosine {cos:.6f} (a reading: random weights, no "
          f"limit)")

    # the W8A8 twin with static scales: each row quantised alone, so its
    # decode steps and its full forward compute one function
    ids, px = gen_prompts(b, cfg.llama.vocab_size, GEN_SEED), pixels[:b]
    with static_scales(qmodel, lambda: teacher_forced(
            qmodel, ids, px, decoded["W8A8", b])):
        label = f"W8A8 static b{b}, {GEN_NEW_TOKENS} new tokens"
        tokens = counted(counters, label, lambda: llava_greedy_generate(
            qmodel, ids, px, GEN_NEW_TOKENS), {
                "flash_attention": tb + layers,
                "int8_linear": int8_per_pass * GEN_NEW_TOKENS},
            tag="generate")
        logits = teacher_forced(qmodel, ids, px, tokens)
        held, total, worst = forced_agreement(label, tokens, logits,
                                              GEN_STATIC_MARGIN)
    print(f"[generate] {label}: {held} of {total} steps clear the margin "
          f"{GEN_STATIC_MARGIN} and equal the teacher-forced argmax (the "
          f"largest margin of a differing step {worst:.4f}) on {gpu}")

    # bf16 against plain fp32 on the trunk cut to GEN_CUT_LAYERS layers
    cut = cut_config(cfg, GEN_CUT_LAYERS)
    mcut = model_view(model, cut)
    ref = v2v_cast(mcut, torch.float32)
    ids, px = gen_prompts(b, cfg.llama.vocab_size, GEN_SEED), pixels[:b]
    runs = {}
    for name, m, ctx in (("fp32", ref, contextlib.nullcontext()),
                         ("bf16", mcut, contextlib.nullcontext()),
                         ("witness", mcut, plain_attention())):
        with ctx:
            toks = llava_greedy_generate(
                m, ids, px.to(next(m.parameters()).dtype), GEN_NEW_TOKENS)
            runs[name] = (toks, teacher_forced(
                m, ids, px.to(next(m.parameters()).dtype), toks))
    ref_toks, ref_logits = runs["fp32"]
    stop = first_low_margin(ref_logits, GEN_FP32_MARGIN)
    for name in ("bf16", "witness"):
        toks, logits = runs[name]
        c = float(F.cosine_similarity(logits[:, 0], ref_logits[:, 0],
                                      dim=-1).min())
        equal = (toks == ref_toks).cumprod(dim=1).sum(dim=1)
        at = equal.clamp_max(toks.shape[1] - 1)[:, None]
        split = margins(ref_logits).gather(1, at)[:, 0]
        split = float(split[equal < toks.shape[1]].max()) if (
            equal < toks.shape[1]).any() else 0.0
        print(f"[generate] {name} on the {GEN_CUT_LAYERS}-layer cut against "
              f"plain fp32 at b{b}: first token's logits least row cosine "
              f"{c:.6f} (limit {GEN_FP32_COS}), equal prefix "
              f"{equal.tolist()} tokens, fp32's first step under margin "
              f"{GEN_FP32_MARGIN} {stop.tolist()}, fp32's margin where they "
              f"part {split:.4f}")
        if name == "bf16" and (c < GEN_FP32_COS or (equal < stop).any()):
            raise AssertionError(f"bf16 generation disagrees with plain "
                                 f"fp32: cosine {c}, {equal} < {stop}")
    del mcut, ref, runs


def coca_well_formed(label, toks, vocab, forced_eos):
    """SOT first, pads after the first eos, ids in range; with
    ``forced_eos`` every row ends in an eos by the last slot."""
    ok = bool((toks[:, 0] == SOT).all()
              and ((toks >= 0) & (toks < vocab)).all())
    for row in toks.tolist():
        stop = row.index(EOT) if EOT in row else None
        if stop is None:
            ok &= not forced_eos
        else:
            ok &= all(t == 0 for t in row[stop + 1:])
    if not ok:
        raise AssertionError(f"{label}: malformed tokens {toks.tolist()}")


def gen_coca(counters, gpu):
    """Phase 16 (b) and (c): CoCa ViT-L/14 serving, captioning and
    training."""
    from clip_embeds_tpu_torch.cli.train import _to_device
    from clip_embeds_tpu_torch.cli.train import main as train_main
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.data.synthetic import synthetic_batches
    from clip_embeds_tpu_torch.losses.coca import coca_loss
    from clip_embeds_tpu_torch.models.generate import (
        coca_beam_generate, coca_sample_generate, min_length_process)
    from clip_embeds_tpu_torch.train import steps as train_steps
    from clip_embeds_tpu_torch.train.optim import adamw
    from clip_embeds_tpu_torch.train.schedules import const_lr

    t0 = time.perf_counter()
    ref = create_model(COCA_MODEL, seed=COCA_SEED, dtype=torch.float32,
                       device="cuda")
    model = cast_copy(ref, torch.bfloat16)
    cfg = model.cfg
    v, t, mm = cfg.vision, cfg.text, cfg.multimodal
    print(f"[coca] {COCA_MODEL}: tower {v.layers}x{v.width} at "
          f"{v.image_size}/{v.patch_size} ({v.num_patches + 1} rows), text "
          f"{t.layers}x{t.width}, decoder {mm.layers}x{mm.width}, vocab "
          f"{t.vocab_size}; {sum(p.numel() for p in ref.parameters()) / 1e6:.1f}"
          f" M parameters, fp32 and bf16 built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = _to_device(next(synthetic_batches(
        COCA_TEXTS, v.image_size, t.context_length, seed=COCA_SEED)),
        torch.device("cuda"))
    images, texts = batch["images"][:COCA_IMAGES], batch["texts"]

    # (b) serving
    with torch.inference_mode():
        img = counted(counters, f"encode_image b{COCA_IMAGES}",
                      lambda: model.encode_image(images.bfloat16()),
                      {"flash_attention": v.layers}, tag="coca")
        txt = counted(counters, f"encode_text b{COCA_TEXTS}",
                      lambda: model.encode_text(texts), {}, tag="coca")
        img_ref, txt_ref = ref.encode_image(images), ref.encode_text(texts)
        rates = {name: n / cuda_ms(fn, iters=5, warmup=1) * 1e3
                 for name, n, fn in (
                     ("images", COCA_IMAGES,
                      lambda: model.encode_image(images.bfloat16())),
                     ("texts", COCA_TEXTS, lambda: model.encode_text(texts)))}
    cos = {}
    for name, got, want in (("image", img, img_ref), ("text", txt, txt_ref)):
        norms = got.float().norm(dim=-1)
        if not (torch.isfinite(got).all()
                and (norms - 1).abs().max() < 2e-2):
            raise AssertionError(f"coca {name} embeddings: norms {norms}")
        cos[name] = float(F.cosine_similarity(got.float(), want,
                                              dim=-1).min())
    print(f"[coca] bf16 against plain fp32, least row cosine (limit "
          f"{COCA_COS}): {cos}; {rates['images']:.1f} images/s, "
          f"{rates['texts']:.1f} texts/s on {gpu}")
    if min(cos.values()) < COCA_COS:
        raise AssertionError(f"coca embeddings disagree: {cos}")
    del img_ref, txt_ref

    # (b) captioning
    x8 = images[:COCA_GEN_BATCH].bfloat16()
    gen_kw = dict(seq_len=COCA_SEQ_LEN, min_seq_len=COCA_MIN_LEN)
    gen = torch.Generator(device=x8.device)
    calls = {
        "top-k 1": lambda: coca_sample_generate(
            model, x8, gen, generation_type="top_k", top_k=1, **gen_kw),
        f"top-p {COCA_TOP_P}": lambda: coca_sample_generate(
            model, x8, gen.manual_seed(COCA_SEED), top_p=COCA_TOP_P,
            **gen_kw),
        f"beam {COCA_BEAMS}": lambda: coca_beam_generate(
            model, x8, num_beams=COCA_BEAMS, **gen_kw),
    }
    out = {}
    for name, fn in calls.items():
        toks = counted(counters, f"{name} b{COCA_GEN_BATCH}", fn,
                       {"flash_attention": v.layers}, tag="coca")
        coca_well_formed(name, toks, t.vocab_size, not name.startswith("b"))
        out[name] = toks
        times = event_times(fn, GEN_TIME_ITERS)
        ms = float(np.median(times))
        print(f"[coca] {name}: {COCA_GEN_BATCH / ms * 1e3:.2f} captions/s "
              f"({ms:.1f} ms a call of {COCA_GEN_BATCH}, the median of "
              f"{len(times)} after the counted one); lengths "
              f"{[(r.index(EOT) + 1) if EOT in r else COCA_SEQ_LEN for r in toks.tolist()]}"
              f" on {gpu}")
    toks = out["top-k 1"]
    with torch.inference_mode():
        logits = model.caption_logits(model.image_tokens(x8)[1],
                                      toks)[:, :-1].float()
        for step in range(logits.shape[1]):
            logits[:, step] = min_length_process(logits[:, step], step + 1,
                                                 COCA_MIN_LEN, EOT)
    slots = torch.arange(COCA_SEQ_LEN, device=toks.device)
    stop = torch.where(toks == EOT, slots, COCA_SEQ_LEN).amin(dim=1,
                                                            keepdim=True)
    slot = slots[None, 1:]
    valid = (slot <= stop) & (slot < COCA_SEQ_LEN - 1)
    held, total, worst = forced_agreement("coca top-k 1", toks[:, 1:],
                                          logits, COCA_MARGIN, valid)
    print(f"[coca] top-k 1: {held} of {total} sampled slots clear the "
          f"margin {COCA_MARGIN} and equal the teacher-forced argmax (the "
          f"largest margin of a differing slot {worst:.4f})")
    del model, out, logits, calls

    # (c) training through the CLI
    steps_seen = []
    real_step = train_steps.make_coca_train_step

    def recording(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, b):
            metrics = step(state, b)
            steps_seen.append({k: float(x) for k, x in metrics.items()})
            return metrics
        return run

    gc.collect()
    torch.cuda.empty_cache()
    logging.getLogger().setLevel(logging.INFO)
    for fn in counters.values():
        fn.launches = 0
    with patched(train_steps, "make_coca_train_step", recording):
        t0 = time.perf_counter()
        state = train_main([
            "--model", COCA_MODEL, "--seed", str(COCA_SEED),
            "--batch-size", str(TRAIN_BATCH), "--train-num-samples",
            str(TRAIN_STEPS * TRAIN_BATCH), "--lr", "1e-5", "--warmup", "1",
            "--log-every", "1", "--coca-caption-loss-weight", "2.0",
            "--coca-contrastive-loss-weight", "1.0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {k: 0 for k in counters}
    want.update(flash_attention=TRAIN_STEPS * v.layers,
                flash_attention_bwd=TRAIN_STEPS * v.layers)
    before = ref.state_dict()
    after = state.model.state_dict()
    moved = sum(not torch.equal(after[k], x) for k, x in before.items())
    losses = [(s["contrastive_loss"], s["caption_loss"]) for s in steps_seen]
    print(f"[coca] cli.train.main {TRAIN_STEPS} steps of {TRAIN_BATCH} in "
          f"{wall:.1f} s: (contrastive, caption) losses {losses}; launches "
          f"{counts}; {moved} of {len(before)} parameter tensors moved")
    if counts != want:
        raise AssertionError(f"coca training: launches {counts} != {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"coca training: losses {losses}")
    if moved != len(before):
        raise AssertionError(f"coca training: {moved} of {len(before)} "
                             f"tensors moved")
    del state, after

    # (c) throughput by CUDA events, and the b8 gradients
    def coca_grads(m, b):
        m.zero_grad(set_to_none=True)
        coca_loss(m(b["images"], b["texts"]))["loss"].backward()
        grads = {k: p.grad.float() for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return grads

    gc.collect()
    torch.cuda.empty_cache()
    route = create_model(COCA_MODEL, seed=COCA_SEED, dtype=torch.float32,
                         device="cuda", compute_dtype=torch.bfloat16,
                         train=True)
    step = real_step(route)
    state = train_steps.TrainState(route, adamw(route, 1e-5),
                                   const_lr(1e-5))
    tb = {k: x[:TRAIN_BATCH] for k, x in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    step(state, tb)
    ms = float(np.mean(event_times(lambda: step(state, tb), 3)))
    print(f"[throughput] coca train_samples_per_s b{TRAIN_BATCH}: "
          f"{TRAIN_BATCH / ms * 1e3:.1f} ({ms:.2f} ms/step, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) on {gpu}")
    del state, step
    route.load_state_dict(before)
    b8 = {k: x[:GRAD_BATCH] for k, x in batch.items()}
    ref.train()
    want = coca_grads(ref, b8)
    with plain_attention():
        witness = coca_grads(route, b8)
    wcos, wworst, wname = grad_agreement(witness, want)
    grads = coca_grads(route, b8)
    cos, worst, name = grad_agreement(grads, want)
    cos_min = max(GRAD_COS_MIN, wcos - GRAD_COS_BELOW_WITNESS)
    print(f"[coca] b{GRAD_BATCH} gradients against plain fp32: cosine "
          f"{cos:.6f} (limit {cos_min:.6f}), least per tensor {worst:.6f} "
          f"({name}; limit {GRAD_TENSOR_COS_MIN}); the witness {wcos:.6f}, "
          f"{wworst:.6f} ({wname})")
    if not (cos >= cos_min and worst >= GRAD_TENSOR_COS_MIN):
        raise AssertionError("coca training: gradients disagree")
    del ref, route, grads, witness, want


# -- phase 17: the open_clip tower zoo -------------------------------------


def zoo_clip(name, seed, **kw):
    """The fp32 CLIP of registry name ``name`` (``kw``: CLIP's training
    options), allocated on the card and drawn there from a CUDA generator
    (``init_params``): no host copy."""
    from clip_embeds_tpu_torch.core.config import get_model_config
    from clip_embeds_tpu_torch.core.factory import init_params

    model = card_empty_clip(get_model_config(name), **kw)
    init_params(model, seed, torch.Generator("cuda").manual_seed(seed))
    return model.eval()


def zoo_seeded(model, seed):
    """A CustomTextCLIP or LLM2CLIP built on the meta device, allocated on
    the card and drawn there (``init_custom_text_clip``)."""
    from clip_embeds_tpu_torch.models.custom_text_clip import (
        init_custom_text_clip)

    model.to_empty(device="cuda")
    return init_custom_text_clip(
        model, torch.Generator("cuda").manual_seed(seed)).eval()


def zoo_bf16(ref):
    """A bf16 copy of the fp32 model ``ref`` (the same weights)."""
    import copy

    return copy.deepcopy(ref).to(torch.bfloat16)


def zoo_pixels(size, seed, n=ZOO_BATCH):
    rng = np.random.default_rng([ZOO_SEED, seed])
    return torch.from_numpy(rng.standard_normal((n, size, size, 3)).astype(
        np.float32)).cuda()


def zoo_agree(label, got, want, limit=ZOO_COS):
    """Finite rows of the same shape whose least row cosine reaches
    ``limit``; returns it."""
    got, want = (t.float().cpu().numpy() for t in (got, want))
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: shape {got.shape} against "
                             f"{want.shape}, finite {np.isfinite(got).all()}")
    cos = float(row_cos(got, want).min())
    if cos < limit:
        raise AssertionError(f"{label}: least row cosine {cos:.5f} < {limit}")
    return cos


def zoo_eva_cli(counters, gpu, tmp):
    """Phase 17 (a): EVA01-g-14 at full width and depth through
    cli/embed.py main, bf16 and --fp32 (the plain path: fp32 attention is
    never the kernel), the CLI's create_model handed the two models built
    once on the card."""
    from clip_embeds_tpu_torch.cli import embed as embed_cli

    t0 = time.perf_counter()
    ref = zoo_clip("EVA01-g-14", ZOO_SEED)
    model = zoo_bf16(ref)
    cfg = model.cfg
    print(f"[zoo] EVA01-g-14: vision {cfg.vision.layers} x "
          f"{cfg.vision.width}, {cfg.vision.heads} heads of "
          f"{cfg.vision.head_width}, {cfg.vision.num_patches + 1} rows; "
          f"{sum(p.numel() for p in ref.parameters()) / 1e9:.3f} B "
          f"parameters, built on the card in {time.perf_counter() - t0:.1f}"
          " s")

    def create_model(name, pretrained=None, dtype=torch.float32,
                     device="cuda", **kw):
        if (name, pretrained, torch.device(device).type, kw) != (
                "EVA01-g-14", None, "cuda", {}):
            raise AssertionError(f"phase 17 shares no model for {name}")
        return {torch.bfloat16: model, torch.float32: ref}[dtype]

    img_dir = os.path.join(tmp, "eva_images")
    write_photos([os.path.join(img_dir, f"{i:03d}.jpg")
                  for i in range(ZOO_EVA_IMAGES)], ZOO_SEED)
    rng = np.random.default_rng(ZOO_SEED)
    words = ["a", "photo", "of", "the", "cat", "dog", "left", "right",
             "red", "mug", "on", "table", "two", "birds", "under", "tree"]
    captions = os.path.join(tmp, "captions.txt")
    with open(captions, "w") as f:
        for _ in range(ZOO_EVA_TEXTS):
            f.write(" ".join(rng.choice(words, int(rng.integers(3, 20))))
                    + "\n")
    common = ["--model", "EVA01-g-14", "--device", "cuda"]
    runs = {}
    with patched(embed_cli, "create_model", create_model):
        for kind, argv, batch, per_call in (
                ("images", ["--input", img_dir, "--workers",
                            str(os.cpu_count())], ZOO_EVA_BATCH,
                 {"flash_attention": cfg.vision.layers}),
                ("texts", ["--input-texts", captions], ZOO_EVA_TEXT_BATCH,
                 {})):
            calls = (ZOO_EVA_IMAGES if kind == "images"
                     else ZOO_EVA_TEXTS) // batch
            for prec in ("bf16", "fp32"):
                out = os.path.join(tmp, f"eva_{kind}_{prec}.npy")
                want = ({k: v * calls for k, v in per_call.items()}
                        if prec == "bf16" else {})
                ret, line = counted(
                    counters, f"EVA01-g-14 cli/embed.py {kind} {prec}, "
                    f"{calls} call(s) of {batch}",
                    lambda a=argv, o=out, p=prec: run_main(
                        embed_cli.main, common + a + [
                            "--output", o, "--batch-size", str(batch)] + (
                            ["--fp32"] if p == "fp32" else [])), want,
                    tag="zoo")
                if ret != 0:
                    raise AssertionError(f"cli/embed.py {kind}: rc {ret}")
                runs[kind, prec] = (np.load(out), line)
    for kind in ("images", "texts"):
        (bf, line), (fp, line32) = runs[kind, "bf16"], runs[kind, "fp32"]
        cos = zoo_agree(f"EVA01-g-14 {kind} bf16 vs fp32",
                        torch.from_numpy(bf), torch.from_numpy(fp))
        rate = line[f"{kind}_per_sec"]
        print(f"[zoo] EVA01-g-14 {kind}: row cosine bf16 vs plain fp32 "
              f"{cos:.5f} (limit {ZOO_COS}); end to end {rate} {kind}/s "
              f"bf16, {line32[f'{kind}_per_sec']} fp32 (route "
              f"{line['route']}) on {gpu}")
    with torch.inference_mode():
        px = zoo_pixels(cfg.vision.image_size, 0, ZOO_EVA_BATCH).to(
            torch.bfloat16)
        ms = cuda_ms(lambda: model.encode_image(px, normalize=True),
                     iters=ZOO_TIME_ITERS, warmup=1)
        ids = torch.from_numpy(np.stack([
            np.pad([SOT] + list(rng.integers(1, SOT, 12)) + [EOT],
                   (0, cfg.text.context_length - 14))
            for _ in range(ZOO_EVA_TEXT_BATCH)])).cuda()
        ms_t = cuda_ms(lambda: model.encode_text(ids, normalize=True),
                       iters=ZOO_TIME_ITERS, warmup=1)
    print(f"[zoo] EVA01-g-14 on the card: {ZOO_EVA_BATCH / ms * 1e3:.1f} "
          f"img/s (b{ZOO_EVA_BATCH}, {ms:.2f} ms), "
          f"{ZOO_EVA_TEXT_BATCH / ms_t * 1e3:.1f} texts/s "
          f"(b{ZOO_EVA_TEXT_BATCH}, {ms_t:.2f} ms) on {gpu}")


def zoo_image_family(name, counters, gpu, idx):
    """Phase 17 (b): one registry CLIP of a zoo tower family at b8, bf16
    against the plain fp32 path; its tower launches no kernel."""
    t0 = time.perf_counter()
    ref = zoo_clip(name, ZOO_SEED + idx)
    model = zoo_bf16(ref)
    v = model.cfg.vision
    built = time.perf_counter() - t0
    px = zoo_pixels(v.image_size, idx)
    with torch.inference_mode():
        got = counted(counters, f"{name} ({v.tower}) bf16 b{ZOO_BATCH}",
                      lambda: model.encode_image(px.to(torch.bfloat16),
                                                 normalize=True), {},
                      tag="zoo")
        want = ref.encode_image(px, normalize=True)
        cos = zoo_agree(f"{name} bf16 vs fp32", got, want)
        ms = cuda_ms(lambda: model.encode_image(px.to(torch.bfloat16)),
                     iters=ZOO_TIME_ITERS, warmup=1)
    n = sum(p.numel() for p in model.visual.parameters())
    print(f"[zoo] {name}: {v.tower} tower, {n / 1e6:.1f} M parameters at "
          f"{v.image_size} px; row cosine bf16 vs plain fp32 {cos:.5f}; "
          f"{ZOO_BATCH / ms * 1e3:.1f} img/s (b{ZOO_BATCH}, {ms:.2f} ms), "
          f"built in {built:.1f} s on {gpu}")


def zoo_vit_h_378(counters, gpu):
    """Phase 17 (b): ViT-H-14-378 on the fused bf16 routes (images through
    fused_encode_image, texts through the CLI's fused text route) and
    --int8 (fused_block_int8, int8 weights from the fp32 ones), against
    the plain fp32 path and int8 against bf16."""
    from clip_embeds_tpu_torch.cli.embed import (
        embed_image_batches, embed_text_batches, image_route, text_route)
    from clip_embeds_tpu_torch.models.serving import fused_encode_image

    t0 = time.perf_counter()
    ref = zoo_clip("ViT-H-14-378", ZOO_SEED)
    model = zoo_bf16(ref)
    cfg, bf16 = model.cfg, torch.bfloat16
    if not (text_route(model) == "fused"
            and image_route(ref, True, bf16) == "fused_int8"):
        raise AssertionError("ViT-H-14-378 would not take the fused routes")
    built = time.perf_counter() - t0
    px = zoo_pixels(cfg.vision.image_size, 20)
    images, texts = synthetic_requests(np.random.default_rng(ZOO_SEED),
                                       cfg)
    ids = torch.from_numpy(texts[0]).cuda()
    lv, lt = cfg.vision.layers - 1, cfg.text.layers  # CLS-only last block
    with torch.inference_mode():
        img = counted(counters,
                      f"ViT-H-14-378 fused_encode_image b{ZOO_BATCH}",
                      lambda: fused_encode_image(model, px.to(bf16)),
                      {"fused_block": lv}, tag="zoo")
        txt = torch.from_numpy(counted(
            counters, f"ViT-H-14-378 fused texts b{ZOO_BATCH}",
            lambda: embed_text_batches(model, [texts[0]], ZOO_BATCH),
            {"fused_block": lt}, tag="zoo"))
        img32 = ref.encode_image(px, normalize=True)
        txt32 = ref.encode_text(ids.long(), normalize=True)
        cos = {"image": zoo_agree("ViT-H-14-378 image bf16 vs fp32", img,
                                  img32),
               "text": zoo_agree("ViT-H-14-378 text bf16 vs fp32", txt,
                                 txt32.cpu())}
        for c in counters.values():
            c.launches = 0
        img8 = torch.from_numpy(embed_image_batches(
            ref, [px.cpu().numpy()], ZOO_BATCH, int8=True, dtype=bf16))
        n8 = counters["fused_block_int8"].launches
        if n8 != lv:
            raise AssertionError(f"ViT-H-14-378 int8: fused_block_int8 "
                                 f"launches {n8} != {lv}")
        cos["int8_image_vs_bf16"] = zoo_agree(
            "ViT-H-14-378 int8 vs bf16", img8, img.cpu())
        ms = cuda_ms(lambda: fused_encode_image(model, px.to(bf16)),
                     iters=ZOO_TIME_ITERS, warmup=1)
        ms_c = cuda_ms(lambda: model.encode_image(px.to(bf16)),
                       iters=ZOO_TIME_ITERS, warmup=1)
    print(f"[zoo] ViT-H-14-378: {cfg.vision.layers} x {cfg.vision.width}, "
          f"{cfg.vision.num_patches + 1} rows; least row cosines {cos} "
          f"(limit {ZOO_COS}); fused_block_int8 {n8} a call; fused bf16 "
          f"{ZOO_BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms), composable "
          f"{ZOO_BATCH / ms_c * 1e3:.1f} img/s ({ms_c:.2f} ms) at "
          f"b{ZOO_BATCH}; built in {built:.1f} s on {gpu}")


def zoo_hf_text(name, counters, gpu, idx):
    """Phase 17 (b): an hf-text CLIP (a ViT-H-14 or SigLIP SO400M tower,
    an XLM-R / mT5 / NLLB text tower) at b8: its images through #4, its
    masked texts plain, bf16 against the plain fp32 path."""
    from clip_embeds_tpu_torch.models.custom_text_clip import (
        build_custom_text_clip)

    t0 = time.perf_counter()
    with torch.device("meta"):
        ref = build_custom_text_clip(name)
    ref = zoo_seeded(ref, ZOO_SEED + idx)
    model = zoo_bf16(ref)
    cfg = model.cfg
    built = time.perf_counter() - t0
    if cfg.siglip_vision is not None:
        size, layers = cfg.siglip_vision.image_size, cfg.siglip_vision.layers
    else:
        size, layers = cfg.vision.image_size, cfg.vision.layers
    px = zoo_pixels(size, idx)
    rng = np.random.default_rng([ZOO_SEED, idx])
    ids = rng.integers(2, model.text.cfg.vocab_size,
                       (ZOO_BATCH, ZOO_TEXT_LEN))
    mask = np.ones_like(ids)
    for i, n in enumerate(rng.integers(4, ZOO_TEXT_LEN + 1, ZOO_BATCH)):
        mask[i, n:] = 0
        ids[i, n:] = 1
    ids, mask = (torch.from_numpy(a).cuda() for a in (ids, mask))
    with torch.inference_mode():
        img = counted(counters, f"{name} images bf16 b{ZOO_BATCH}",
                      lambda: model.encode_image(px.to(torch.bfloat16),
                                                 normalize=True),
                      {"flash_attention": layers}, tag="zoo")
        txt = counted(counters, f"{name} texts bf16 b{ZOO_BATCH}",
                      lambda: model.encode_text(ids, mask, normalize=True),
                      {}, tag="zoo")
        cos = {"image": zoo_agree(f"{name} image bf16 vs fp32", img,
                                  ref.encode_image(px, normalize=True)),
               "text": zoo_agree(f"{name} text bf16 vs fp32", txt,
                                 ref.encode_text(ids, mask,
                                                 normalize=True))}
        ms = cuda_ms(lambda: model.encode_image(px.to(torch.bfloat16)),
                     iters=ZOO_TIME_ITERS, warmup=1)
        ms_t = cuda_ms(lambda: model.encode_text(ids, mask),
                       iters=ZOO_TIME_ITERS, warmup=1)
    print(f"[zoo] {name}: {cfg.hf_model_name} text, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          f"parameters; least row cosines {cos} (limit {ZOO_COS}); "
          f"{ZOO_BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms), "
          f"{ZOO_BATCH / ms_t * 1e3:.1f} texts/s ({ms_t:.2f} ms) at "
          f"b{ZOO_BATCH}; built in {built:.1f} s on {gpu}")


def zoo_llm2clip(counters, gpu):
    """Phase 17 (b): LLM2CLIP (ViT-L/14-336 through #4, the adapter on
    LLM2Vec embeddings) at b8, bf16 against the plain fp32 path."""
    from clip_embeds_tpu_torch.models.llm2clip import LLM2CLIP

    t0 = time.perf_counter()
    with torch.device("meta"):
        ref = LLM2CLIP()
    ref = zoo_seeded(ref, ZOO_SEED + 40)
    model = zoo_bf16(ref)
    cfg = model.cfg
    built = time.perf_counter() - t0
    px = zoo_pixels(cfg.vision.image_size, 40)
    emb = torch.from_numpy(np.random.default_rng(ZOO_SEED).standard_normal(
        (ZOO_BATCH, cfg.text_embedding_dim)).astype(np.float32)).cuda()
    with torch.inference_mode():
        img = counted(counters, f"LLM2CLIP images bf16 b{ZOO_BATCH}",
                      lambda: model.get_image_features(
                          px.to(torch.bfloat16), normalize=True),
                      {"flash_attention": cfg.vision.layers}, tag="zoo")
        txt = model.get_text_features(emb, normalize=True)
        cos = {"image": zoo_agree("LLM2CLIP image bf16 vs fp32", img,
                                  ref.get_image_features(px,
                                                         normalize=True)),
               "text": zoo_agree("LLM2CLIP text bf16 vs fp32", txt,
                                 ref.get_text_features(emb,
                                                       normalize=True))}
        ms = cuda_ms(lambda: model.get_image_features(px.to(torch.bfloat16)),
                     iters=ZOO_TIME_ITERS, warmup=1)
    print(f"[zoo] LLM2CLIP: least row cosines {cos} (limit {ZOO_COS}); "
          f"{ZOO_BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms) at b{ZOO_BATCH};"
          f" built in {built:.1f} s on {gpu}")


def check_zoo(counters, gpu):
    """Phase 17: (a) EVA01-g-14 through cli/embed.py; (b) one model of
    every other zoo family, the hf-text CLIPs and LLM2CLIP, one at a
    time; each phase part's seconds."""
    def part(label, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[phase 17] {label}: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        part("(a) EVA01-g-14", zoo_eva_cli, counters, gpu, tmp)
    part("(b) ViT-H-14-378", zoo_vit_h_378, counters, gpu)
    for idx, name in enumerate(ZOO_CLIPS):
        part(f"(b) {name}", zoo_image_family, name, counters, gpu, idx + 1)
    for idx, name in enumerate(ZOO_HF_TEXT):
        part(f"(b) {name}", zoo_hf_text, name, counters, gpu, idx + 30)
    part("(b) LLM2CLIP", zoo_llm2clip, counters, gpu)


# -- phase 18: training on the zoo towers; the last entry points -----------


def z18_create_model(name, pretrained=None, seed=0, dtype=torch.float32,
                     device="cuda", remat=False, block_impl="composable",
                     compute_dtype=None, force_quick_gelu=False,
                     force_patch_dropout=None, train=False):
    """The entry points' ``create_model`` in phase 18: the seeded model
    built and drawn on the card (:func:`zoo_clip`), not on the host."""
    if pretrained is not None or force_quick_gelu or \
            force_patch_dropout is not None:
        raise AssertionError(f"phase 18 builds no {name} from {pretrained}")
    model = zoo_clip(name, seed, remat=remat, block_impl=block_impl,
                     compute_dtype=compute_dtype)
    return model.to(device=device, dtype=dtype).train(train)


def z18_batch(name, batch_size, seed):
    """One synthetic batch (the CLI's data) of ``name``'s sizes, on the
    card."""
    from clip_embeds_tpu_torch.cli.train import _to_device
    from clip_embeds_tpu_torch.core.config import get_model_config
    from clip_embeds_tpu_torch.data.synthetic import synthetic_batches

    cfg = get_model_config(name)
    batch = next(synthetic_batches(batch_size, cfg.vision.image_size,
                                   cfg.text.context_length, seed=seed))
    return _to_device(batch, torch.device("cuda"))


def z18_train(counters, label, name, flags, steps, batch, per_step):
    """cli/train.py main on ``name``, seeded on the card, ``steps`` steps
    at ``batch``: exact launches (``per_step`` a step), finite losses.
    Returns (the train state, the losses)."""
    from clip_embeds_tpu_torch.cli.train import main as train_main
    from clip_embeds_tpu_torch.core import factory

    log = _StepLog()
    logging.getLogger().addHandler(log)
    for fn in counters.values():
        fn.launches = 0
    try:
        t0 = time.perf_counter()
        with patched(factory, "create_model", z18_create_model):
            state = train_main([
                "--model", name, "--seed", str(Z18_SEED), "--batch-size",
                str(batch), "--train-num-samples", str(steps * batch),
                "--lr", "1e-5", "--warmup", "1", "--log-every", "1",
                *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        logging.getLogger().removeHandler(log)
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {k: steps * per_step.get(k, 0) for k in counters}
    print(f"[zoo train] {label}: {steps} step(s) of {batch} through "
          f"cli.train.main in {wall:.1f} s; losses {log.losses}; launches "
          f"{counts}")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    if len(log.losses) != steps or not np.isfinite(log.losses).all():
        raise AssertionError(f"{label}: losses {log.losses}")
    return state, log.losses


def z18_step_rate(state, name, gpu, label):
    """samples/s of the state's step at Z18_BATCH by CUDA events over 3
    steps after 1, with the peak of device memory."""
    from clip_embeds_tpu_torch.train.steps import make_clip_train_step

    step = make_clip_train_step(state.model)
    tb = z18_batch(name, Z18_BATCH, seed=2)
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
        raise AssertionError(f"{label}: loss not finite")
    print(f"[throughput] train_samples_per_s {name} {label} b{Z18_BATCH}: "
          f"{Z18_BATCH / ms * 1e3:.1f} ({ms:.2f} ms/step, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) on {gpu}")


def z18_block_grads(model, gpu):
    """One step's gradients at Z18_GRAD_BATCH on the flash route against
    the same step with every attention plain: the least cosine over the
    tower's blocks, each block's parameters together."""
    batch = z18_batch(Z18_MODEL, Z18_GRAD_BATCH, seed=1)
    grads, loss = train_grads(model, batch)
    with plain_attention():
        ref, ref_loss = train_grads(model, batch)
    cos_all, worst, worst_name = grad_agreement(grads, ref)
    blocks = {}
    for k in ref:
        if k.startswith("visual.trunk.blocks.resblocks."):
            i = int(k.split(".")[4])
            blocks.setdefault(i, []).append(k)
    per = {i: float(F.cosine_similarity(
        torch.cat([grads[k].flatten() for k in keys]),
        torch.cat([ref[k].flatten() for k in keys]), dim=0))
        for i, keys in blocks.items()}
    low = min(per, key=per.get)
    print(f"[zoo train] {Z18_MODEL} gradients at b{Z18_GRAD_BATCH}, flash "
          f"route vs plain attention: {len(per)} tower blocks, least block "
          f"cosine {per[low]:.6f} (block {low}; limit {Z18_GRAD_COS}); over "
          f"all {cos_all:.6f}, least per tensor {worst:.6f} ({worst_name}); "
          f"loss {loss:.6f} vs {ref_loss:.6f} on {gpu}")
    if len(per) != 40 or per[low] < Z18_GRAD_COS:
        raise AssertionError(f"{Z18_MODEL}: block gradients disagree: {per}")


def z18_eva_routes(counters, gpu):
    """Phase 18 (a) and (b): EVA01-g-14 through cli/train.py on both
    routes."""
    first = {}
    for route, (flags, per_step) in Z18_ROUTES.items():
        gc.collect()
        torch.cuda.empty_cache()
        state, losses = z18_train(counters, f"{Z18_MODEL} {route}",
                                  Z18_MODEL, flags, Z18_STEPS, Z18_BATCH,
                                  per_step)
        first[route] = losses[0]
        z18_step_rate(state, Z18_MODEL, gpu, route)
        if route == "composable":
            z18_block_grads(state.model, gpu)
        del state
    gap = abs(first["composable"] - first["fused-train-res"])
    print(f"[zoo train] {Z18_MODEL} first losses: {first} (|diff| "
          f"{gap:.5f}, limit {Z18_LOSS_TOL})")
    if gap > Z18_LOSS_TOL:
        raise AssertionError(f"{Z18_MODEL}: the routes' losses {first}")


def z18_families(counters, gpu):
    """Phase 18 (c): one step of each other zoo family at
    Z18_FAMILY_BATCH, EVA02-E-14 locked, and EVA02-E-14 unlocked out of
    memory."""
    for name in Z18_FAMILIES + ("EVA02-E-14",):
        flags = ["--lock-image"] if name == "EVA02-E-14" else []
        t0 = time.perf_counter()
        state, _ = z18_train(counters, f"{name}{' ' if flags else ''}"
                             f"{' '.join(flags)}", name, flags, 1,
                             Z18_FAMILY_BATCH, {})
        trained = sum(p.numel() for p in state.model.parameters()
                      if p.requires_grad)
        print(f"[zoo train] {name}: {trained / 1e6:.1f} M parameters "
              f"trained, {time.perf_counter() - t0:.1f} s on {gpu}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
    try:
        z18_train(counters, "EVA02-E-14 unlocked", "EVA02-E-14", [], 1,
                  Z18_BATCH, {})
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0][:120]
    else:
        raise AssertionError("EVA02-E-14 unlocked trained at "
                             f"b{Z18_BATCH} on one card")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[zoo train] EVA02-E-14 unlocked at b{Z18_BATCH}: "
          f"torch.cuda.OutOfMemoryError ({oom}...) on {gpu}")


def z18_profile(gpu, tmp):
    """Phase 18 (d): cli/profile.py on EVA01-g-14 and ViT-L-14-336, with
    traces on the card."""
    from clip_embeds_tpu_torch.cli import profile as profile_cli
    from clip_embeds_tpu_torch.core import factory

    csv_path = os.path.join(tmp, "profile.csv")
    trace = os.path.join(tmp, "trace")
    with patched(factory, "create_model", z18_create_model):
        rows = profile_cli.main(["--model", Z18_MODEL, MODEL,
                                 "--results-file", csv_path, "--trace",
                                 trace])
    for row in rows:
        path = os.path.join(trace, row["model"], "trace.json")
        size = os.path.getsize(path)
        print(f"[profile] {row}; trace {size / 2**20:.1f} MiB on {gpu}")
        if not (row["gflops"] > 0 and size > 0):
            raise AssertionError(f"cli/profile.py: {row}, trace {size} B")


def z18_export(gpu, tmp):
    """Phase 18 (e): an EVA01-g-14 bundle written and loaded on the card;
    the reloaded model's embeddings equal the original's."""
    from clip_embeds_tpu_torch.core.export import (
        load_model_bundle, save_model_bundle)

    model = zoo_clip(Z18_MODEL, Z18_SEED)
    folder = os.path.join(tmp, "bundle")
    t0 = time.perf_counter()
    save_model_bundle(folder, model, Z18_MODEL)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_model_bundle(folder)
    t_load = time.perf_counter() - t0
    px = zoo_pixels(model.cfg.vision.image_size, 18, Z18_EXPORT_BATCH)
    with torch.inference_mode():
        a, b = (m.encode_image(px, normalize=True) for m in (model, loaded))
    diff = float((a - b).abs().max())
    size = sum(os.path.getsize(os.path.join(folder, f))
               for f in os.listdir(folder))
    print(f"[export] {Z18_MODEL} bundle ({size / 2**30:.2f} GiB) written in "
          f"{t_save:.1f} s, loaded on the card in {t_load:.1f} s; fp32 "
          f"image embeddings at b{Z18_EXPORT_BATCH} max |diff| {diff:.3g} "
          f"on {gpu}")
    if diff > 1e-5:
        raise AssertionError(f"export: the reloaded embeddings differ by "
                             f"{diff}")


def z18_preprocess(gpu):
    """Phase 18 (f): jax_preprocess of camera-sized photos on the card
    against the same on the CPU, both variants, shrinking and growing."""
    from clip_embeds_tpu_torch.image.preprocess import jax_preprocess

    h, w = Z18_PREPROCESS_PHOTO
    rng = np.random.default_rng(Z18_SEED)
    u8 = torch.from_numpy(np.stack([smooth_photo(rng, w, h)
                                    for _ in range(4)]))
    worst = 0.0
    for variant, size in (("clip", 336), ("pacl", 224), ("clip", 768)):
        got = jax_preprocess(u8.cuda(), size, variant)
        want = jax_preprocess(u8, size, variant)
        if got.device.type != "cuda" or got.shape != (4, size, size, 3):
            raise AssertionError(f"jax_preprocess: {got.device} {got.shape}")
        worst = max(worst, float((got.cpu() - want).abs().max()))
    print(f"[preprocess] jax_preprocess {h}x{w} -> 336 / 224 / 768 on the "
          f"card vs the CPU: max |diff| {worst:.3g} (limit "
          f"{Z18_PREPROCESS_TOL}) on {gpu}")
    if worst > Z18_PREPROCESS_TOL:
        raise AssertionError(f"jax_preprocess: card vs CPU {worst}")


def check_zoo_training(counters, gpu):
    """Phase 18, each part's seconds."""
    def part(label, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[phase 18] {label}: {time.perf_counter() - t0:.1f} s")

    logging.getLogger().setLevel(logging.INFO)
    part("(a), (b) EVA01-g-14", z18_eva_routes, counters, gpu)
    part("(c) the other families", z18_families, counters, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        part("(d) cli/profile.py", z18_profile, gpu, tmp)
        part("(e) export", z18_export, gpu, tmp)
    part("(f) jax_preprocess", z18_preprocess, gpu)


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
        fused_block, fused_block_int8, fused_block_residuals, int8_linear)

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
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        kernel_results = check_kernels(rng)
        # its own inputs: the main path's requests below stay as they were
        check_gemms(np.random.default_rng(1), gpu)
        check_gemms_s8(np.random.default_rng(2), gpu)
        check_int8_linear(gpu)
        check_int8_linear(gpu, T5_INT8_LINEAR_CASES, seed=13)
        check_int8_linear(gpu, QWEN_INT8_LINEAR_CASES, seed=VB_SEED)
        check_int8_linear(gpu, GEN_INT8_LINEAR_CASES, seed=GEN_SEED)
    print(f"[phase 3] {time.perf_counter() - t0:.1f} s on {gpu}")

    # 4. the main path at full width and depth
    t45 = t0 = time.perf_counter()
    model = create_model(MODEL, pretrained="openai", seed=0,
                         dtype=torch.bfloat16, device="cuda")
    # fp32: every attention takes the plain path (the kernel is bf16);
    # --int8 quantises from these fp32 weights, as the CLI does
    ref = create_model(MODEL, pretrained="openai", seed=0,
                       dtype=torch.float32, device="cuda")
    # the seed-0 weights on the host, for phases 6, 12 and 15's builds
    base = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
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
    print(f"[phase 4-5] {time.perf_counter() - t45:.1f} s on {gpu}")

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
    t0 = time.perf_counter()
    with seeded_from(base):
        train_launches, train_rates, base = check_training(counters, gpu,
                                                           base)
    print(f"[phase 6] {time.perf_counter() - t0:.1f} s on {gpu}")
    gc.collect()
    torch.cuda.empty_cache()

    # 12. the source's fine-tune recipe and the real-data loaders, through
    # the training CLI on phase 6's weights; and 15. the rest of the
    # training loop, in phase 12's fixture directory
    t0 = time.perf_counter()
    with recipe_fixtures(base) as (root, phrased):
        check_recipe(counters, base, train_rates, gpu, root, phrased)
        print(f"[phase 12] {time.perf_counter() - t0:.1f} s on {gpu}")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        check_train_loop(counters, base, train_rates, gpu, root)
        print(f"[phase 15] {time.perf_counter() - t0:.1f} s on {gpu}")
    del base
    gc.collect()
    torch.cuda.empty_cache()

    # 10. LLaVA-1.5-7B VQAScore
    t0 = time.perf_counter()
    llava, qllava = check_vqascore(counters, gpu)
    print(f"[phase 10] {time.perf_counter() - t0:.1f} s on {gpu}")

    # 11. VLM2Vec over phase 10's LLaVA-1.5-7B and its W8A8 trunk
    t0 = time.perf_counter()
    check_vlm2vec(llava.to("cuda"), qllava, counters, gpu)
    print(f"[phase 11] {time.perf_counter() - t0:.1f} s on {gpu}")
    gc.collect()
    torch.cuda.empty_cache()

    # 16. (a) generation on the same LLaVA and its W8A8 twin; (b), (c)
    # CoCa, on a card without them
    t0 = time.perf_counter()
    gen_llava(llava, qllava, dict(counters, int8_linear=int8_linear), gpu)
    t16 = time.perf_counter() - t0
    print(f"[phase 16] (a) {t16:.1f} s on {gpu}")
    del llava, qllava
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen_coca(counters, gpu)
    t16b = time.perf_counter() - t0
    print(f"[phase 16] (b) and (c) {t16b:.1f} s; phase 16 {t16 + t16b:.1f}"
          f" s on {gpu}")
    gc.collect()
    torch.cuda.empty_cache()

    # 13. the T5 and BLIP score families
    t0 = time.perf_counter()
    check_t5_family(counters, gpu)
    print(f"[phase 13] {time.perf_counter() - t0:.1f} s on {gpu}")
    gc.collect()
    torch.cuda.empty_cache()

    # 14. VLM2Vec's other backbones
    t0 = time.perf_counter()
    check_vlm_backbones(counters, gpu)
    print(f"[phase 14] {time.perf_counter() - t0:.1f} s on {gpu}")
    gc.collect()
    torch.cuda.empty_cache()

    # 17. the open_clip tower zoo
    t0 = time.perf_counter()
    check_zoo(counters, gpu)
    print(f"[phase 17] {time.perf_counter() - t0:.1f} s on {gpu}")
    gc.collect()
    torch.cuda.empty_cache()

    # 18. training on the zoo towers; the last entry points
    t0 = time.perf_counter()
    check_zoo_training(counters, gpu)
    print(f"[phase 18] {time.perf_counter() - t0:.1f} s on {gpu}")

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
