#!/usr/bin/env python3
"""Smoke run of the PyTorch port (clip_embeds_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card's name and power limit; TF32 off for the fp32 references;
  2. build the CUDA kernels from clip_embeds_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version, bf16, at the main
     path's shapes, with the tolerance stated;
  4. the main path: ViT-L/14-336 (OpenAI config, seeded random weights, all
     24 + 12 layers) in bf16 serves 3 image and 3 text requests of 8
     through embed_image_batches / embed_text_batches; the kernels' launch
     counts must rise, and the embeddings must be finite, unit-norm and
     agree with the plain fp32 path on the same card;
  5. timings with CUDA events: img/s per image route, texts/s, and each
     kernel against its plain version.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MODEL = "ViT-L-14-336"
REQUESTS, REQUEST_SIZE = 3, 8
SOT, EOT = 49406, 49407


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


def block_inputs(rng, b, n, d, mlp):
    """fused_block inputs at trained-like scales, bf16 on the card."""
    def t(*shape, std=1.0, mean=0.0):
        a = mean + std * rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to("cuda", torch.bfloat16)

    ln = lambda: torch.stack([t(d, std=0.1, mean=1.0), t(d, std=0.1)])
    return (t(b, n, d), t(3 * d, d, std=d ** -0.5), t(3 * d, std=0.02),
            t(d, d, std=0.02), t(d, std=0.02), t(mlp, d, std=(2 * d) ** -0.5),
            t(mlp, std=0.02), t(d, mlp, std=0.02), t(d, std=0.02), ln(), ln())


def check_kernels(rng):
    """Phase 3: every kernel against its plain version on the same inputs."""
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_reference)

    cases = []
    # (name, kernel call, plain call, tolerance on max |kernel - plain|)
    for b, n, d, heads, kv, causal in ((4, 592, 1024, 16, 577, False),
                                       (8, 80, 768, 12, 77, True)):
        args = block_inputs(rng, b, n, d, 4 * d)
        kw = dict(heads=heads, kv_valid=kv, quick_gelu=True, causal=causal)
        cases.append((f"fused_block {b}x{n}x{d} causal={causal}",
                      lambda a=args, k=kw: fused_block(*a, **k),
                      lambda a=args, k=kw: fused_block_reference(*a, **k),
                      0.125, kv))
    for shape, causal in (((4, 16, 577, 64), False), ((2, 12, 77, 64), True)):
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
        cases.append((f"flash_attention {'x'.join(map(str, shape))} "
                      f"causal={causal}",
                      lambda q=q, k=k, v=v, c=causal: flash_attention(q, k, v, c),
                      lambda q=q, k=k, v=v, c=causal:
                      flash_attention_reference(q, k, v, c),
                      0.02, shape[2]))
    results = {}
    for name, kernel, plain, tol, n_valid in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
        # padded query rows (fused_block) are not part of the contract
        diff = (got.float() - want.float())[..., :n_valid, :].abs()
        err = float(diff.max())
        if not err <= tol:
            raise AssertionError(f"{name}: max|diff| {err} > tol {tol}")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        print(f"[kernel] {name}: max|diff| {err:.6g} (tol {tol}), "
              f"mean|diff| {float(diff.mean()):.3g}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        results[name] = (err, ms, plain_ms)
    return results


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    # the port comes from the checkout this script sits in
    from clip_embeds_tpu_torch.cli.embed import (
        embed_image_batches, embed_text_batches, text_route)
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.models.serving import (
        fused_encode_image, fused_encode_text, fused_path_available)
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.flash_attention import flash_attention
    from clip_embeds_tpu_torch.ops.fused_block import fused_block

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
    with torch.inference_mode():
        kernel_results = check_kernels(rng)

    # 4. the main path at full width and depth
    t0 = time.perf_counter()
    model = create_model(MODEL, pretrained="openai", seed=0,
                         dtype=torch.bfloat16, device="cuda")
    # fp32: every attention takes the plain path (the kernel is bf16)
    ref = create_model(MODEL, pretrained="openai", seed=0,
                       dtype=torch.float32, device="cuda")
    cfg = model.cfg
    print(f"[model] {MODEL} quick_gelu={cfg.quick_gelu} vision "
          f"{cfg.vision.layers}x{cfg.vision.width} heads {cfg.vision.heads} "
          f"text {cfg.text.layers}x{cfg.text.width}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    if not (cfg.quick_gelu and fused_path_available(model)
            and text_route(model) == "fused"):
        raise AssertionError("the main path would not reach the kernels")
    images, texts = synthetic_requests(rng, cfg)

    flash_attention.launches = 0
    fused_block.launches = 0
    img = embed_image_batches(model, images, REQUEST_SIZE)
    txt = embed_text_batches(model, texts, REQUEST_SIZE)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "fused_block": fused_block.launches}
    print(f"[main path] {REQUESTS} image + {REQUESTS} text requests of "
          f"{REQUEST_SIZE}; launches {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")

    n = REQUESTS * REQUEST_SIZE
    for name, emb in (("image", img), ("text", txt)):
        norms = np.linalg.norm(emb, axis=-1)
        if emb.shape != (n, cfg.embed_dim) or not np.isfinite(emb).all() \
                or np.abs(norms - 1).max() > 2e-2:
            raise AssertionError(f"{name} embeddings: shape {emb.shape}, "
                                 f"norms {norms.min()}..{norms.max()}")
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

    # 5. throughput (device name and power limit beside every number)
    with torch.inference_mode():
        bs = 32
        px = torch.from_numpy(rng.standard_normal(
            (bs, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
                np.float32)).cuda()
        ids = torch.from_numpy(np.concatenate(texts * 11)[:256]).long().cuda()
        routes = {
            "images_per_s composable+flash": (
                bs, lambda: model.encode_image(px.bfloat16(), normalize=True)),
            "images_per_s fused_encode_image": (
                bs, lambda: fused_encode_image(model, px)),
            "texts_per_s fused_encode_text": (
                len(ids), lambda: fused_encode_text(model, ids)),
        }
        for name, (count, fn) in routes.items():
            ms = cuda_ms(fn, iters=5, warmup=1)
            print(f"[throughput] {name}: {count / ms * 1e3:.1f} "
                  f"(batch {count}, {ms:.2f} ms) on {gpu}")

    def entry(name, source, replaces, prefix):
        rows = [v for k, v in kernel_results.items() if k.startswith(prefix)]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r[0] for r in rows),
                "ms": rows[0][1], "plain_ms": rows[0][2]}

    print(json.dumps({"kernels": [
        entry("fused_block", "clip_embeds_tpu_torch/csrc/fused_block.cu",
              "clip_embeds_tpu/ops/fused_block.py:170", "fused_block"),
        entry("flash_attention", "clip_embeds_tpu_torch/csrc/attention.cu",
              "clip_embeds_tpu/ops/flash_attention.py:144",
              "flash_attention"),
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
