#!/usr/bin/env python3
"""Smoke run of the PyTorch port (clip_embeds_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card's name and power limit; TF32 off for the fp32 references;
  2. build the CUDA kernels from clip_embeds_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version, bf16 (int8 weights
     and static scales for fused_block_int8), at the main paths' shapes,
     with the tolerance stated;
  4. the main paths: ViT-L/14-336 (OpenAI config, seeded random weights,
     all 24 + 12 layers) serves 3 image and 3 text requests of 8 through
     embed_image_batches / embed_text_batches, the CLI's helpers: first in
     bf16, then with --int8 (W8A8, int8 weights from the fp32 weights,
     static scales calibrated on the first request). Each path's kernel
     launch counts are reset before it and must rise; the embeddings must
     be finite, unit-norm, and agree with the plain fp32 path (bf16) or
     with the bf16 embeddings (int8, the JAX package's 0.99 gate);
  5. timings with CUDA events: img/s per image route, texts/s (bf16 and
     int8), and each kernel against its plain version.

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


def int8_block_inputs(args, heads, kv, causal):
    """fused_block_int8 inputs from fused_block's: the weights quantised by
    the port's quantize_weight, the static scales calibrated by a dynamic
    pass of a quantised ResidualAttentionBlock over the same x."""
    from clip_embeds_tpu_torch.models.layers import ResidualAttentionBlock
    from clip_embeds_tpu_torch.models.quant import (
        calibrate_act_scales, quantize_state_dict)
    from clip_embeds_tpu_torch.models.serving import (
        INT8_BLOCK_ARGS, int8_block_args)

    x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, ln1, ln2 = args
    d, mlp = x.shape[-1], w1.shape[0]
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


def check_kernels(rng):
    """Phase 3: every kernel against its plain version on the same inputs."""
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8, fused_block_int8_reference,
        fused_block_reference)

    cases = []
    # (name, kernel call, plain call, tolerance on max |kernel - plain|,
    #  rows compared, tolerance on the mean |kernel - plain|)
    # Max: bf16 outputs below 8, where a rounding flip is <= 1/32; an int8
    # code that the two sides round apart moves its projection by
    # a * max|w| and later codes with it. Mean, per shape: about 2-5x the
    # sound reading (H100: bf16 0.0012 / 0.0005, int8 0.0076 / 0.0004),
    # far under a dropped bias (>= 0.26) and under two swapped int8 act
    # scales (0.020 / 0.015)
    for (b, n, d, heads, kv, causal), mean_tol, mean_tol8 in (
            ((4, 592, 1024, 16, 577, False), 0.004, 0.012),
            ((8, 80, 768, 12, 77, True), 0.002, 0.002)):
        args = block_inputs(rng, b, n, d, 4 * d)
        kw = dict(heads=heads, kv_valid=kv, quick_gelu=True, causal=causal)
        cases.append((f"fused_block {b}x{n}x{d} causal={causal}",
                      lambda a=args, k=kw: fused_block(*a, **k),
                      lambda a=args, k=kw: fused_block_reference(*a, **k),
                      0.125, kv, mean_tol))
        args8 = int8_block_inputs(args, heads, kv, causal)
        cases.append((f"fused_block_int8 {b}x{n}x{d} causal={causal}",
                      lambda a=args8, k=kw: fused_block_int8(*a, **k),
                      lambda a=args8, k=kw:
                      fused_block_int8_reference(*a, **k),
                      0.125, kv, mean_tol8))
    for shape, causal in (((4, 16, 577, 64), False), ((2, 12, 77, 64), True)):
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
        cases.append((f"flash_attention {'x'.join(map(str, shape))} "
                      f"causal={causal}",
                      lambda q=q, k=k, v=v, c=causal: flash_attention(q, k, v, c),
                      lambda q=q, k=k, v=v, c=causal:
                      flash_attention_reference(q, k, v, c),
                      0.02, shape[2], 0.02))
    results = {}
    for name, kernel, plain, tol, n_valid, mean_tol in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
        # padded query rows (fused_block) are not part of the contract
        diff = (got.float() - want.float())[..., :n_valid, :].abs()
        err = float(diff.max())
        mean = float(diff.mean())
        if not (err <= tol and mean <= mean_tol):
            raise AssertionError(f"{name}: max|diff| {err} (tol {tol}), "
                                 f"mean|diff| {mean} (tol {mean_tol})")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        print(f"[kernel] {name}: max|diff| {err:.6g} (tol {tol}), "
              f"mean|diff| {mean:.3g} (tol {mean_tol}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
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
        embed_image_batches, embed_text_batches, image_route, text_route)
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.models.serving import (
        fused_encode_image, fused_encode_image_int8, fused_encode_text,
        fused_encode_text_int8, fused_path_available, prepare_int8_text_tower,
        prepare_int8_tower)
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.flash_attention import flash_attention
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8)

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
                "fused_block": fused_block,
                "fused_block_int8": fused_block_int8}

    def drive(label, serve):
        """Run one path with every launch count set to 0 just before."""
        for fn in counters.values():
            fn.launches = 0
        out = serve()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        print(f"[main path] {label}: {REQUESTS} image + {REQUESTS} text "
              f"requests of {REQUEST_SIZE}; launches {counts}")
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

    (img, txt), launches = drive("bf16", lambda: (
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

    (img8, txt8), launches8 = drive("int8", lambda: (
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
    with torch.inference_mode():
        bs = 32
        px = torch.from_numpy(rng.standard_normal(
            (bs, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
                np.float32)).cuda()
        ids = torch.from_numpy(np.concatenate(texts * 11)[:256]).long().cuda()
        # the CLI's --int8 towers: calibrated on the first request, and
        # the fp parts read from the fp32 model
        q_img = prepare_int8_tower(ref, torch.from_numpy(images[0]).cuda(),
                                   bf16)
        q_txt = prepare_int8_text_tower(
            ref, torch.from_numpy(texts[0]).long().cuda(), bf16)
        routes = {
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
        for name, (count, fn) in routes.items():
            ms = cuda_ms(fn, iters=5, warmup=1)
            print(f"[throughput] {name}: {count / ms * 1e3:.1f} "
                  f"(batch {count}, {ms:.2f} ms) on {gpu}")

    def entry(name, source, replaces, path_launches):
        rows = [v for k, v in kernel_results.items()
                if k.split(" ")[0] == name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path_launches[name],
                "max_abs_err": max(r[0] for r in rows),
                "ms": rows[0][1], "plain_ms": rows[0][2]}

    print(json.dumps({"kernels": [
        entry("fused_block", "clip_embeds_tpu_torch/csrc/fused_block.cu",
              "clip_embeds_tpu/ops/fused_block.py:170", launches),
        entry("flash_attention", "clip_embeds_tpu_torch/csrc/attention.cu",
              "clip_embeds_tpu/ops/flash_attention.py:144", launches),
        entry("fused_block_int8",
              "clip_embeds_tpu_torch/csrc/fused_block_int8.cu",
              "clip_embeds_tpu/ops/fused_block.py:442", launches8),
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
