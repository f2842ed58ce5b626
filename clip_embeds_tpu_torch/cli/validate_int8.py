"""W8A8 accuracy validation: int8 vs bf16 embeddings, cross-distribution
(counterpart of ``clip_embeds_tpu/cli/validate_int8.py``; same flags,
report and exit code).

For every (calibration distribution) x (evaluation distribution) pair it
reports the int8-vs-bf16 embedding cosine (mean/min) and the top-1
nearest-neighbour agreement against the bf16 gallery. On the card, where
the shapes allow, both sides take the fused routes (``fused_encode_image``
and ``fused_encode_image_int8``); elsewhere the composable bf16 model and
the composable static-quant model calibrated in fp32, as the JAX command
routes off the TPU. Int8 weights are quantised from fp32 weights.

    python -m clip_embeds_tpu_torch.cli.validate_int8 --model ViT-L-14-336 \\
        --pretrained /path/openai_vitl336.pt --images /path/real_photos \\
        --out int8_report.json

Exit code 1 if any pair falls below --min-cos / --min-agreement.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from ..image.preprocess import jax_preprocess


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds_tpu_torch int8 validation")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--images", default=None,
                   help="directory of real images (adds a 'photos' "
                   "distribution)")
    p.add_argument("--distributions", default="noise,smooth,charts")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--min-cos", type=float, default=0.99)
    p.add_argument("--min-agreement", type=float, default=0.98)
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: exits if there is no card) "
                   "or 'cpu'")
    return p.parse_args(argv)


def make_batch(dist: str, n: int, size: int, rng,
               image_dir=None) -> np.ndarray:
    """uint8 [n, size, size, 3] samples of the named distribution: the
    port's own copy of the JAX command's ``make_batch`` (same numpy draws,
    so one seed gives both commands the same images)."""
    if dist == "noise":
        return rng.integers(0, 255, (n, size, size, 3), np.uint8)
    if dist == "smooth":
        # natural-image-like 1/f spectrum: a sum of low-frequency gradients
        yy, xx = np.mgrid[0:size, 0:size] / size
        out = np.zeros((n, size, size, 3), np.float32)
        for i in range(n):
            for c in range(3):
                img = np.zeros((size, size), np.float32)
                for k in range(1, 6):
                    fx, fy = rng.uniform(0, 3, 2)
                    ph = rng.uniform(0, 2 * np.pi)
                    img += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph) / k
                out[i, :, :, c] = img
        out -= out.min(axis=(1, 2, 3), keepdims=True)
        out /= out.max(axis=(1, 2, 3), keepdims=True) + 1e-8
        return (out * 255).astype(np.uint8)
    if dist == "charts":
        # hard edges and flat regions (text- and diagram-like statistics)
        out = np.full((n, size, size, 3), 255, np.uint8)
        for i in range(n):
            for _ in range(12):
                x0, y0 = rng.integers(0, size - 4, 2)
                w, h = rng.integers(2, size // 2, 2)
                color = rng.integers(0, 255, 3)
                out[i, y0:y0 + h, x0:x0 + w] = color
        return out
    if dist != "photos":
        raise KeyError(dist)
    from PIL import Image

    from .embed import list_images

    paths = list_images(image_dir)[:n]
    if not paths:
        raise FileNotFoundError(f"no images under {image_dir}")
    imgs = []
    for path in paths:
        with Image.open(path) as im:
            imgs.append(np.asarray(im.convert("RGB").resize((size, size)),
                                   np.uint8))
    while len(imgs) < n:
        imgs.append(imgs[len(imgs) % len(paths)])
    return np.stack(imgs)


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def main(argv=None):
    args = parse_args(argv)

    from ..core.factory import create_model, resolve_device
    from ..models.quant import (
        calibrate_act_scales,
        cast_floating,
        quantize_model,
    )
    from ..models.serving import (
        fused_encode_image,
        fused_encode_image_int8,
        fused_path_available,
        prepare_int8_tower,
    )

    device = resolve_device(args.device)
    dtype = torch.bfloat16
    model = create_model(args.model, pretrained=args.pretrained,
                         seed=args.seed, device=device)   # fp32
    size = model.cfg.vision.image_size
    rng = np.random.default_rng(args.seed)
    dists = [d for d in args.distributions.split(",") if d]
    if args.images:
        dists.append("photos")
    batches = {d: torch.from_numpy(make_batch(d, args.batch_size, size, rng,
                                              args.images)).to(device)
               for d in dists}

    def pixels(raw, dt=dtype):
        """JAX's on-device resize (where the size differs) and normalise."""
        return jax_preprocess(raw, size, "clip", dt)

    use_fused = device.type == "cuda" and fused_path_available(model)
    if use_fused:
        def embed_bf16(raw):
            return fused_encode_image(model, pixels(raw))
    else:
        bf16 = create_model(args.model, pretrained=args.pretrained,
                            seed=args.seed, dtype=dtype, device=device)

        def embed_bf16(raw):
            return bf16.encode_image(pixels(raw), normalize=True)

    def run(fn, raw):
        with torch.inference_mode():
            return fn(raw).float().cpu().numpy()

    bf16_embeds = {d: run(embed_bf16, b) for d, b in batches.items()}

    def build_int8(calib_raw):
        """Calibrate on one batch; return embed(raw) for the int8 path."""
        calib_px = pixels(calib_raw, torch.float32)
        if use_fused:
            qtower = prepare_int8_tower(model, calib_px, dtype)
            return lambda raw: fused_encode_image_int8(
                model, qtower, pixels(raw))
        # QuantLinear on the card runs cet_gemm_s8, which computes in
        # bf16: the card calibrates in bf16, the CPU in fp32 (the int8
        # weights come from the fp32 model either way)
        cal = dtype if device.type == "cuda" else torch.float32
        qmodel = quantize_model(model, "dynamic", cal, tower="visual")
        with torch.inference_mode():
            calibrate_act_scales(qmodel, [calib_px.to(cal)], "encode_image")
        cast_floating(qmodel, dtype)
        return lambda raw: qmodel.encode_image(pixels(raw), normalize=True)

    report: Dict = {"model": args.model, "pretrained": args.pretrained,
                    "fused_path": bool(use_fused), "pairs": []}
    ok = True
    for calib in dists:
        embed_q = build_int8(batches[calib])
        for ev in dists:
            q = run(embed_q, batches[ev])
            ref = bf16_embeds[ev]
            cos = _cosine(q, ref)
            # top-1 NN agreement against the bf16 gallery of the same batch
            sim_q = q @ ref.T
            sim_ref = ref @ ref.T
            np.fill_diagonal(sim_q, -np.inf)
            np.fill_diagonal(sim_ref, -np.inf)
            agree = float((sim_q.argmax(-1) == sim_ref.argmax(-1)).mean())
            row = {
                "calibration": calib, "eval": ev,
                "cos_mean": float(cos.mean()), "cos_min": float(cos.min()),
                "top1_agreement": agree,
            }
            row["pass"] = (row["cos_mean"] >= args.min_cos
                           and agree >= args.min_agreement)
            ok = ok and row["pass"]
            report["pairs"].append(row)
            print(f"calib={calib:7s} eval={ev:7s} "
                  f"cos mean {row['cos_mean']:.4f} min {row['cos_min']:.4f} "
                  f"top1 agree {agree:.3f} "
                  f"{'OK' if row['pass'] else 'BELOW THRESHOLD'}",
                  flush=True)
    report["pass"] = ok
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
