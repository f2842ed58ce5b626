"""Batch image / text embedding on the card (counterpart of
``clip_embeds_tpu/cli/embed.py``).

Images are read and decoded ahead of the card by ``image/loader.py``'s
``PrefetchLoader``: a background thread runs the native C++ pipeline
(``native/decode.cpp``; JPEG/PNG/WebP decode, resize, crop and normalize on
``--workers`` threads) where its library builds, else PIL on as many
threads. Undecodable files are skipped and device batches repack across
loader batches. ``--fast-jpeg`` (DCT-domain downscaled JPEG decode) needs
the native library, since its pixels differ from PIL's. Each batch is
copied to the card from pinned host memory without blocking, and the
embeddings stay on the card until one fetch at the end.

Images go through the composable ``encode_image``, whose attention takes
the CUDA flash kernel for bf16 on the card. Texts go through
``fused_encode_text`` (the fused-block kernels) on the card in bf16 when
the shapes allow, else through the composable ``encode_text``. On the CPU
both run the plain PyTorch paths. The tail batch is padded to the batch
size and sliced after.

``--int8`` serves W8A8 (``models/quant.py``), with int8 weights quantised
from the fp32 weights and static activation scales calibrated on the first
16 images of the first batch, or on the first 64 texts. On the card,
where the shapes allow, both towers run ``fused_encode_*_int8`` (the
``fused_block_int8`` kernels, which compute in bf16: ``--int8 --fp32``
raises there). Elsewhere images take the composable static-quant model
and texts stay on the composable fp tower, as the JAX CLI routes off the
TPU. The JSON line names the route and the image decoder that ran.

Usage:
  python -m clip_embeds_tpu_torch.cli.embed --model ViT-L-14-336 \
      --pretrained /ckpt.pt --input /data/images --output emb.npy \
      [--batch-size 256] [--fp32] [--int8] [--workers N] [--fast-jpeg] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import sys
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..core.factory import create_model, device_name, resolve_device

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_images(root: str) -> List[str]:
    """A directory (walked), one image, or a manifest of one path a line."""
    if os.path.isfile(root) and not root.lower().endswith(tuple(IMAGE_EXTS)):
        with open(root) as fh:
            return [ln.strip() for ln in fh if ln.strip()]
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if os.path.splitext(fn)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(dirpath, fn))
    return out


def _pad_tail(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Repeat the last row up to ``batch_size`` rows (one static shape)."""
    if len(arr) == batch_size:
        return arr
    return np.concatenate(
        [arr, np.repeat(arr[-1:], batch_size - len(arr), axis=0)])


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``. To the card it is copied from pinned
    memory without blocking; the pinned buffer comes from PyTorch's caching
    host allocator, which records an event for the copy and hands the
    buffer out again only after that copy has finished, so the host can
    stage the next batch while this one is in flight."""
    x = torch.from_numpy(arr)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _run(encode, batches: Iterable[np.ndarray], batch_size: int,
         device: torch.device) -> np.ndarray:
    outputs = []
    with torch.inference_mode():
        for arr in batches:
            x = _to_device(_pad_tail(arr, batch_size), device)
            outputs.append(encode(x)[: len(arr)])
    if not outputs:
        return np.zeros((0, 0), np.float32)
    return torch.cat(outputs).float().cpu().numpy()


def _as_dtype(model, dtype: torch.dtype):
    """``model`` itself if it computes in ``dtype``, else a cast copy."""
    if model.visual.proj.dtype == dtype:
        return model
    return copy.deepcopy(model).to(dtype)


def _on_card(model) -> bool:
    return model.visual.proj.is_cuda


def _int8_fused(model, dtype: torch.dtype) -> bool:
    """Whether ``--int8`` takes the fused_block_int8 kernels: on the card
    whenever the shapes allow, as the JAX CLI does on the TPU in any dtype.
    The kernels compute in bf16, so fp32 there raises rather than serve a
    route the user did not ask for."""
    from ..models.serving import fused_path_available

    if not (_on_card(model) and fused_path_available(model)):
        return False
    if dtype != torch.bfloat16:
        raise ValueError("--int8 on the card runs the bf16 fused_block_int8 "
                         "kernels; --fp32 cannot be served with it")
    return True


def image_route(model, int8: bool = False,
                dtype: Optional[torch.dtype] = None) -> str:
    """'composable' (bf16/fp32 tower), 'fused_int8' (the fused_block_int8
    kernels) or 'composable_int8' (static-quant QuantLinear model)."""
    if not int8:
        return "composable"
    dtype = dtype or model.visual.proj.dtype
    return "fused_int8" if _int8_fused(model, dtype) else \
        "composable_int8"


def embed_image_batches(model, batches: Iterable[np.ndarray],
                        batch_size: int, int8: bool = False,
                        dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """Decoded pixel batches (float32 [b <= batch_size, S, S, 3]) ->
    L2-normalised embeddings, float32 [N, embed_dim], computed in
    ``dtype`` (default: the model's).

    With ``int8``, the int8 weights are quantised from ``model``'s weights
    (keep them fp32, as the JAX package's params are) and the activation
    scales are calibrated on the first batch's first 16 images; the route
    is :func:`image_route`'s."""
    dtype = dtype or model.visual.proj.dtype
    device = model.visual.proj.device
    route = image_route(model, int8, dtype)
    batches = iter(batches)
    first = next(batches, None)
    if first is None:
        return np.zeros((0, 0), np.float32)
    calib = torch.from_numpy(first[:16]).to(device) if int8 else None
    if route == "fused_int8":
        from ..models.serving import (
            fused_encode_image_int8,
            prepare_int8_tower,
        )

        qtower = prepare_int8_tower(model, calib, dtype)

        def encode(px):
            return fused_encode_image_int8(model, qtower, px, dtype=dtype)
    else:
        if route == "composable_int8":
            from ..models.quant import calibrate_act_scales, quantize_model

            tower = quantize_model(model, "dynamic", dtype, tower="visual")
            with torch.inference_mode():
                calibrate_act_scales(tower, [calib], "encode_image")
        else:
            tower = _as_dtype(model, dtype)

        def encode(px):
            return tower.encode_image(px.to(dtype), normalize=True)
    return _run(encode, itertools.chain([first], batches), batch_size,
                device)


def text_route(model, int8: bool = False,
               dtype: Optional[torch.dtype] = None) -> str:
    """'fused' or 'fused_int8' (the fused-block kernels, bf16 on the card)
    or 'composable' for the text tower."""
    dtype = dtype or model.text_projection.dtype
    if int8:
        return "fused_int8" if _int8_fused(model, dtype) else "composable"
    from ..models.serving import fused_route

    return "fused" if fused_route(model, dtype) else "composable"


def embed_text_batches(model, batches: Iterable[np.ndarray],
                       batch_size: int, int8: bool = False,
                       dtype: Optional[torch.dtype] = None,
                       calib: Optional[np.ndarray] = None) -> np.ndarray:
    """Token-id batches (int [b <= batch_size, ctx]) -> L2-normalised
    embeddings, float32 [N, embed_dim], computed in ``dtype``.

    With ``int8`` and the 'fused_int8' route, the activation scales are
    calibrated on ``calib`` (default: the first batch); off that route
    texts stay on the fp tower, as in the JAX CLI."""
    dtype = dtype or model.text_projection.dtype
    device = model.text_projection.device
    route = text_route(model, int8, dtype)
    batches = iter(batches)
    first = next(batches, None)
    if first is None:
        return np.zeros((0, 0), np.float32)
    if route == "fused_int8":
        from ..models.serving import (
            fused_encode_text_int8,
            prepare_int8_text_tower,
        )

        ids = first if calib is None else calib
        qtower = prepare_int8_text_tower(
            model, torch.from_numpy(ids).long().to(device), dtype)

        def encode(ids):
            return fused_encode_text_int8(model, qtower, ids, dtype=dtype)
    elif route == "fused":
        from ..models.serving import fused_encode_text

        def encode(ids):
            return fused_encode_text(model, ids, dtype=dtype)
    else:
        tower = _as_dtype(model, dtype)

        def encode(ids):
            return tower.encode_text(ids, normalize=True)
    return _run(lambda ids: encode(ids.long()),
                itertools.chain([first], batches), batch_size, device)


def _embed_texts(args, model, dtype: torch.dtype) -> int:
    """One caption per line -> [N, D] .npy."""
    from ..text.tokenizer import get_tokenizer

    with open(args.input_texts) as fh:
        texts = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if not texts:
        print(f"no texts in {args.input_texts}", file=sys.stderr)
        return 1
    tokenizer = get_tokenizer(model.cfg.text.context_length)
    bs = args.batch_size
    t0 = time.perf_counter()
    embs = embed_text_batches(
        model, (tokenizer(texts[i: i + bs]) for i in range(0, len(texts), bs)),
        bs, int8=args.int8, dtype=dtype,
        calib=tokenizer(texts[:64]) if args.int8 else None)
    elapsed = time.perf_counter() - t0
    np.save(args.output, embs)
    print(json.dumps({
        "texts": len(texts),
        "dim": int(embs.shape[1]),
        "seconds": round(elapsed, 3),
        "texts_per_sec": round(len(texts) / elapsed, 2),
        "route": text_route(model, args.int8, dtype),
        "device": device_name(model.text_projection.device),
        "output": args.output,
    }))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ViT-L-14-336")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--input", default=None,
                    help="image directory, single image, or manifest file")
    ap.add_argument("--input-texts", default=None,
                    help="text file (one caption per line) -> text-tower "
                    "embeddings instead of image embeddings")
    ap.add_argument("--output", required=True, help=".npy output path")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--int8", action="store_true",
                    help="int8 W8A8 serving path (models/quant.py)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 8,
                    help="image decode threads")
    ap.add_argument("--fast-jpeg", action="store_true",
                    help="DCT-domain downscaled JPEG decode (faster host "
                    "pipeline; pixels deviate slightly from PIL-exact; "
                    "needs the native library)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: exits if there is no card) "
                    "or 'cpu'")
    args = ap.parse_args(argv)

    if (args.input is None) == (args.input_texts is None):
        print("exactly one of --input / --input-texts is required",
              file=sys.stderr)
        return 1

    from ..image.loader import PrefetchLoader
    from ..native.build import decoder_name

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    decoder = decoder_name() if args.input is not None else None
    if args.fast_jpeg and decoder == "pil":
        print("--fast-jpeg needs the native image library, which did not "
              "build (see the error above); PIL's pixels differ from it",
              file=sys.stderr)
        return 1
    # --int8 quantises from fp32 weights, as the JAX package does
    model = create_model(args.model, pretrained=args.pretrained,
                         dtype=torch.float32 if args.int8 else dtype,
                         device=device)
    if args.input_texts is not None:
        return _embed_texts(args, model, dtype)

    paths = list_images(args.input)
    if not paths:
        print(f"no images under {args.input}", file=sys.stderr)
        return 1
    size = model.cfg.vision.image_size
    bs = args.batch_size
    kept_paths: List[str] = []
    # The loader decodes batch i+1 in a background thread while the card
    # runs batch i; undecodable files are dropped (wds log_and_continue
    # semantics), so device batches repack across loader batches.
    loader = PrefetchLoader(paths, batch_size=bs, image_size=size,
                            fast_jpeg=args.fast_jpeg,
                            num_threads=args.workers)

    def batches():
        batch: List[np.ndarray] = []
        for chunk, arrs, ok in loader:
            for path, arr, good in zip(chunk, arrs, ok):
                if not good:
                    print(f"skip {path}: undecodable", file=sys.stderr)
                    continue
                kept_paths.append(path)
                batch.append(arr)
                if len(batch) == bs:
                    yield np.stack(batch)
                    batch = []
        if batch:
            yield np.stack(batch)

    t0 = time.perf_counter()
    embs = embed_image_batches(model, batches(), bs, int8=args.int8,
                               dtype=dtype)
    elapsed = time.perf_counter() - t0
    if not kept_paths:
        print(f"no decodable images under {args.input}", file=sys.stderr)
        return 1
    np.save(args.output, embs)
    with open(args.output + ".paths.json", "w") as fh:
        json.dump(kept_paths, fh)
    print(json.dumps({
        "images": len(kept_paths),
        "dim": int(embs.shape[1]),
        "seconds": round(elapsed, 3),
        "images_per_sec": round(len(kept_paths) / elapsed, 2),
        "route": image_route(model, args.int8, dtype),
        "decoder": decoder,
        "workers": args.workers,
        "device": device_name(device),
        "output": args.output,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
