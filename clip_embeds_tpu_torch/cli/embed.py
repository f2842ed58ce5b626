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
``fused_block_int8`` kernels). Elsewhere images take the composable
static-quant model and texts stay on the composable fp tower, as the JAX
CLI routes off the TPU. Every int8 route on the card computes in bf16
(QuantLinear there runs ``cet_gemm_s8``), so ``--int8 --fp32`` raises
there. The JSON line names the route and the image decoder that ran.

``--data-parallel`` (the default where more than one card is visible;
``--no-data-parallel`` turns it off) serves in this one process over every
visible card, as the JAX CLI's single controller does over its devices:
one replica a card (int8 calibrated once, on the first card, before it is
replicated), each batch split in order over them and the outputs joined in
input order; ``--batch-size`` is rounded down to a multiple of the cards.

``--model`` takes any name the registry builds as a CLIP (the zoo towers:
ModifiedResNet, EVA01 / EVA02, ConvNeXt, Swin, ViTamin, FastViT, MCi-ViT,
the timm and rel-pos ViTs). Their images take the composable tower (EVA01's
blocks reach the flash kernel on the card; the others' attention is plain,
as in JAX) and their texts the fused or composable text tower as above;
``--int8`` on a zoo tower's images raises, where the JAX CLI fails too.

Usage:
  python -m clip_embeds_tpu_torch.cli.embed --model ViT-L-14-336 \
      --pretrained /ckpt.pt --input /data/images --output emb.npy \
      [--batch-size 256] [--fp32] [--int8] [--workers N] [--fast-jpeg] \
      [--device cuda|cpu] [--data-parallel | --no-data-parallel]
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

from ..core import tracing
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
    stage the next batch while this one is in flight. The span
    ``embed.h2d`` holds the copy alone (not the pinning) and counts its
    bytes as ``h2d_bytes``."""
    x = torch.from_numpy(arr)
    pinned = device.type == "cuda"
    if pinned:
        x = x.pin_memory()
    with tracing.span("embed.h2d"):
        tracing.count("h2d_bytes", x.nbytes)
        return x.to(device, non_blocking=pinned)


def _replicate(obj, device: torch.device):
    """A copy of ``obj`` (a module, tensors, or containers of them) on
    ``device`` (a quantised tower's other tower, left on the meta device,
    stays there)."""
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj)._apply(
            lambda t: t if t.is_meta else t.to(device))
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _replicate(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_replicate(v, device) for v in obj)
    return obj


def _run(encode, state, batches: Iterable[np.ndarray], batch_size: int,
         devices: List[torch.device]) -> np.ndarray:
    """``encode(state, x)`` over the padded batches; with several devices,
    ``state`` (on the first) and a replica of it on each other, every
    batch split in order over them, the outputs joined in input order on
    the first.

    Under a torch profiler it records the spans ``embed.call`` >
    ``embed.loop`` > ``embed.batch`` (``seq``: the batch) and
    ``embed.call`` > ``embed.fetch`` (the single fetch of every
    embedding), the loop's and the fetch's ``cudaMalloc`` calls among
    them (``core/tracing.py``)."""
    replicas = [state] + [_replicate(state, d) for d in devices[1:]]
    outputs = []
    with tracing.span("embed.call"), torch.inference_mode():
        with tracing.span("embed.loop", mallocs=True):
            for i, arr in enumerate(batches):
                with tracing.span("embed.batch", seq=i, rows=len(arr)):
                    parts = np.split(_pad_tail(arr, batch_size),
                                     len(devices))
                    outs = [encode(st, _to_device(p, d))
                            for st, p, d in zip(replicas, parts, devices)]
                    outputs.append(torch.cat([o.to(devices[0])
                                              for o in outs])[: len(arr)])
        if not outputs:
            return np.zeros((0, 0), np.float32)
        with tracing.span("embed.fetch", mallocs=True):
            return torch.cat(outputs).float().cpu().numpy()


def visible_devices(device: torch.device) -> List[torch.device]:
    """The devices data-parallel serving spreads over: every visible card
    for the card, the one CPU otherwise."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def data_parallel_batch(batch_size: int, n_devices: int) -> int:
    """``batch_size`` rounded down to a multiple of ``n_devices`` (at least
    one row a device), with the JAX CLI's line on stderr where it
    changes."""
    if batch_size % n_devices == 0:
        return batch_size
    rounded = max(n_devices, batch_size // n_devices * n_devices)
    print(f"batch size rounded to {rounded} ({n_devices}-device data "
          "parallel)", file=sys.stderr)
    return rounded


def _as_dtype(model, dtype: torch.dtype):
    """``model`` itself if it computes in ``dtype``, else a cast copy."""
    if model.text_projection.dtype == dtype:
        return model
    return copy.deepcopy(model).to(dtype)


def _on_card(model) -> bool:
    return model.text_projection.is_cuda


def _int8_fused(model, dtype: torch.dtype) -> bool:
    """Whether ``--int8`` takes the fused_block_int8 kernels: on the card
    whenever the shapes allow, as the JAX CLI does on the TPU in any dtype.
    Every int8 route on the card computes in bf16 (fused_block_int8, and
    QuantLinear's cet_gemm_s8 where the shapes keep the tower composable),
    so fp32 there raises rather than serve a route the user did not ask
    for."""
    from ..models.serving import fused_path_available

    if not _on_card(model):
        return False
    if dtype != torch.bfloat16:
        raise ValueError("--int8 on the card runs the bf16 int8 kernels "
                         "(fused_block_int8, cet_gemm_s8); --fp32 cannot be "
                         "served with it")
    return fused_path_available(model)


def image_route(model, int8: bool = False,
                dtype: Optional[torch.dtype] = None) -> str:
    """'composable' (bf16/fp32 tower), 'fused_int8' (the fused_block_int8
    kernels) or 'composable_int8' (static-quant QuantLinear model)."""
    if not int8:
        return "composable"
    if model.cfg.vision.tower != "vit":
        # JAX's CLI quantises the tree's block projections, which the zoo
        # towers do not read (ScopeParamNotFoundError at the first batch)
        raise NotImplementedError(
            f"--int8 on the {model.cfg.vision.tower!r} vision tower: the "
            "W8A8 serving path quantises the ViT's blocks only (the JAX "
            "CLI fails on this tower too)")
    dtype = dtype or model.text_projection.dtype
    return "fused_int8" if _int8_fused(model, dtype) else \
        "composable_int8"


def embed_image_batches(model, batches: Iterable[np.ndarray],
                        batch_size: int, int8: bool = False,
                        dtype: Optional[torch.dtype] = None,
                        devices: Optional[List[torch.device]] = None
                        ) -> np.ndarray:
    """Decoded pixel batches (float32 [b <= batch_size, S, S, 3]) ->
    L2-normalised embeddings, float32 [N, embed_dim], computed in
    ``dtype`` (default: the model's).

    With ``int8``, the int8 weights are quantised from ``model``'s weights
    (keep them fp32, as the JAX package's params are) and the activation
    scales are calibrated on the first batch's first 16 images; the route
    is :func:`image_route`'s. ``devices`` (default: the model's) serve
    data-parallel, a replica each; ``batch_size`` must divide by their
    number."""
    dtype = dtype or model.text_projection.dtype
    device = model.text_projection.device
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

        state = (model, prepare_int8_tower(model, calib, dtype))

        def encode(st, px):
            return fused_encode_image_int8(st[0], st[1], px, dtype=dtype)
    else:
        if route == "composable_int8":
            from ..models.quant import calibrate_act_scales, quantize_model

            state = quantize_model(model, "dynamic", dtype, tower="visual")
            with torch.inference_mode():
                calibrate_act_scales(state, [calib], "encode_image")
        else:
            state = _as_dtype(model, dtype)

        def encode(tower, px):
            return tower.encode_image(px.to(dtype), normalize=True)
    return _run(encode, state, itertools.chain([first], batches), batch_size,
                devices or [device])


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
                       calib: Optional[np.ndarray] = None,
                       devices: Optional[List[torch.device]] = None
                       ) -> np.ndarray:
    """Token-id batches (int [b <= batch_size, ctx]) -> L2-normalised
    embeddings, float32 [N, embed_dim], computed in ``dtype``.

    With ``int8`` and the 'fused_int8' route, the activation scales are
    calibrated on ``calib`` (default: the first batch); off that route
    texts stay on the fp tower, as in the JAX CLI. ``devices`` as in
    :func:`embed_image_batches`."""
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
        state = (model, prepare_int8_text_tower(
            model, torch.from_numpy(ids).long().to(device), dtype))

        def encode(st, ids):
            return fused_encode_text_int8(st[0], st[1], ids, dtype=dtype)
    elif route == "fused":
        from ..models.serving import fused_encode_text

        state = model

        def encode(m, ids):
            return fused_encode_text(m, ids, dtype=dtype)
    else:
        state = _as_dtype(model, dtype)

        def encode(tower, ids):
            return tower.encode_text(ids, normalize=True)
    return _run(lambda st, ids: encode(st, ids.long()), state,
                itertools.chain([first], batches), batch_size,
                devices or [device])


def _embed_texts(args, model, dtype: torch.dtype,
                 devices: List[torch.device]) -> int:
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
        calib=tokenizer(texts[:64]) if args.int8 else None, devices=devices)
    elapsed = time.perf_counter() - t0
    np.save(args.output, embs)
    print(json.dumps({
        "texts": len(texts),
        "dim": int(embs.shape[1]),
        "seconds": round(elapsed, 3),
        "texts_per_sec": round(len(texts) / elapsed, 2),
        "route": text_route(model, args.int8, dtype),
        "device": device_name(model.text_projection.device),
        "devices": len(devices),
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
    ap.add_argument("--data-parallel", action="store_true", default=None,
                    help="split batches over every visible card (default: "
                    "on when more than one is visible)")
    ap.add_argument("--no-data-parallel", dest="data_parallel",
                    action="store_false")
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
    devices = visible_devices(device)
    use_dp = (args.data_parallel if args.data_parallel is not None
              else len(devices) > 1)
    if use_dp:
        args.batch_size = data_parallel_batch(args.batch_size, len(devices))
    else:
        devices = [device]
    if args.input_texts is not None:
        return _embed_texts(args, model, dtype, devices)

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
                               dtype=dtype, devices=devices)
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
        "devices": len(devices),
        "output": args.output,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
