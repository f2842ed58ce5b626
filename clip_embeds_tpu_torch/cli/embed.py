"""Batch image / text embedding on the card (counterpart of
``clip_embeds_tpu/cli/embed.py``).

Images are decoded on the host with PIL (corrupt files are skipped) and go
through the composable ``encode_image``, whose attention takes the CUDA
flash kernel for bf16 on the card. Texts go through ``fused_encode_text``
(the fused-block kernels) on the card in bf16 when the shapes allow, else
through the composable ``encode_text``. On the CPU both run the plain
PyTorch paths. The tail batch is padded to the batch size and sliced after.

Usage:
  python -m clip_embeds_tpu_torch.cli.embed --model ViT-L-14-336 \
      --pretrained /ckpt.pt --input /data/images --output emb.npy \
      [--batch-size 256] [--fp32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

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


def _run(encode, batches: Iterable[np.ndarray], batch_size: int,
         device: torch.device) -> np.ndarray:
    outputs = []
    with torch.inference_mode():
        for arr in batches:
            x = torch.from_numpy(_pad_tail(arr, batch_size)).to(device)
            outputs.append(encode(x)[: len(arr)])
    if not outputs:
        return np.zeros((0, 0), np.float32)
    return torch.cat(outputs).float().cpu().numpy()


def embed_image_batches(model, batches: Iterable[np.ndarray],
                        batch_size: int) -> np.ndarray:
    """Decoded pixel batches (float32 [b <= batch_size, S, S, 3]) ->
    L2-normalised embeddings, float32 [N, embed_dim]."""
    dtype = model.visual.proj.dtype
    device = model.visual.proj.device
    return _run(lambda px: model.encode_image(px.to(dtype), normalize=True),
                batches, batch_size, device)


def text_route(model) -> str:
    """'fused' (fused-block kernels) or 'composable' for the text tower."""
    from ..models.serving import fused_path_available

    p = model.text_projection
    if p.is_cuda and p.dtype == torch.bfloat16 and fused_path_available(model):
        return "fused"
    return "composable"


def embed_text_batches(model, batches: Iterable[np.ndarray],
                       batch_size: int) -> np.ndarray:
    """Token-id batches (int [b <= batch_size, ctx]) -> L2-normalised
    embeddings, float32 [N, embed_dim]."""
    device = model.text_projection.device
    if text_route(model) == "fused":
        from ..models.serving import fused_encode_text

        def encode(ids):
            return fused_encode_text(model, ids, normalize=True)
    else:
        def encode(ids):
            return model.encode_text(ids, normalize=True)
    return _run(lambda ids: encode(ids.long()), batches, batch_size, device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _embed_texts(args, model) -> int:
    """One caption per line -> [N, D] .npy."""
    from ..shared import load_shared

    with open(args.input_texts) as fh:
        texts = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if not texts:
        print(f"no texts in {args.input_texts}", file=sys.stderr)
        return 1
    tokenizer = load_shared("text/tokenizer.py").get_tokenizer(
        model.cfg.text.context_length)
    bs = args.batch_size
    t0 = time.perf_counter()
    embs = embed_text_batches(
        model, (tokenizer(texts[i: i + bs]) for i in range(0, len(texts), bs)),
        bs)
    elapsed = time.perf_counter() - t0
    np.save(args.output, embs)
    print(json.dumps({
        "texts": len(texts),
        "dim": int(embs.shape[1]),
        "seconds": round(elapsed, 3),
        "texts_per_sec": round(len(texts) / elapsed, 2),
        "route": text_route(model),
        "device": _device_name(model.text_projection.device),
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
    args = ap.parse_args(argv)

    if (args.input is None) == (args.input_texts is None):
        print("exactly one of --input / --input-texts is required",
              file=sys.stderr)
        return 1

    from ..core.factory import create_model
    from ..image import load_image

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = create_model(args.model, pretrained=args.pretrained,
                         dtype=dtype, device=device)
    if args.input_texts is not None:
        return _embed_texts(args, model)

    paths = list_images(args.input)
    if not paths:
        print(f"no images under {args.input}", file=sys.stderr)
        return 1
    size = model.cfg.vision.image_size
    bs = args.batch_size
    kept_paths: List[str] = []

    def batches():
        batch: List[np.ndarray] = []
        for path in paths:
            arr = load_image(path, size)
            if arr is None:
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
    embs = embed_image_batches(model, batches(), bs)
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
        "device": _device_name(device),
        "output": args.output,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
