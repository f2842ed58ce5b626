#!/usr/bin/env python3
"""Host image decode rates of the checkout this script sits in:

    python3 scripts/host_decode_times.py [n_images]

Writes n_images (default 256) seeded 640x480 JPEGs of smooth fields with
mild noise (chip_smoke.py's phase 7 photos) to a temporary directory, then
decodes and preprocesses them to ViT-L/14-336 input (336 x 336, the CLIP
eval transform) with ``image/loader.py decode_preprocess_batch``: on the
native C++ pipeline where its library builds, and on the PIL fallback,
each on one thread and on one thread per core. Prints img/s for each, and
the PIL path's time per image by step on one thread (decode, bicubic
resize, crop, normalize). A host measurement: it needs no card, and prints
the card's name and power limit where nvidia-smi answers, since on the
card's machine the host beside it is what is measured.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from clip_embeds_tpu_torch.core.constants import (  # noqa: E402
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)
from clip_embeds_tpu_torch.image import loader  # noqa: E402
from clip_embeds_tpu_torch.image.preprocess import (  # noqa: E402
    _center_crop,
    _normalize,
    _resize_shortest,
)
from clip_embeds_tpu_torch.native import build  # noqa: E402

SIZE = 336


def rate(blobs, threads):
    t0 = time.perf_counter()
    _, ok = loader.decode_preprocess_batch(blobs, SIZE, num_threads=threads)
    seconds = time.perf_counter() - t0
    if not ok.all():
        raise AssertionError("a fixture image did not decode")
    return len(blobs) / seconds


def pil_steps(blobs):
    """ms per image of each step of the PIL path, on one thread."""
    from PIL import Image

    steps = dict.fromkeys(("decode", "resize", "crop", "normalize"), 0.0)
    for blob in blobs:
        t0 = time.perf_counter()
        img = Image.open(io.BytesIO(blob)).convert("RGB")
        t1 = time.perf_counter()
        img = _resize_shortest(img, SIZE)
        t2 = time.perf_counter()
        arr = np.asarray(_center_crop(img, SIZE))
        t3 = time.perf_counter()
        _normalize(arr, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
        t4 = time.perf_counter()
        for k, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[k] += dt
    return {k: round(v / len(blobs) * 1e3, 2) for k, v in steps.items()}


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    cores = os.cpu_count()
    try:
        host = cs.gpu_line()
    except (OSError, subprocess.CalledProcessError):
        host = "no card"
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, "img", f"{i:04d}.jpg") for i in range(n)]
        cs.write_photos(paths, 1)
        blobs = []
        for p in paths:
            with open(p, "rb") as fh:
                blobs.append(fh.read())
    print(f"[decode] {n} JPEGs {cs.PHOTO[1]}x{cs.PHOTO[0]}, mean "
          f"{np.mean([len(b) for b in blobs]) / 1024:.1f} KiB -> {SIZE}x"
          f"{SIZE}; {cores} cores; {host}")
    native = build.load_library() is not None
    rates = {}
    for threads in (1, cores):
        if native:
            rates[f"native, {threads} threads"] = rate(blobs, threads)
    build.load_library = lambda: None  # every slot takes the PIL fallback
    for threads in (1, cores):
        rates[f"pil, {threads} threads"] = rate(blobs, threads)
    for k, v in rates.items():
        print(f"[decode] {k}: {v:.1f} img/s")
    if not native:
        print("[decode] native: the library did not build here")
    print(f"[decode] pil, one thread, ms per image by step: "
          f"{pil_steps(blobs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
