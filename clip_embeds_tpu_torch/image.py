"""Host image decode for the CLIP eval transform (counterpart of the PIL path
of ``clip_embeds_tpu/image/preprocess.py``): shortest-side bicubic resize,
center crop, OpenAI mean/std. Returns channels-last float32 [S, S, 3].
PIL is imported on first use."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


def preprocess_clip(image, image_size: int) -> np.ndarray:
    """A path or PIL image -> normalised float32 [S, S, 3]."""
    from PIL import Image

    if isinstance(image, str):
        with Image.open(image) as fh:
            img = fh.convert("RGB")
    else:
        img = image.convert("RGB")
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    if short != image_size:
        # torchvision Resize(int) truncates the long side
        new_long = int(image_size * long / short)
        size = ((image_size, new_long) if w <= h
                else (new_long, image_size))
        img = img.resize(size, Image.BICUBIC)
    w, h = img.size
    left = int(round((w - image_size) / 2.0))
    top = int(round((h - image_size) / 2.0))
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    mean = np.asarray(OPENAI_DATASET_MEAN, np.float32)
    std = np.asarray(OPENAI_DATASET_STD, np.float32)
    return (arr - mean) / std


def load_image(path: str, image_size: int) -> Optional[np.ndarray]:
    """Decode and preprocess one file; None if it cannot be decoded."""
    try:
        return preprocess_clip(path, image_size)
    except (OSError, ValueError):  # PIL.UnidentifiedImageError is an OSError
        return None
