"""Host image preprocessing: the port's own copy of
``clip_embeds_tpu/image/preprocess.py`` without ``jax_preprocess`` (the
on-device JAX path).

Two pipelines, mirroring the two (inconsistent) reference conventions:

* ``clip``: shortest-edge bicubic resize -> center crop -> scale -> normalize
  with OpenAI CLIP stats (reference open_clip/src/open_clip/transform.py:274-390,
  eval 'shortest' branch).
* ``pacl``: squash-resize the full image to (S, S) bilinear -> normalize with
  ImageNet stats (reference Patch-Aligned-Contrastive-Learning/data/utils.py:30-55
  — note it really does use ImageNet stats, not CLIP's).

The PIL functions give float parity with the torchvision eval transforms;
``preprocess_batch`` of paths runs the native C++ pipeline
(``image/loader.py``) where the library is built, bit-equal to PIL for
baseline JPEG and PNG.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image

from ..core.constants import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)

ImageLike = Union[str, Image.Image, np.ndarray]


def _to_pil(image: ImageLike) -> Image.Image:
    if isinstance(image, str):
        with Image.open(image) as fh:
            return fh.convert("RGB")
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    return image.convert("RGB")


def _resize_shortest(img: Image.Image, size: int) -> Image.Image:
    """Resize so the shortest edge equals `size` (torchvision Resize(int))."""
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    if short == size:
        return img
    new_short = size
    # torchvision _compute_resized_output_size truncates (int(), no round)
    new_long = int(size * long / short)
    new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
    return img.resize((new_w, new_h), Image.BICUBIC)


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def _normalize(arr: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    arr = arr.astype(np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr


def preprocess_clip(image: ImageLike, image_size: int = 336) -> np.ndarray:
    """CLIP eval transform -> float32 [H, W, 3] (channels-last)."""
    img = _to_pil(image)
    img = _resize_shortest(img, image_size)
    img = _center_crop(img, image_size)
    return _normalize(np.asarray(img), OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)


def preprocess_pacl(image: ImageLike, image_size: int = 336) -> np.ndarray:
    """PACL eval transform (squash resize, ImageNet stats) -> float32 [H, W, 3].

    The reference applies ToTensor first and resizes the tensor bilinearly with
    antialiasing; PIL BILINEAR resize of the uint8 image matches to within fp
    tolerance for the argmax-based benchmarks.
    """
    img = _to_pil(image)
    img = img.resize((image_size, image_size), Image.BILINEAR)
    return _normalize(np.asarray(img), IMAGENET_MEAN, IMAGENET_STD)


def preprocess_siglip(image: ImageLike, image_size: int = 384) -> np.ndarray:
    """SigLIP transform: squash resize, inception (0.5) stats
    (reference pretrained.py _slpcfg: resize_mode='squash')."""
    img = _to_pil(image)
    img = img.resize((image_size, image_size), Image.BICUBIC)
    return _normalize(np.asarray(img), (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))


def preprocess_batch(
    images: Sequence[ImageLike],
    image_size: int = 336,
    variant: str = "clip",
) -> np.ndarray:
    fn = {
        "clip": preprocess_clip,
        "pacl": preprocess_pacl,
        "llava": preprocess_llava,
        "siglip": preprocess_siglip,
    }[variant]
    # All-path batches go through the C++ pipeline (decode+resize+normalize
    # threaded, GIL-free, bit-exact vs the PIL path) when the variant's
    # geometry is covered; any slot it can't decode falls back per-image.
    if images and all(isinstance(im, str) for im in images):
        from .loader import decode_preprocess_batch, variant_kwargs

        kwargs = variant_kwargs(variant)
        if kwargs is not None:
            blobs = []
            for path in images:
                try:
                    with open(path, "rb") as fh:
                        blobs.append(fh.read())
                except OSError:
                    blobs.append(b"")
            out, ok = decode_preprocess_batch(blobs, image_size, **kwargs)
            if ok.all():
                return out
            for i in np.flatnonzero(~ok):  # undecodable: PIL error surface
                out[i] = fn(images[i], image_size)
            return out
    return np.stack([fn(im, image_size) for im in images])


def expand2square(img: Image.Image, background: Tuple[int, int, int]) -> Image.Image:
    """Pad to square with a background color (t2v_metrics mm_utils.py:10-22)."""
    w, h = img.size
    if w == h:
        return img
    size = max(w, h)
    out = Image.new("RGB", (size, size), background)
    if w > h:
        out.paste(img, (0, (w - h) // 2))
    else:
        out.paste(img, ((h - w) // 2, 0))
    return out


def preprocess_llava(image: ImageLike, image_size: int = 336) -> np.ndarray:
    """LLaVA-1.5 image path: expand2square with the CLIP dataset mean, then
    bicubic resize + CLIP normalization (llava_model.py:277-287 load_images
    with image_aspect_ratio='pad' + CLIPImageProcessor)."""
    img = _to_pil(image)
    background = tuple(int(x * 255) for x in OPENAI_DATASET_MEAN)
    img = expand2square(img, background)
    img = img.resize((image_size, image_size), Image.BICUBIC)
    return _normalize(np.asarray(img), OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)


# -- Native (C++) host path ------------------------------------------------


def native_resize_normalize(
    image_u8: np.ndarray,
    image_size: int,
    mean: Sequence[float],
    std: Sequence[float],
    bicubic: bool = True,
) -> Optional[np.ndarray]:
    """One HWC uint8 image -> resized+normalized float32 via the C++ library.

    Returns None when the native library is unavailable (callers fall back to
    PIL). Matches Pillow's antialiased convolution resampling.
    """
    import ctypes

    from ..native.build import load_library

    lib = load_library()
    if lib is None:
        return None
    image_u8 = np.ascontiguousarray(image_u8, dtype=np.uint8)
    h, w, c = image_u8.shape
    assert c == 3
    out = np.empty((image_size, image_size, 3), np.float32)
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    lib.resize_normalize_one(
        image_u8.ctypes.data_as(ctypes.c_void_p), h, w,
        out.ctypes.data_as(ctypes.c_void_p), image_size, image_size,
        mean_arr.ctypes.data_as(ctypes.c_void_p),
        std_arr.ctypes.data_as(ctypes.c_void_p),
        1 if bicubic else 0,
    )
    return out


def native_resize_normalize_batch(
    batch_u8: np.ndarray,
    image_size: int,
    mean: Sequence[float],
    std: Sequence[float],
    bicubic: bool = True,
    num_threads: int = 0,
) -> Optional[np.ndarray]:
    """Same-sized [N, H, W, 3] uint8 batch -> [N, S, S, 3] float32, threaded."""
    import ctypes

    from ..native.build import load_library

    lib = load_library()
    if lib is None:
        return None
    batch_u8 = np.ascontiguousarray(batch_u8, dtype=np.uint8)
    n, h, w, c = batch_u8.shape
    assert c == 3
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    lib.resize_normalize_batch(
        batch_u8.ctypes.data_as(ctypes.c_void_p), n, h, w,
        out.ctypes.data_as(ctypes.c_void_p), image_size, image_size,
        mean_arr.ctypes.data_as(ctypes.c_void_p),
        std_arr.ctypes.data_as(ctypes.c_void_p),
        1 if bicubic else 0, num_threads,
    )
    return out


def native_preprocess_clip(
    image: ImageLike, image_size: int = 336
) -> Optional[np.ndarray]:
    """CLIP eval transform on the native path: shortest-edge bicubic resize
    (C++) + center crop (view) + fused normalize. None if lib unavailable."""
    import ctypes

    from ..native.build import load_library

    lib = load_library()
    if lib is None:
        return None
    arr = np.asarray(_to_pil(image), np.uint8)
    h, w, _ = arr.shape
    # torchvision _compute_resized_output_size truncates the long edge
    # (int(), no round) — keep in lockstep with _resize_shortest
    if h <= w:
        new_h, new_w = image_size, max(int(image_size * w / h), image_size)
    else:
        new_w, new_h = image_size, max(int(image_size * h / w), image_size)
    out = np.empty((new_h, new_w, 3), np.float32)
    mean_arr = np.asarray(OPENAI_DATASET_MEAN, np.float32)
    std_arr = np.asarray(OPENAI_DATASET_STD, np.float32)
    arr = np.ascontiguousarray(arr)
    lib.resize_normalize_one(
        arr.ctypes.data_as(ctypes.c_void_p), h, w,
        out.ctypes.data_as(ctypes.c_void_p), new_h, new_w,
        mean_arr.ctypes.data_as(ctypes.c_void_p),
        std_arr.ctypes.data_as(ctypes.c_void_p), 1,
    )
    top = int(round((new_h - image_size) / 2.0))
    left = int(round((new_w - image_size) / 2.0))
    return out[top : top + image_size, left : left + image_size]
