"""Train and eval image transforms: the port's own copy of
``clip_embeds_tpu/image/transform.py`` (open_clip's ``transform.py``).

* ``AugmentationCfg``: RandomResizedCrop scale/ratio and the simclr-style
  color_jitter(+prob) / gray_scale_prob train augmentations, and the timm
  branch (``use_timm``: always-on ColorJitter and RandomErasing).
* train: RandomResizedCrop(scale=(0.9, 1.0), bicubic) -> optional
  color_jitter(p) -> optional gray_scale(p) -> normalize.
* eval: resize_mode 'shortest' (Resize + CenterCrop), 'longest'
  (ResizeKeepRatio(longest=1) + CenterCropOrPad) and 'squash' (Resize).

The transforms run on the host (PIL and numpy) and give float32 [S, S, 3]
channels-last arrays, the same bytes as the JAX package's for the same
image and generator. Randomness comes from an explicit
``np.random.Generator``: :func:`sample_rng` derives one per (seed, epoch,
sample), so a threaded loader stays deterministic whatever the order its
workers finish in. The JAX module's ``pretrained_preprocess_cfg`` needs the
open_clip registry's per-tag mean/std/interpolation entries, which the
port's registry copy does not hold; it is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image, ImageEnhance

from ..core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from .preprocess import (
    ImageLike,
    _center_crop,
    _normalize,
    _resize_shortest,
    _to_pil,
)

_PIL_INTERP = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}


@dataclasses.dataclass(frozen=True)
class PreprocessCfg:
    """transform.py:17-38 PreprocessCfg (size/mean/std/interpolation/
    resize_mode/fill_color)."""

    size: Union[int, Tuple[int, int]] = 224
    mode: str = "RGB"
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0


@dataclasses.dataclass(frozen=True)
class AugmentationCfg:
    """transform.py:63-72 AugmentationCfg."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Union[float, Tuple[float, ...]]] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None


# -- eval-side geometry ------------------------------------------------------


def resize_keep_ratio(
    img: Image.Image,
    size: Union[int, Tuple[int, int]],
    longest: float = 0.0,
    interpolation: str = "bicubic",
) -> Image.Image:
    """ResizeKeepRatio (transform.py:88-164, the timm copy): scale so that
    ``longest`` interpolates between shortest-edge (0) and longest-edge (1)
    fitting. longest=1 makes the image fit INSIDE (size, size)."""
    th, tw = (size, size) if isinstance(size, int) else tuple(size)
    w, h = img.size
    ratio_h, ratio_w = h / th, w / tw
    ratio = (max(ratio_h, ratio_w) * longest
             + min(ratio_h, ratio_w) * (1.0 - longest))
    new_h, new_w = round(h / ratio), round(w / ratio)
    return img.resize((new_w, new_h), _PIL_INTERP[interpolation])


def center_crop_or_pad(
    arr: np.ndarray, size: Union[int, Tuple[int, int]], fill: float = 0.0
) -> np.ndarray:
    """CenterCropOrPad (transform.py:167-237): pad any short edge with
    ``fill`` (left-biased like torchvision F.pad's ltrb split), then center
    crop. Operates on an HWC array so it composes with either decode path."""
    th, tw = (size, size) if isinstance(size, int) else tuple(size)
    h, w = arr.shape[:2]
    if th > h or tw > w:
        pad_l = (tw - w) // 2 if tw > w else 0
        pad_t = (th - h) // 2 if th > h else 0
        pad_r = (tw - w + 1) // 2 if tw > w else 0
        pad_b = (th - h + 1) // 2 if th > h else 0
        arr = np.pad(
            arr, ((pad_t, pad_b), (pad_l, pad_r)) + ((0, 0),) * (arr.ndim - 2),
            constant_values=fill,
        )
        h, w = arr.shape[:2]
        if (h, w) == (th, tw):
            return arr
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return arr[top : top + th, left : left + tw]


# -- train-side augmentation --------------------------------------------------


def random_resized_crop_params(
    rng: np.random.Generator,
    height: int,
    width: int,
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
) -> Tuple[int, int, int, int]:
    """(top, left, h, w) with torchvision RandomResizedCrop.get_params
    semantics: 10 tries of uniform-area x log-uniform-aspect sampling, then
    the ratio-clamped center-crop fallback."""
    area = float(height * width)
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    in_ratio = width / height
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def random_resized_crop(
    img: Image.Image,
    rng: np.random.Generator,
    size: int,
    scale: Tuple[float, float] = (0.9, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    interpolation: str = "bicubic",
) -> Image.Image:
    """RandomResizedCrop: crop box + resize in one PIL op (resize(box=...) is
    exactly torchvision's PIL resized_crop)."""
    w_img, h_img = img.size
    top, left, h, w = random_resized_crop_params(rng, h_img, w_img, scale,
                                                 ratio)
    return img.resize(
        (size, size), _PIL_INTERP[interpolation],
        box=(left, top, left + w, top + h),
    )


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return np.clip(f * a + (1.0 - f) * b, 0, 255)


def adjust_hue(img: Image.Image, hue_shift: float) -> Image.Image:
    """torchvision functional_pil.adjust_hue: roll the HSV hue byte."""
    if abs(hue_shift) < 1e-9:
        return img
    h, s, v = img.convert("HSV").split()
    h_arr = np.asarray(h, np.uint8)
    h_arr = (h_arr.astype(np.int16) + int(hue_shift * 255)).astype(np.uint8)
    return Image.merge(
        "HSV", (Image.fromarray(h_arr, "L"), s, v)
    ).convert("RGB")


def color_jitter_image(
    img: Image.Image,
    rng: np.random.Generator,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
) -> Image.Image:
    """torchvision ColorJitter: per-op factor uniform in [max(0,1-x), 1+x]
    (hue in [-h, h]), applied in a random permutation of the four ops
    (PIL ImageEnhance backend, like torchvision's PIL path)."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda im, f=f: adjust_hue(im, f))
    for i in rng.permutation(len(ops)):
        img = ops[int(i)](img)
    return img


def grayscale3(img: Image.Image) -> Image.Image:
    """Grayscale(num_output_channels=3): ITU-R 601-2 luma, replicated."""
    return img.convert("L").convert("RGB")


def random_erasing(
    arr: np.ndarray,
    rng: np.random.Generator,
    probability: float,
    count: int = 1,
    min_area: float = 0.02,
    max_area: float = 1.0 / 3,
    log_aspect: Tuple[float, float] = (math.log(0.3), math.log(10 / 3)),
) -> np.ndarray:
    """timm RandomErasing (mode='pixel'): erase up to ``count`` rectangles
    of the NORMALIZED image with per-pixel N(0,1) noise. Applied after
    normalize, like timm's transform order."""
    if probability <= 0 or rng.uniform() >= probability:
        return arr
    h, w, c = arr.shape
    area = h * w
    out = arr
    for _ in range(count):
        for _ in range(10):
            target = area * rng.uniform(min_area, max_area) / count
            aspect = math.exp(rng.uniform(*log_aspect))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh))
                left = int(rng.integers(0, w - ew))
                out = out.copy() if out is arr else out
                out[top : top + eh, left : left + ew] = rng.standard_normal(
                    (eh, ew, c)).astype(arr.dtype)
                break
    return out


TransformFn = Callable[..., np.ndarray]


def image_transform(
    image_size: Union[int, Tuple[int, int]],
    is_train: bool,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    resize_mode: Optional[str] = None,
    interpolation: Optional[str] = None,
    fill_color: int = 0,
    aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
) -> TransformFn:
    """Build a preprocessing callable (transform.py:274-390 image_transform).

    Eval: ``fn(image) -> float32 [S, S, 3]``.
    Train: ``fn(image, rng: np.random.Generator) -> float32 [S, S, 3]`` —
    RandomResizedCrop + optional color_jitter(p)/gray_scale(p).
    """
    mean = tuple(mean or OPENAI_DATASET_MEAN)
    std = tuple(std or OPENAI_DATASET_STD)
    interpolation = interpolation or "bicubic"
    # 'random' is only meaningful inside the timm train branch (timm
    # RandomResizedCropAndInterpolation picks bilinear/bicubic per image);
    # everywhere else it degrades to bicubic like the reference
    # (transform.py:295 InterpolationMode fallback)
    random_interp = interpolation == "random"
    if random_interp:
        interpolation = "bicubic"
    assert interpolation in ("bicubic", "bilinear"), interpolation
    resize_mode = resize_mode or "shortest"
    assert resize_mode in ("shortest", "longest", "squash"), resize_mode
    if isinstance(aug_cfg, dict):
        aug_cfg = AugmentationCfg(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in aug_cfg.items()}
        )
    aug = aug_cfg or AugmentationCfg()
    size = image_size if isinstance(image_size, int) else tuple(image_size)

    if is_train:
        if aug.use_timm:
            # the reachable surface of timm create_transform
            # (transform.py:305-332): AugmentationCfg has no auto_augment
            # field, so the timm branch reduces to RRC (+ the
            # interpolation='random' per-image bilinear/bicubic pick of
            # RandomResizedCropAndInterpolation) + always-on
            # ColorJitter(f -> (f,f,f)) + normalize + RandomErasing(re_prob,
            # re_count, mode='pixel' pinned at :329); hflip=0 in the
            # reference call.
            scale = tuple(aug.scale)
            ratio = tuple(aug.ratio) if aug.ratio else (3 / 4, 4 / 3)
            cj = aug.color_jitter
            if isinstance(cj, (int, float)):
                cj = (float(cj),) * 3
            out_size = size if isinstance(size, int) else size[0]

            def timm_fn(image: ImageLike,
                        rng: np.random.Generator) -> np.ndarray:
                img = _to_pil(image)
                # timm RandomResizedCropAndInterpolation order: crop params
                # first, THEN the per-image interpolation pick
                w_img, h_img = img.size
                top, left, h, w = random_resized_crop_params(
                    rng, h_img, w_img, scale, ratio)
                interp = interpolation
                if random_interp:
                    interp = ("bilinear", "bicubic")[int(rng.integers(2))]
                img = img.resize(
                    (out_size, out_size), _PIL_INTERP[interp],
                    box=(left, top, left + w, top + h),
                )
                if cj:
                    img = color_jitter_image(img, rng, *cj[:3])
                arr = _normalize(np.asarray(img), mean, std)
                if aug.re_prob:
                    arr = random_erasing(arr, rng, aug.re_prob,
                                         aug.re_count or 1)
                return arr

            return timm_fn
        if aug.color_jitter_prob:
            cj = aug.color_jitter
            assert isinstance(cj, (tuple, list)) and len(cj) == 4, (
                "color_jitter_prob needs a 4-tuple color_jitter "
                "(transform.py:327-330)"
            )
        scale = tuple(aug.scale)
        ratio = tuple(aug.ratio) if aug.ratio else (3.0 / 4.0, 4.0 / 3.0)
        out_size = size if isinstance(size, int) else size[0]

        def train_fn(image: ImageLike, rng: np.random.Generator) -> np.ndarray:
            img = _to_pil(image)
            img = random_resized_crop(img, rng, out_size, scale, ratio)
            if aug.color_jitter_prob and rng.uniform() < aug.color_jitter_prob:
                img = color_jitter_image(img, rng, *aug.color_jitter)
            if aug.gray_scale_prob and rng.uniform() < aug.gray_scale_prob:
                img = grayscale3(img)
            return _normalize(np.asarray(img), mean, std)

        return train_fn

    def eval_fn(image: ImageLike) -> np.ndarray:
        img = _to_pil(image)
        if resize_mode == "squash":
            th, tw = (size, size) if isinstance(size, int) else size
            img = img.resize((tw, th), _PIL_INTERP[interpolation])
            return _normalize(np.asarray(img), mean, std)
        if resize_mode == "longest":
            img = resize_keep_ratio(img, size, longest=1.0,
                                    interpolation=interpolation)
            arr = np.asarray(img)
            arr = center_crop_or_pad(arr, size, fill=fill_color)
            return _normalize(arr, mean, std)
        # shortest: Resize(shortest edge) + CenterCrop
        short = size if isinstance(size, int) else min(size)
        img = _resize_shortest(img, short)
        if isinstance(size, int):
            img = _center_crop(img, size)
            return _normalize(np.asarray(img), mean, std)
        img = resize_keep_ratio(img, size, longest=0.0,
                                interpolation=interpolation)
        arr = center_crop_or_pad(np.asarray(img), size, fill=0)
        return _normalize(arr, mean, std)

    return eval_fn


def image_transform_v2(
    cfg: PreprocessCfg,
    is_train: bool,
    aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
) -> TransformFn:
    """transform.py:384-... image_transform_v2."""
    return image_transform(
        image_size=cfg.size, is_train=is_train, mean=cfg.mean, std=cfg.std,
        resize_mode=cfg.resize_mode, interpolation=cfg.interpolation,
        fill_color=cfg.fill_color, aug_cfg=aug_cfg,
    )


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Order-independent per-sample rng (counter-based Philox keyed on
    (seed, epoch, index)) so threaded loaders stay deterministic."""
    key = np.array([np.uint64(seed) ^ (np.uint64(epoch) << np.uint64(32)),
                    np.uint64(index)], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))
