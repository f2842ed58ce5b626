"""LLaVA-NeXT / LLaVA-1.6 (AnyRes) with static shapes (counterpart of
``clip_embeds_tpu/models/llava_next.py``).

The reference packs a ragged feature sequence an image (the base crop's
features, the unpadded grid of the best-fit resolution's crops, a learned
newline closing each row) and scatters it into the token stream. As in
JAX the work is split so that every shape is fixed:

* **host plan** (numpy, an image): the best grid pinpoint, the unpadded
  rows and columns, and three arrays over the fixed ``max_features``
  budget: ``gather`` (into the flattened [crops, n_base] feature pool),
  ``is_newline`` and ``valid``;
* **pack** on the device: one gather and a ``where`` against the learned
  ``image_newline``;
* **merge**: the image sentinel expands to the ``max_features`` block
  (``models/llava.py splice_positions``), the invalid slots are masked out
  of attention and the RoPE positions are ``cumsum(mask) - 1``, so the
  valid tokens see the packed layout's positions.

The trunk always runs under that mask, so its attention is plain (as in
JAX); the CLIP tower (read at block -2, the 23 tapped blocks) takes the
flash kernel (#4) in bf16 on the card, one call over every crop of the
batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .llama import LlamaConfig, LlamaForCausalLM
from .llava import MultiModalProjector, _gather_rows, splice_positions
from .llava import tapped_tower

# HF llava-v1.6 default grid pinpoints, (height, width)
DEFAULT_GRID_PINPOINTS: Tuple[Tuple[int, int], ...] = (
    (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008),
)


def select_best_resolution(original_hw: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]]
                           ) -> Tuple[int, int]:
    """The best-fit (height, width) pinpoint: the most effective
    resolution, then the least waste (transformers
    select_best_resolution)."""
    oh, ow = original_hw
    best = None
    max_effective = 0
    min_wasted = float("inf")
    for h, w in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        wasted = w * h - effective
        if effective > max_effective or (
                effective == max_effective and wasted < min_wasted):
            max_effective, min_wasted = effective, wasted
            best = (h, w)
    assert best is not None
    return best


def anyres_grid_shape(original_hw: Tuple[int, int],
                      grid_pinpoints: Sequence[Tuple[int, int]],
                      crop_size: int) -> Tuple[int, int]:
    """(num_patch_h, num_patch_w) of the chosen pinpoint."""
    h, w = select_best_resolution(original_hw, grid_pinpoints)
    return h // crop_size, w // crop_size


def max_num_crops(grid_pinpoints: Sequence[Tuple[int, int]],
                  crop_size: int) -> int:
    return max((h // crop_size) * (w // crop_size)
               for h, w in grid_pinpoints)


@dataclasses.dataclass
class AnyresPackPlan:
    """The host's fixed-shape packing plan of one image."""

    gather: np.ndarray      # int32 [max_features] into [(1+max_crops)*n_base]
    is_newline: np.ndarray  # bool [max_features]
    valid: np.ndarray       # bool [max_features]
    num_crops: int          # spatial crops used (the base not counted)
    feature_len: int


def anyres_max_features(grid_pinpoints: Sequence[Tuple[int, int]],
                        vision_size: int, patch_size: int) -> int:
    """The fixed feature budget: the base plus the largest possible grid
    (no unpadding: rows x (cols + 1))."""
    g = vision_size // patch_size
    best = 0
    for h, w in grid_pinpoints:
        rows = (h // vision_size) * g
        cols = (w // vision_size) * g
        best = max(best, rows * (cols + 1))
    return g * g + best


def anyres_pack_plan(original_hw: Tuple[int, int],
                     grid_pinpoints: Sequence[Tuple[int, int]],
                     vision_size: int, patch_size: int,
                     max_features: Optional[int] = None) -> AnyresPackPlan:
    """pack_image_features (modeling_llava_next.py:657-717) as index
    arithmetic: the base features first, then the unpadded grid in
    row-major order with a newline closing each row."""
    g = vision_size // patch_size
    n_base = g * g
    if max_features is None:
        max_features = anyres_max_features(grid_pinpoints, vision_size,
                                           patch_size)
    nph, npw = anyres_grid_shape(original_hw, grid_pinpoints, vision_size)
    rows, cols = nph * g, npw * g

    # unpad_image, in the original (h, w) order
    oh, ow = original_hw
    if ow / oh > cols / rows:
        new_h = int(oh * (cols / ow))
        pad = (rows - new_h) // 2
        r0, r1, c0, c1 = pad, rows - pad, 0, cols
    else:
        new_w = int(ow * (rows / oh))
        pad = (cols - new_w) // 2
        r0, r1, c0, c1 = 0, rows, pad, cols - pad

    gather = np.zeros((max_features,), np.int32)
    is_newline = np.zeros((max_features,), bool)
    valid = np.zeros((max_features,), bool)
    gather[:n_base] = np.arange(n_base, dtype=np.int32)
    valid[:n_base] = True
    k = n_base
    for r in range(r0, r1):
        for c in range(c0, c1):
            crop = 1 + (r // g) * npw + (c // g)
            gather[k] = crop * n_base + (r % g) * g + (c % g)
            valid[k] = True
            k += 1
        is_newline[k] = True
        valid[k] = True
        k += 1
    assert k <= max_features, (k, max_features)
    return AnyresPackPlan(gather=gather, is_newline=is_newline, valid=valid,
                          num_crops=nph * npw, feature_len=k)


def resize_and_pad(image, target_hw: Tuple[int, int]):
    """PIL resize keeping the aspect, centred on a black (h, w) canvas
    (llava_arch.py:68-100)."""
    from PIL import Image

    ow, oh = image.size
    th, tw = target_hw
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh), Image.BICUBIC)
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def process_anyres_image(image, vision_size: int,
                         grid_pinpoints: Sequence[Tuple[int, int]],
                         mean: Sequence[float], std: Sequence[float]
                         ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """One image -> ([1 + max_crops, S, S, 3] float crops, zero-padded;
    the original (h, w)). Crop 0 is the squashed base image, crops 1..n
    the best resolution's tiling (LlavaNextImageProcessor
    .get_image_patches)."""
    from PIL import Image

    from ..image.preprocess import _to_pil

    img = _to_pil(image)
    ow, oh = img.size
    best = select_best_resolution((oh, ow), grid_pinpoints)
    padded = resize_and_pad(img, best)
    crops: List[np.ndarray] = [
        np.asarray(img.resize((vision_size, vision_size), Image.BICUBIC))]
    bw, bh = padded.size
    for top in range(0, bh, vision_size):
        for left in range(0, bw, vision_size):
            crops.append(np.asarray(padded.crop(
                (left, top, left + vision_size, top + vision_size))))
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    arr = (np.stack(crops).astype(np.float32) / 255.0 - mean_arr) / std_arr
    total = 1 + max_num_crops(grid_pinpoints, vision_size)
    if arr.shape[0] < total:
        pad = np.zeros((total - arr.shape[0],) + arr.shape[1:], np.float32)
        arr = np.concatenate([arr, pad], axis=0)
    return arr, (oh, ow)


# -- device model -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LlavaNextConfig:
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    grid_pinpoints: Tuple[Tuple[int, int], ...] = DEFAULT_GRID_PINPOINTS
    feature_layer: int = -2
    feature_select: str = "patch"  # 'default' strategy == drop CLS
    vision_quick_gelu: bool = True

    @property
    def max_features(self) -> int:
        return anyres_max_features(self.grid_pinpoints,
                                   self.vision.image_size,
                                   self.vision.patch_size)

    @property
    def n_base(self) -> int:
        g = self.vision.image_size // self.vision.patch_size
        return g * g

    @property
    def tower_blocks(self) -> int:
        """The vision blocks the hidden tap runs (and the tower holds)."""
        return self.vision.layers + 1 + self.feature_layer


class LlavaNext(nn.Module):
    def __init__(self, cfg: LlavaNextConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.llama.hidden_size
        self.vision_tower = tapped_tower(cfg.vision, cfg.feature_layer,
                                         cfg.vision_quick_gelu)
        self.multi_modal_projector = MultiModalProjector(cfg.vision.width, d)
        self.image_newline = nn.Parameter(torch.zeros(d))
        self.language_model = LlamaForCausalLM(cfg.llama)

    def encode_crops(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, C, S, S, 3] -> projected crop features [B, C, n_base, D]:
        one tower call over the B x C crops."""
        b, c = pixel_values.shape[:2]
        flat = pixel_values.reshape((b * c,) + pixel_values.shape[2:])
        hidden = self.vision_tower(flat, hidden_layer=self.cfg.feature_layer)
        feats = self.multi_modal_projector(hidden[:, 1:])  # drop CLS
        return feats.reshape(b, c, *feats.shape[1:])

    def pack(self, crop_features: torch.Tensor, gather: torch.Tensor,
             is_newline: torch.Tensor) -> torch.Tensor:
        """The fixed-shape pack_image_features: [B, F, D]."""
        b, c, n, d = crop_features.shape
        out = _gather_rows(crop_features.reshape(b, c * n, d), gather.long())
        newline = self.image_newline.to(out.dtype)
        return torch.where(is_newline[..., None], newline, out)

    def merge(self, input_ids: torch.Tensor, packed: torch.Tensor,
              feat_valid: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(embeds [B, L - 1 + F, D], bool mask, positions): the ragged
        merge with masked holes; positions ``max(cumsum(mask) - 1, 0)``."""
        f = packed.shape[1]
        text_embeds = self.language_model.embed(input_ids.clamp_min(0))
        _, is_image, text_gather, image_gather = splice_positions(input_ids,
                                                                  f)
        text_part = _gather_rows(text_embeds, text_gather)
        image_part = _gather_rows(packed.to(text_part.dtype), image_gather)
        embeds = torch.where(is_image[..., None], image_part, text_part)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.bool)
        text_mask = torch.gather(attention_mask.int(), 1, text_gather)
        image_mask = torch.gather(feat_valid.int(), 1, image_gather)
        mask = torch.where(is_image, image_mask, text_mask)
        positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
        return embeds, mask.bool(), positions

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                gather: torch.Tensor, is_newline: torch.Tensor,
                feat_valid: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Logits [B, L - 1 + F, vocab]; the rows of invalid slots are
        garbage for the caller to ignore through the merge mask."""
        packed = self.pack(self.encode_crops(pixel_values), gather,
                           is_newline)
        embeds, mask, positions = self.merge(input_ids, packed, feat_valid,
                                             attention_mask)
        hidden = self.language_model.trunk(embeds, mask, positions)
        return self.language_model.logits(hidden)

    def embed_last_token(self, input_ids: torch.Tensor,
                         pixel_values: Optional[torch.Tensor] = None,
                         gather: Optional[torch.Tensor] = None,
                         is_newline: Optional[torch.Tensor] = None,
                         feat_valid: Optional[torch.Tensor] = None,
                         attention_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """VLM2Vec pooling [B, D]: the hidden state of the last *valid*
        token (holes are allowed mid-sequence, so the largest valid index,
        not ``sum(mask) - 1``), L2-normalised."""
        if pixel_values is not None:
            packed = self.pack(self.encode_crops(pixel_values), gather,
                               is_newline)
            embeds, mask, positions = self.merge(input_ids, packed,
                                                 feat_valid, attention_mask)
        else:
            embeds = self.language_model.embed(input_ids.clamp_min(0))
            mask = (torch.ones_like(input_ids, dtype=torch.bool)
                    if attention_mask is None else attention_mask.bool())
            positions = (torch.cumsum(mask.int(), dim=1) - 1).clamp_min(0)
        hidden = self.language_model.trunk(embeds, mask, positions)
        idx = torch.arange(hidden.shape[1], device=hidden.device)[None, :]
        last = torch.where(mask, idx, -1).amax(dim=1)
        return l2_normalize(hidden[torch.arange(hidden.shape[0]), last])
