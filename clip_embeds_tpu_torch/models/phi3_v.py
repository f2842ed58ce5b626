"""Phi-3-V: the HD-crop image embedding + the Phi-3 decoder (counterpart of
``clip_embeds_tpu/models/phi3_v.py``; the backbone of VLM2Vec's released
``TIGER-Lab/VLM2Vec-Full`` and ``VLM2Vec-LoRA``).

* host: the HD transform (an aspect-preserving resize to a canvas of
  336-px crops, at most ``hd_num``, white padding), a bicubic global
  thumbnail computed as torch's ``interpolate(mode='bicubic',
  antialias=False)`` on the normalised canvas (in numpy, as JAX has it),
  and the crops in (row, col) order;
* device: the CLIP ViT-L/14-336 tower read at block -2 (the port's
  :class:`~.vit.VisionTransformer`, holding the 23 tapped blocks as
  ``Llava`` does), a 2x2 spatial-to-channel merge, ``sub_GN`` closing each
  row, the ``glb_GN`` separator in 'sub_glb' order, ``proj_2(gelu(
  proj_1))``, and the image tokens placed at the negative input ids.

One call takes one (h_crop, w_crop) grid (mixed grids go in separate
calls, as in JAX). On the card the tower's attention takes the flash
kernel (#4) in bf16; the trunk takes it on ``forward`` without a mask
(Phi-3's head dim 96), and plain attention under a padding mask, as JAX.
Module names are the flax ones (``vision_embed.img_processor``,
``glb_GN``, ``sub_GN``, ``proj_1``, ``proj_2``, ``language_model``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .layers import exact_gelu
from .llama import LlamaConfig, LlamaForCausalLM
from .llava import place_in_order, tapped_tower
from .phi3 import phi3_mini_config
from .quant import linear

MAX_INPUT_ID = int(1e9)
CROP = 336


# -- host preprocessing -------------------------------------------------------


def hd_transform_grid(width: int, height: int, hd_num: int = 16
                      ) -> Tuple[int, int]:
    """(h_crop, w_crop) the HD transform produces for an image
    (calc_hd_transform_size, image_processing_phi3_v.py:94-114)."""
    transposed = False
    if width < height:
        width, height = height, width
        transposed = True
    ratio = width / height
    scale = 1
    while scale * math.ceil(scale / ratio) <= hd_num:
        scale += 1
    scale -= 1
    new_w = scale * CROP
    new_h = int(new_w / ratio)
    padded_h = int(math.ceil(new_h / CROP) * CROP)
    w_crop, h_crop = scale, padded_h // CROP
    if transposed:
        w_crop, h_crop = h_crop, w_crop
    return h_crop, w_crop


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (torch bicubic, a = -0.75)."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


def bicubic_no_antialias(arr: np.ndarray, out_h: int, out_w: int
                         ) -> np.ndarray:
    """torch ``interpolate(mode='bicubic', align_corners=False,
    antialias=False)`` on an [H, W, C] float array: the reference computes
    the global thumbnail so on the normalised tensor, which PIL (always
    antialiased when it shrinks) cannot reproduce."""
    h, w, _ = arr.shape

    def axis_weights(in_size, out_size):
        scale = in_size / out_size
        centers = (np.arange(out_size) + 0.5) * scale - 0.5
        base = np.floor(centers).astype(np.int64) - 1
        idx = base[:, None] + np.arange(4)[None, :]
        wts = _cubic_kernel(centers[:, None] - idx)
        wts /= wts.sum(axis=1, keepdims=True)
        return np.clip(idx, 0, in_size - 1), wts.astype(np.float32)

    yi, yw = axis_weights(h, out_h)
    xi, xw = axis_weights(w, out_w)
    rows = (arr[yi] * yw[:, :, None, None]).sum(axis=1)       # [oh, W, C]
    return (rows[:, xi] * xw[None, :, :, None]).sum(axis=2)   # [oh, ow, C]


def phi3v_process_image(image, hd_num: int = 16,
                        max_crops: Optional[int] = None
                        ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """One image -> ([1 + max_crops, 336, 336, 3] normalised crops (crop 0
    the global bicubic thumbnail; zero-padded), (h_crop, w_crop)):
    Phi3VImageProcessor.preprocess's HD resize (transposed if tall, the
    scale search), white padding to a multiple of 336, the thumbnail, the
    crops in (row, col) order, CLIP normalisation."""
    from PIL import Image

    from ..core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
    from ..image.preprocess import _to_pil

    img = _to_pil(image)
    w, h = img.size
    trans = False
    if w < h:
        img = img.transpose(Image.TRANSPOSE)
        trans = True
        w, h = img.size
    ratio = w / h
    scale = 1
    while scale * math.ceil(scale / ratio) <= hd_num:
        scale += 1
    scale -= 1
    new_w = scale * CROP
    new_h = int(new_w / ratio)
    img = img.resize((new_w, new_h), Image.BILINEAR)
    # padding_336: centre-pad the height with white
    tar = int(math.ceil(new_h / CROP) * CROP)
    top = (tar - new_h) // 2
    canvas = Image.new("RGB", (new_w, tar), (255, 255, 255))
    canvas.paste(img, (0, top))
    if trans:
        canvas = canvas.transpose(Image.TRANSPOSE)

    cw, ch = canvas.size
    h_crop, w_crop = ch // CROP, cw // CROP
    mean = np.asarray(OPENAI_DATASET_MEAN, np.float32)
    std = np.asarray(OPENAI_DATASET_STD, np.float32)
    arr = (np.asarray(canvas, np.float32) / 255.0 - mean) / std
    crops: List[np.ndarray] = [bicubic_no_antialias(arr, CROP, CROP)]
    for r in range(h_crop):
        for c in range(w_crop):
            crops.append(arr[r * CROP:(r + 1) * CROP,
                             c * CROP:(c + 1) * CROP])
    out = np.stack(crops)
    if max_crops is not None and out.shape[0] < 1 + max_crops:
        pad = np.zeros((1 + max_crops - out.shape[0],) + out.shape[1:],
                       np.float32)
        out = np.concatenate([out, pad], axis=0)
    return out, (h_crop, w_crop)


def phi3v_num_image_tokens(h_crop: int, w_crop: int) -> int:
    """The image tokens of an (h_crop, w_crop) grid: sub tokens
    h12 (w12 + 1), the glb_GN separator, the global 12 x 13
    (image_processing_phi3_v.py:258)."""
    h12, w12 = h_crop * 12, w_crop * 12
    return h12 * (w12 + 1) + 1 + 12 * 13


# -- device model -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phi3VConfig:
    text: LlamaConfig = dataclasses.field(default_factory=phi3_mini_config)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    feature_layer: int = -2
    vision_quick_gelu: bool = True

    @property
    def tower_blocks(self) -> int:
        """The vision blocks the hidden tap runs (and the tower holds)."""
        return self.vision.layers + 1 + self.feature_layer


class Phi3VImageEmbedding(nn.Module):
    """The HD feature transform: crops -> one packed feature sequence."""

    def __init__(self, cfg: Phi3VConfig):
        super().__init__()
        self.cfg = cfg
        self.img_processor = tapped_tower(cfg.vision, cfg.feature_layer,
                                          cfg.vision_quick_gelu)
        c4, d = cfg.vision.width * 4, cfg.text.hidden_size
        self.glb_GN = nn.Parameter(torch.zeros(c4))
        self.sub_GN = nn.Parameter(torch.zeros(c4))
        self.proj_1 = linear(False, c4, d)
        self.proj_2 = linear(False, d, d)

    @staticmethod
    def _merge_2x2(feats: torch.Tensor, h_crop: int, w_crop: int
                   ) -> torch.Tensor:
        """[B * crops, 576, C] -> [B, h_crop * 12, w_crop * 12, 4C]
        (reshape_hd_patches_2x2merge)."""
        n, l, c = feats.shape
        g = int(round(math.sqrt(l)))
        b = n // (h_crop * w_crop)
        x = feats.reshape(n, g // 2, 2, g // 2, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, (g // 2) ** 2, 4 * c)
        x = x.reshape(b, h_crop, w_crop, g // 2, g // 2, 4 * c).permute(
            0, 1, 3, 2, 4, 5)
        return x.reshape(b, h_crop * g // 2, w_crop * g // 2, 4 * c)

    def _add_newline(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C4] -> [B, H (W + 1), C4], sub_GN closing each row."""
        b, h, w, c4 = x.shape
        newline = self.sub_GN.to(x.dtype).expand(b, h, 1, c4)
        return torch.cat([x, newline], dim=2).reshape(b, h * (w + 1), c4)

    def forward(self, pixel_values: torch.Tensor, h_crop: int, w_crop: int
                ) -> torch.Tensor:
        """pixel_values [B, 1 + max_crops, 336, 336, 3] -> projected image
        tokens [B, S, hidden], S = h12 (w12 + 1) + 1 + 156 ('sub_glb')."""
        b = pixel_values.shape[0]
        n_crops = h_crop * w_crop
        used = pixel_values[:, :1 + n_crops]
        flat = used.reshape((b * (1 + n_crops),) + used.shape[2:])
        hidden = self.img_processor(flat,
                                    hidden_layer=self.cfg.feature_layer)
        feats = hidden[:, 1:]  # the patch features
        feats = feats.reshape(b, 1 + n_crops, *feats.shape[1:])
        glb = self._add_newline(self._merge_2x2(feats[:, 0], 1, 1))
        sub = self._add_newline(self._merge_2x2(
            feats[:, 1:].reshape(-1, *feats.shape[2:]), h_crop, w_crop))
        sep = self.glb_GN.to(feats.dtype).expand(b, 1, -1)
        seq = torch.cat([sub, sep, glb], dim=1)  # 'sub_glb' order
        return self.proj_2(exact_gelu(self.proj_1(seq)))


class Phi3V(nn.Module):
    def __init__(self, cfg: Phi3VConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_embed = Phi3VImageEmbedding(cfg)
        self.language_model = LlamaForCausalLM(cfg.text)

    def merge(self, input_ids: torch.Tensor, image_features: torch.Tensor
              ) -> torch.Tensor:
        """The image tokens at the negative-id positions, in order (the
        reference's index_put; a cumsum gather here)."""
        image_mask = (input_ids < 0) & (input_ids > -MAX_INPUT_ID)
        return place_in_order(image_mask, image_features,
                              self.language_model.embed(
                                  input_ids.clamp_min(0)))

    def _embeds(self, input_ids, pixel_values, h_crop, w_crop):
        if pixel_values is None:
            return self.language_model.embed(input_ids.clamp_min(0))
        feats = self.vision_embed(pixel_values, h_crop, w_crop)
        return self.merge(input_ids, feats)

    def forward(self, input_ids: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                h_crop: int = 1, w_crop: int = 1,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Logits [B, L, vocab]; image slots of ``input_ids`` [B, L] are
        negative ids."""
        embeds = self._embeds(input_ids, pixel_values, h_crop, w_crop)
        mask = None if attention_mask is None else attention_mask.bool()
        hidden = self.language_model.trunk(embeds, mask)
        return self.language_model.logits(hidden)

    def embed_last_token(self, input_ids: torch.Tensor,
                         pixel_values: Optional[torch.Tensor] = None,
                         h_crop: int = 1, w_crop: int = 1,
                         attention_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """VLM2Vec pooling [B, D]: the hidden state at ``sum(mask) - 1``
        (right padding), L2-normalised."""
        embeds = self._embeds(input_ids, pixel_values, h_crop, w_crop)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.int)
        hidden = self.language_model.trunk(embeds, attention_mask.bool())
        last = attention_mask.int().sum(dim=1) - 1
        return l2_normalize(hidden[torch.arange(hidden.shape[0]), last])
