"""Swin Transformer vision tower, timm ``swin_base_patch4_window7_224``
(counterpart of ``clip_embeds_tpu/models/swin.py``).

patch_embed: conv 4x4 stride 4 -> LN; 4 stages of depths (2, 2, 18, 2) and
heads (4, 8, 16, 32); a block is LN -> windowed attention (7x7 windows,
relative position bias, every other block shifted by 3 with the
wrap-around mask) -> residual -> LN -> 4x GELU MLP -> residual; between
stages PatchMerging (2x2 concat -> LN -> bias-less Linear 4C -> 2C); final
LN, average pool, ``head.proj`` (no bias). The bias and the shift mask keep
attention plain (fp32 logits), as in JAX. LN eps 1e-5. Module names are
open_clip's ``visual.trunk.*`` in the layout JAX's converter reads
(``layers.{s}.blocks.{i}.*``, ``layers.{s}.downsample.*`` after stage s)
and ``visual.head.proj``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .timm_vit import LinearHead, TimmMlp, conv_patchify, merge_heads, \
    plain_attention

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    embed_dim: int = 128                      # stage-0 width (Swin-B)
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    heads: Tuple[int, ...] = (4, 8, 16, 32)
    window: int = 7
    mlp_ratio: float = 4.0
    out_dim: int = 640                        # CLIP projection dim

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def relative_position_index(window: int) -> np.ndarray:
    """[w*w, w*w] index into the (2w-1)^2 bias table (timm/swin layout)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C]."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(x: torch.Tensor, w: int, h: int, ww: int
                    ) -> torch.Tensor:
    b = x.shape[0] // (h // w * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Wrap-around mask for SW-MSA: [nW, w*w, w*w] additive (0 / -100)."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    windows = _window_partition(torch.from_numpy(img), window).numpy()
    windows = windows.reshape(-1, window * window)
    mask = windows[:, None, :] - windows[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))

    def forward(self, windows: torch.Tensor, amask) -> torch.Tensor:
        nwin, ww, d = windows.shape
        q, k, v = self.qkv(windows).view(
            nwin, ww, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        idx = torch.from_numpy(relative_position_index(self.window)
                               .reshape(-1)).to(windows.device)
        bias = self.relative_position_bias_table[idx].reshape(
            ww, ww, self.heads).permute(2, 0, 1)[None].float()
        if amask is not None:  # [nW, ww, ww]: per window of every image
            nw = amask.shape[0]
            bias = (bias + amask[:, None]).repeat(nwin // nw, 1, 1, 1)
        return self.proj(merge_heads(plain_attention(q, k, v, bias)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = TimmMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, d = x.shape
        win, s = self.window, self.shift
        hn = self.norm1(x)
        amask = None
        if s:
            hn = torch.roll(hn, (-s, -s), dims=(1, 2))
            amask = torch.from_numpy(shift_attn_mask(h, w, win, s)).to(
                x.device)
        o = self.attn(_window_partition(hn, win), amask)
        o = _window_reverse(o, win, h, w)
        if s:
            o = torch.roll(o, (s, s), dims=(1, 2))
        x = x + o
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int):
        super().__init__()
        dim = cfg.embed_dim * 2 ** stage
        self.blocks = nn.Sequential(*(
            SwinBlock(dim, cfg.heads[stage], cfg.window,
                      0 if i % 2 == 0 else cfg.window // 2, cfg.mlp_ratio)
            for i in range(cfg.depths[stage])))
        if stage < len(cfg.depths) - 1:
            self.downsample = PatchMerging(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.blocks(x)
        return self.downsample(x) if hasattr(self, "downsample") else x


class SwinPatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              cfg.patch_size)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)


class SwinTrunk(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.patch_embed = SwinPatchEmbed(cfg)
        self.layers = nn.Sequential(*(SwinStage(cfg, s)
                                      for s in range(len(cfg.depths))))
        self.norm = nn.LayerNorm(cfg.num_features, eps=LN_EPS)


class SwinTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, out_dim], tokens [B, HW, C])."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = SwinTrunk(cfg)
        self.head = LinearHead(cfg.num_features, cfg.out_dim)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t, p = self.trunk, self.cfg.patch_size
        b, hh, ww, _ = images.shape
        x = conv_patchify(images, t.patch_embed.proj)
        x = t.patch_embed.norm(x).reshape(b, hh // p, ww // p, -1)
        x = t.layers(x)
        tokens = t.norm(x.reshape(b, -1, x.shape[-1]))
        return self.head(tokens.mean(dim=1)), tokens
