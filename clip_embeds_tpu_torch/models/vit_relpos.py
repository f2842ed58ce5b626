"""Relative-position ViT tower, timm ``vit_relpos_medium_patch16_cls_224``
(counterpart of ``clip_embeds_tpu/models/vit_relpos.py``).

Patchify conv (k16 s16, bias), a class token and no absolute pos embed;
every block carries its own RelPosMlp ('cr' mode): a 2 -> 256 -> heads ReLU
MLP over sign(c) * log1p(|c|) relative coordinates, gathered into a per-head
[N, N] additive bias with a zero row and column for the class token.
Pre-LN blocks with a bias-less fused qkv, LayerScale on both branches, GELU
MLP; final LN, token pooling, ``head.proj`` (no bias). The additive bias
keeps attention plain (fp32 logits), as in JAX. Module names are open_clip's
``visual.trunk.*`` (timm) and ``visual.head.proj``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, run_blocks, tower_dtype
from .quant import CastLinear
from .timm_vit import (
    LN_EPS,
    LinearHead,
    PatchEmbed,
    TimmAttention,
    TimmMlp,
)


@dataclasses.dataclass(frozen=True)
class RelPosViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 512
    depth: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    rel_pos_hidden: int = 256  # timm rel_pos_dim
    layer_scale_init: float = 1e-6
    embed_dim: int = 512


RELPOS_VIT_SHAPES = {
    "vit_relpos_medium_patch16_cls_224": RelPosViTConfig(),
}


def rel_log_coords(grid: int) -> np.ndarray:
    """timm gen_relative_log_coords mode='cr': sign(c) * log1p(|c|)."""
    r = np.arange(-(grid - 1), grid, dtype=np.float32)
    coords = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    return np.sign(coords) * np.log1p(np.abs(coords))  # (2g-1, 2g-1, 2)


def rel_position_index(grid: int) -> np.ndarray:
    """timm gen_relative_position_index: (N, N) gather index into the
    flattened (2g-1)*(2g-1) relative-distance table."""
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[..., 0] += grid - 1
    rel[..., 1] += grid - 1
    rel[..., 0] *= 2 * grid - 1
    return rel.sum(-1)


class RelPosMlpNet(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.fc1 = CastLinear(2, hidden)
        self.fc2 = CastLinear(hidden, heads)


class RelPosMlp(nn.Module):
    """The per-block bias table: fp32 throughout, as JAX's rel_fc1/rel_fc2
    (default-dtype Dense layers) compute it."""

    def __init__(self, grid: int, hidden: int, heads: int):
        super().__init__()
        self.grid, self.heads = grid, heads
        self.mlp = RelPosMlpNet(hidden, heads)

    def forward(self) -> torch.Tensor:
        dev = self.mlp.fc1.weight.device
        table = torch.from_numpy(rel_log_coords(self.grid)).to(dev)
        h = F.relu(F.linear(table, self.mlp.fc1.weight.float(),
                            self.mlp.fc1.bias.float()))
        tab = F.linear(h, self.mlp.fc2.weight.float(),
                       self.mlp.fc2.bias.float()).reshape(-1, self.heads)
        idx = torch.from_numpy(rel_position_index(self.grid).reshape(-1))
        n = self.grid * self.grid
        bias = tab[idx.to(dev)].reshape(n, n, self.heads).permute(2, 0, 1)
        return F.pad(bias, (1, 0, 1, 0))  # zero cls row / column


class RelPosAttention(TimmAttention):
    def __init__(self, dim: int, heads: int, grid: int, hidden: int):
        super().__init__(dim, heads, qkv_bias=False)
        self.rel_pos = RelPosMlp(grid, hidden, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x, self.rel_pos())


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class RelPosBlock(nn.Module):
    def __init__(self, cfg: RelPosViTConfig):
        super().__init__()
        d = cfg.width
        self.norm1 = LayerNorm(d, eps=LN_EPS)
        self.attn = RelPosAttention(d, cfg.heads,
                                    cfg.image_size // cfg.patch_size,
                                    cfg.rel_pos_hidden)
        self.ls1 = LayerScale(d)
        self.norm2 = LayerNorm(d, eps=LN_EPS)
        self.mlp = TimmMlp(d, int(d * cfg.mlp_ratio))
        self.ls2 = LayerScale(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class RelPosViTTrunk(nn.Module):
    def __init__(self, cfg: RelPosViTConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg.width, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.blocks = nn.ModuleList(RelPosBlock(cfg)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.width, eps=LN_EPS)


class RelPosViTTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, N, W]); the
    blocks compute in ``compute_dtype`` (default: the parameters'), each
    rematerialised with ``remat``, as :class:`~.timm_vit.TimmViTTower`."""

    def __init__(self, cfg: RelPosViTConfig, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg, self.remat, self.compute_dtype = cfg, remat, compute_dtype
        self.trunk = RelPosViTTrunk(cfg)
        self.head = LinearHead(cfg.width, cfg.embed_dim)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.trunk
        x = t.patch_embed(images.to(tower_dtype(self, self.compute_dtype)))
        cls = t.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = run_blocks(t.blocks, torch.cat([cls, x], dim=1), self.remat)
        x = t.norm(x)
        return self.head(x[:, 0]), x[:, 1:]
