"""ConvNeXt CLIP vision tower (counterpart of
``clip_embeds_tpu/models/convnext.py``): open_clip's timm ``convnext_*``
trunk with ``timm_pool ''`` (the trunk's global average pool) and a
``linear`` or ``mlp`` head.

stem: conv 4x4 stride 4 -> LayerNorm; stage i > 0 opens with LayerNorm ->
conv 2x2 stride 2; a block is a depthwise 7x7 conv -> LN -> Linear 4x ->
GELU -> Linear -> layer scale ``gamma`` -> residual; head: average pool ->
LayerNorm -> ``head.proj`` (no bias) or ``head.mlp`` (fc1 with bias, GELU,
fc2 without). Every norm has eps 1e-6. Module names are open_clip's
``visual.trunk.*`` (timm) and ``visual.head.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, run_blocks, tower_dtype
from .quant import CastLinear

EPS = 1e-6

# timm trunk shapes for the registry's convnext configs
CONVNEXT_SHAPES: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)
    embed_dim: int = 640
    proj: str = "linear"  # 'linear' | 'mlp' (timm_proj)
    image_size: int = 256


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (timm LayerNorm2d)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, bias2: bool = True):
        super().__init__()
        self.fc1 = CastLinear(dim, hidden)
        self.fc2 = CastLinear(hidden, out, bias=bias2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, 4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = self.conv_dw(x).permute(0, 2, 3, 1)
        h = self.mlp(self.norm(h)) * self.gamma.to(h.dtype)
        return x + h.permute(0, 3, 1, 2)


class ConvNeXtStage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, first: bool,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if not first:
            self.downsample = nn.Sequential(
                LayerNorm2d(cin, eps=EPS), Conv2d(cin, dim, 2, 2))
        self.blocks = nn.Sequential(*(ConvNeXtBlock(dim)
                                      for _ in range(depth)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return run_blocks(self.blocks, x, self.remat)


class HeadNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=EPS)


class ConvNeXtTrunk(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig, remat: bool = False):
        super().__init__()
        d0 = cfg.dims[0]
        self.stem = nn.Sequential(Conv2d(3, d0, 4, 4),
                                  LayerNorm2d(d0, eps=EPS))
        cins = (d0,) + tuple(cfg.dims[:-1])
        self.stages = nn.Sequential(*(
            ConvNeXtStage(cin, dim, depth, i == 0, remat)
            for i, (cin, dim, depth)
            in enumerate(zip(cins, cfg.dims, cfg.depths))))
        self.head = HeadNorm(cfg.dims[-1])


class ConvNeXtHead(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        if cfg.proj == "linear":
            self.proj = CastLinear(cfg.dims[-1], cfg.embed_dim, bias=False)
        elif cfg.proj == "mlp":
            self.mlp = Mlp(cfg.dims[-1], 2 * cfg.embed_dim, cfg.embed_dim,
                           bias2=False)
        else:
            raise ValueError(f"unknown proj {cfg.proj!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x) if hasattr(self, "proj") else self.mlp(x)


class ConvNeXtTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, embed_dim], final-stage tokens
    [B, HW, C]); the tower computes in ``compute_dtype`` (default: the
    parameters'), each block rematerialised with ``remat``, as JAX's."""

    def __init__(self, cfg: ConvNeXtConfig, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.trunk = ConvNeXtTrunk(cfg, remat)
        self.head = ConvNeXtHead(cfg)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.trunk
        x = images.to(tower_dtype(self, self.compute_dtype)).permute(
            0, 3, 1, 2)
        x = t.stages(t.stem(x))
        tokens = x.flatten(2).transpose(1, 2)
        pooled = t.head.norm(x.mean(dim=(2, 3)))
        return self.head(pooled), tokens
