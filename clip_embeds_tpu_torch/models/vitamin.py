"""ViTamin vision tower, timm ``vitamin_*`` (counterpart of
``clip_embeds_tpu/models/vitamin.py``): a 3-stage hybrid.

stem: conv3x3 s2 -> LN + GELU -> conv3x3 (stride 2); two MbConvLN stages
(each opens with a stride-2 block; stride 8); LN -> conv3x3 s2 to the ViT
width (stride 16); ViT blocks with a fused qkv and a GeGLU MLP (LN ->
gelu(w0 x) * w1 x -> w2, hidden 2 x width) over a learned pos embed and no
class token; mean pool -> ``fc_norm`` -> ``head.proj`` (no bias).
MbConvLN block: pre-LN -> 1x1 expand (x4) -> GELU -> 3x3 depthwise (stride
on it) -> GELU -> 1x1 project, plus the identity, a 1x1 conv, or (striding)
an exclusive 3x3 s2 average pool and a 1x1 conv. LN eps 1e-6, attention
plain as JAX's einsum. Module names are open_clip's ``visual.trunk.*``
(timm: ``patch_embed.backbone.{stem,stages,pool}``, ``pos_embed``,
``blocks``, ``fc_norm``) and ``visual.head.proj``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .convnext import LayerNorm2d
from .timm_vit import LinearHead, TimmAttention

LN_EPS = 1e-6

# timm_model_name -> (mbconv dims (c1, c2), mbconv depths, vit width,
#                     vit depth, vit heads)
VITAMIN_SHAPES = {
    "vitamin_small": ((64, 128), (2, 4), 384, 14, 6),
    "vitamin_base": ((128, 256), (2, 4), 768, 14, 12),
    "vitamin_large": ((160, 320), (2, 4), 1024, 31, 16),
    "vitamin_large2": ((160, 320), (2, 4), 1024, 31, 16),
    "vitamin_xlarge": ((192, 384), (2, 4), 1152, 32, 16),
}


@dataclasses.dataclass(frozen=True)
class VitaminConfig:
    image_size: int = 224
    mbconv_dims: Tuple[int, int] = (160, 320)
    mbconv_depths: Tuple[int, int] = (2, 4)
    width: int = 1024          # stage-3 / token dim
    depth: int = 31
    heads: int = 16
    mlp_ratio: float = 2.0     # GeGLU hidden = width * mlp_ratio
    embed_dim: int = 768       # CLIP projection dim

    @property
    def grid_size(self) -> int:
        return self.image_size // 16


def vitamin_config(timm_name: str, image_size: int,
                   embed_dim: int) -> VitaminConfig:
    base = "_".join(timm_name.split("_")[:2])  # vitamin_<scale>
    dims, depths, width, depth, heads = VITAMIN_SHAPES[base]
    return VitaminConfig(
        image_size=image_size, mbconv_dims=dims, mbconv_depths=depths,
        width=width, depth=depth, heads=heads, embed_dim=embed_dim,
    )


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2,
                     groups=groups)


class Downsample2d(nn.Module):
    """timm's stride-2 shortcut: an exclusive 3x3 s2 average pool, then an
    ``expand`` 1x1 conv where the width changes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        if cin != cout:
            self.expand = _conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return self.expand(x) if hasattr(self, "expand") else x


class MbConvLNBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 expand_ratio: float = 4.0):
        super().__init__()
        mid = int(cout * expand_ratio)
        if stride == 2:
            self.shortcut = Downsample2d(cin, cout)
        elif cin != cout:
            self.shortcut = _conv(cin, cout, 1)
        else:
            self.shortcut = None
        self.pre_norm = LayerNorm2d(cin, eps=LN_EPS)
        self.conv1_1x1 = _conv(cin, mid, 1)
        self.conv2_kxk = _conv(mid, mid, 3, stride, groups=mid)
        self.conv3_1x1 = _conv(mid, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        h = F.gelu(self.conv1_1x1(self.pre_norm(x)))
        h = F.gelu(self.conv2_kxk(h))
        return self.conv3_1x1(h) + shortcut


class Stem(nn.Module):
    def __init__(self, c1: int):
        super().__init__()
        self.conv1 = _conv(3, c1, 3, 2)
        self.norm1 = LayerNorm2d(c1, eps=LN_EPS)
        self.conv2 = _conv(c1, c1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.gelu(self.norm1(self.conv1(x))))


class StridedConv(nn.Module):
    def __init__(self, cin: int, width: int):
        super().__init__()
        self.norm = LayerNorm2d(cin, eps=LN_EPS)
        self.proj = _conv(cin, width, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.norm(x))


class ConvBackbone(nn.Module):
    def __init__(self, cfg: VitaminConfig):
        super().__init__()
        c1 = cfg.mbconv_dims[0]
        self.stem = Stem(c1)
        stages, cin = [], c1
        for chs, depth in zip(cfg.mbconv_dims, cfg.mbconv_depths):
            stages.append(nn.Sequential(*(
                MbConvLNBlock(cin if i == 0 else chs, chs,
                              2 if i == 0 else 1) for i in range(depth))))
            cin = chs
        self.stages = nn.Sequential(*stages)
        self.pool = StridedConv(cin, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pool(self.stages(self.stem(x)))


class HybridEmbed(nn.Module):
    def __init__(self, cfg: VitaminConfig):
        super().__init__()
        self.backbone = ConvBackbone(cfg)


class GeGluMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.w0 = nn.Linear(dim, hidden)
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        return self.w2(F.gelu(self.w0(h)) * self.w1(h))


class VitaminBlock(nn.Module):
    """timm Block: norm2 before the MLP, and GeGluMlp's own inner norm."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = TimmAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = GeGluMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VitaminTrunk(nn.Module):
    def __init__(self, cfg: VitaminConfig):
        super().__init__()
        n = cfg.grid_size ** 2
        self.patch_embed = HybridEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.empty(1, n, cfg.width))
        self.blocks = nn.ModuleList(
            VitaminBlock(cfg.width, cfg.heads, cfg.mlp_ratio)
            for _ in range(cfg.depth))
        self.fc_norm = nn.LayerNorm(cfg.width, eps=LN_EPS)


class VitaminTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, N, W])."""

    def __init__(self, cfg: VitaminConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = VitaminTrunk(cfg)
        self.head = LinearHead(cfg.width, cfg.embed_dim)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.trunk
        x = images.to(t.pos_embed.dtype).permute(0, 3, 1, 2)
        x = t.patch_embed.backbone(x).flatten(2).transpose(1, 2)
        x = x + t.pos_embed.to(x.dtype)
        for block in t.blocks:
            x = block(x)
        return self.head(t.fc_norm(x.mean(dim=1))), x
