"""MobileCLIP-B vision tower, timm ``vit_base_mci_224`` (counterpart of
``clip_embeds_tpu/models/mci_vit.py``).

A conv stem of kernels (4, 2, 2) equal to their strides, padding 0:
3 -> 192 (BN + GELU), 192 -> 192 (BN + GELU), 192 -> 768 (bias), so a 14 x 14
token grid at 224 px; a learned pos embed over the patch tokens only, the
class token prepended after it (timm ``no_embed_class``); 12 pre-LN ViT-B
blocks (eps 1e-6, plain attention as JAX's einsum); final LN, token pooling
and the trunk's ``head`` Linear(768 -> 512, bias) as the projection.

Module names are open_clip's ``visual.trunk.*``, the timm training layout
(stem ``patch_embed.backbone.{0,1,2}.conv`` / ``.bn``), so an open_clip
MobileCLIP-B checkpoint loads unchanged. At load (:meth:`load_state_dict`
and every path through it) the stem BatchNorms are folded into their convs
as JAX's converter folds them (``fold_bn_conv``), and the tower keeps the
folded convs, so it holds the weights JAX serves.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, run_blocks, tower_dtype
from .quant import CastLinear
from .timm_vit import LN_EPS, TimmBlock


@dataclasses.dataclass(frozen=True)
class MCiViTConfig:
    image_size: int = 224
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    embed_dim: int = 512

    @property
    def stem_dims(self) -> Tuple[int, int, int]:
        return (self.width // 4, self.width // 4, self.width)


MCI_VIT_SHAPES = {
    "vit_base_mci_224": MCiViTConfig(),
}

_STEM_KERNELS = (4, 2, 2)  # == strides, padding 0 (timm ConvStem for mci)
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def fold_bn_conv(conv_w: torch.Tensor, conv_b, bn: Mapping[str, torch.Tensor],
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """An inference-mode BatchNorm folded into the conv before it ([out,
    in/g, kh, kw] and an optional bias -> the same kernel layout and a
    bias), in fp32 as JAX's numpy fold."""
    inv = bn["weight"].float() / torch.sqrt(bn["running_var"].float() + eps)
    w = conv_w.float() * inv[:, None, None, None]
    b = conv_b.float() if conv_b is not None else torch.zeros_like(inv)
    return w, (b - bn["running_mean"].float()) * inv + bn["bias"].float()


class StemConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, k, bias=True)


class StemEmbed(nn.Module):
    def __init__(self, cfg: MCiViTConfig):
        super().__init__()
        cins = (3,) + cfg.stem_dims[:-1]
        self.backbone = nn.Sequential(*(
            StemConv(ci, co, k) for ci, co, k in
            zip(cins, cfg.stem_dims, _STEM_KERNELS)))


class MCiViTTrunk(nn.Module):
    def __init__(self, cfg: MCiViTConfig):
        super().__init__()
        grid = cfg.image_size // 16
        self.patch_embed = StemEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid, cfg.width))
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.blocks = nn.ModuleList(
            TimmBlock(cfg.width, cfg.heads, cfg.mlp_ratio)
            for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.width, eps=LN_EPS)
        self.head = CastLinear(cfg.width, cfg.embed_dim)


def _fold_stem(module, state_dict, prefix, *args) -> None:
    """Load pre-hook: the timm stem's ``.bn`` entries folded into the conv
    before each (the folded ``conv.bias`` replaces any given)."""
    for i in range(2):
        pre = f"{prefix}patch_embed.backbone.{i}"
        if f"{pre}.bn.weight" not in state_dict:
            continue
        bn = {k: state_dict.pop(f"{pre}.bn.{k}") for k in _BN_KEYS}
        state_dict.pop(f"{pre}.bn.num_batches_tracked", None)
        w, b = fold_bn_conv(state_dict[f"{pre}.conv.weight"],
                            state_dict.get(f"{pre}.conv.bias"), bn)
        state_dict[f"{pre}.conv.weight"] = w
        state_dict[f"{pre}.conv.bias"] = b


class MCiViTTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, N, W]); the
    tower computes in ``compute_dtype`` (default: the parameters'), each
    block rematerialised with ``remat``, as
    :class:`~.timm_vit.TimmViTTower`."""

    def __init__(self, cfg: MCiViTConfig, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg, self.remat, self.compute_dtype = cfg, remat, compute_dtype
        self.trunk = MCiViTTrunk(cfg)
        self.trunk._register_load_state_dict_pre_hook(_fold_stem,
                                                     with_module=True)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.trunk
        x = images.to(tower_dtype(self, self.compute_dtype)).permute(
            0, 3, 1, 2)
        stem = t.patch_embed.backbone
        for i, s in enumerate(stem):
            x = s.conv(x)
            if i < len(stem) - 1:
                x = F.gelu(x)
        x = x.flatten(2).transpose(1, 2) + t.pos_embed.to(x.dtype)
        cls = t.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = run_blocks(t.blocks, torch.cat([cls, x], dim=1), self.remat)
        x = t.norm(x)
        return t.head(x[:, 0]), x[:, 1:]

