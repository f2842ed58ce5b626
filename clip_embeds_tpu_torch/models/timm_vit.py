"""Plain timm VisionTransformer tower for timm-named CLIP configs
(counterpart of ``clip_embeds_tpu/models/timm_vit.py``), and the timm
pieces the other timm trunks share.

``vit_medium_patch16_gap_256``: width 512, depth 12, heads 8, no class
token, global average pool with a post-pool ``fc_norm``, learned pos embed
over the 16x16 patch grid, biased conv patchify, pre-LN blocks (fused qkv
with bias, GELU MLP, LN eps 1e-6), head ``Linear(512, embed_dim,
bias=False)``. Module names are open_clip's ``visual.trunk.*`` (timm) and
``visual.head.proj``, so an open_clip state dict loads with
``load_state_dict``. Attention is plain (fp32 logits and softmax), as JAX
computes it with an einsum: no kernel on this tower.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .vit import patch_weight, patchify

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TimmViTConfig:
    image_size: int = 256
    patch_size: int = 16
    width: int = 512
    depth: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    class_token: bool = False
    pool: str = "avg"          # 'avg' | 'token'
    fc_norm: bool = True       # LN after pooling (timm use_fc_norm)
    embed_dim: int = 512       # CLIP projection dim


TIMM_VIT_SHAPES = {
    "vit_medium_patch16_gap_256": TimmViTConfig(),
}


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, N, D] attention as JAX's einsum towers compute it: fp32
    logits scaled by D^-1/2 (plus an fp32 additive ``bias``), fp32 softmax,
    the probabilities cast to v's dtype before P.V."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.view(b, n, heads, d // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def conv_patchify(images: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """[B, S, S, 3] -> [B, N, W]: a stride-p conv as patchify + one matmul
    in JAX's (kh, kw, cin) order, in the conv's dtype."""
    x = patchify(images.to(conv.weight.dtype), conv.kernel_size[0])
    return F.linear(x, patch_weight(conv.weight), conv.bias)


class PatchEmbed(nn.Module):
    """timm ``patch_embed.proj``: the biased stride-p conv."""

    def __init__(self, width: int, patch: int, bias: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, patch, bias=bias)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return conv_patchify(images, self.proj)


class TimmAttention(nn.Module):
    """timm ``Attention``: fused ``qkv`` and ``proj``, plain attention."""

    def __init__(self, dim: int, heads: int, qkv_bias: bool = True):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, d // self.heads) \
            .permute(2, 0, 3, 1, 4)
        return self.proj(merge_heads(plain_attention(q, k, v, bias)))


class TimmMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class TimmBlock(nn.Module):
    """timm pre-LN ViT block (``norm1``, ``attn``, ``norm2``, ``mlp``)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float,
                 eps: float = LN_EPS):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = TimmAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = TimmMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class LinearHead(nn.Module):
    """open_clip TimmModel's ``head.proj`` (no bias)."""

    def __init__(self, width: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(width, embed_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class TimmViTTrunk(nn.Module):
    def __init__(self, cfg: TimmViTConfig):
        super().__init__()
        self.cfg = cfg
        n = (cfg.image_size // cfg.patch_size) ** 2 + int(cfg.class_token)
        self.patch_embed = PatchEmbed(cfg.width, cfg.patch_size)
        if cfg.class_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.empty(1, n, cfg.width))
        self.blocks = nn.ModuleList(
            TimmBlock(cfg.width, cfg.heads, cfg.mlp_ratio)
            for _ in range(cfg.depth))
        if cfg.fc_norm:
            self.fc_norm = nn.LayerNorm(cfg.width, eps=LN_EPS)
        else:
            self.norm = nn.LayerNorm(cfg.width, eps=LN_EPS)


class TimmViTTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, N, W])."""

    def __init__(self, cfg: TimmViTConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = TimmViTTrunk(cfg)
        self.head = LinearHead(cfg.width, cfg.embed_dim)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, t = self.cfg, self.trunk
        x = t.patch_embed(images)
        if cfg.class_token:
            x = torch.cat([t.cls_token.to(x.dtype).expand(x.shape[0], -1, -1),
                           x], dim=1)
        x = x + t.pos_embed.to(x.dtype)
        for block in t.blocks:
            x = block(x)
        if not cfg.fc_norm:
            x = t.norm(x)
        tokens = x[:, 1:] if cfg.class_token else x
        pooled = tokens.mean(dim=1) if cfg.pool == "avg" else x[:, 0]
        if cfg.fc_norm:
            pooled = t.fc_norm(pooled)
        return self.head(pooled), tokens
