"""Vision Transformer tower (counterpart of ``clip_embeds_tpu/models/vit.py``).

patchify -> [CLS; patches] + learned pos embed -> ln_pre -> pre-LN blocks
-> ln_post -> pool -> projection. Images are channels-last [B, S, S, 3].
Patchify is a reshape plus one matmul against ``conv1.weight`` ([W, 3, p, p],
the open_clip stride-p conv) flattened in (kh, kw, cin) order: the same math
as the conv. The tower computes in ``compute_dtype`` (default: its
parameters' dtype), as flax's ``dtype`` over fp32 params: the patch kernel,
class and positional embeddings and the projection are cast to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import VisionConfig
from .layers import LayerNorm, Remat, Transformer
from .quant import Quant


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, gh*gw, p*p*C] with (ph, pw, c) minor ordering.

    Non-divisible sizes crop the bottom/right remainder (Conv2d valid
    padding)."""
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images[:, : gh * p, : gw * p]
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def patch_weight(conv1_weight: torch.Tensor) -> torch.Tensor:
    """conv1.weight [W, C, p, p] -> [W, p*p*C] in patchify's order."""
    w = conv1_weight
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig, embed_dim: int,
                 quick_gelu: bool = False, quant: Quant = False,
                 block_impl: str = "composable", remat: Remat = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.tower != "vit":
            raise NotImplementedError(f"tower {cfg.tower!r} is not ported")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        w, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, w, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.num_patches + 1, w))
        self.ln_pre = None if cfg.no_ln_pre else LayerNorm(w)
        self.transformer = Transformer(w, cfg.layers, cfg.heads,
                                       cfg.mlp_ratio, quick_gelu, quant,
                                       block_impl, remat)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, embed_dim))

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> ln_pre([CLS; patches] + pos), [B, 1+N, W]."""
        dtype = self.compute_dtype or self.proj.dtype
        x = patchify(images.to(dtype), self.cfg.patch_size)
        x = torch.matmul(x, patch_weight(self.conv1.weight).to(dtype).t())
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        return x if self.ln_pre is None else self.ln_pre(x)

    def forward(
        self, images: torch.Tensor, hidden_layer: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, N, W]).

        With ``hidden_layer`` (e.g. -2) returns the raw hidden states
        [B, 1+N, W] after that block (no ln_post, no projection)."""
        x = self.embed(images)
        if hidden_layer is not None:
            return self.transformer(
                x, num_blocks=self.cfg.layers + 1 + hidden_layer)
        x = self.transformer(x)
        if self.cfg.final_ln_after_pool:
            pooled, tokens = self.pool(x)
            pooled = self.ln_post(pooled)
        else:
            pooled, tokens = self.pool(self.ln_post(x))
        return pooled @ self.proj.to(pooled.dtype), tokens

    def pool(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.cfg.pool_type == "avg":
            return x[:, 1:].mean(dim=1), x[:, 1:]
        if self.cfg.pool_type == "tok":
            return x[:, 0], x[:, 1:]
        return x, x
