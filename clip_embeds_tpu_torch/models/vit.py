"""Vision Transformer tower (counterpart of ``clip_embeds_tpu/models/vit.py``).

patchify -> [CLS; patches] + learned pos embed -> ln_pre -> pre-LN blocks
-> ln_post -> pool -> projection. Images are channels-last [B, S, S, 3].
Patchify is a reshape plus one matmul against ``conv1.weight`` ([W, 3, p, p],
the open_clip stride-p conv) flattened in (kh, kw, cin) order: the same math
as the conv. The tower computes in ``compute_dtype`` (default: its
parameters' dtype), as flax's ``dtype`` over fp32 params: the patch kernel,
class and positional embeddings and the projection are cast to it.

FLIP patch dropout (``cfg.patch_dropout`` > 0, train time only) keeps
``max(1, int(n_patches * (1 - p)))`` patch tokens a sample and always the
CLS token, between the positional embedding and ``ln_pre``, as the JAX
tower does. Also here: :func:`interpolate_pos_embed` (JAX's
``jax.image.resize`` bilinear, antialiased where it shrinks) and
:func:`sincos_2d_pos_embed`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
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


def patches_kept(n_patches: int, patch_dropout: float) -> int:
    """Patch tokens a sample keeps under patch dropout ``patch_dropout``
    (all of them at 0)."""
    if patch_dropout <= 0.0:
        return n_patches
    return max(1, int(n_patches * (1.0 - patch_dropout)))


def interpolate_pos_embed(pos_embed: torch.Tensor, old_grid: int,
                          new_grid: int) -> torch.Tensor:
    """Resample the patch grid of a [1+N, D] positional embedding to
    ``new_grid`` x ``new_grid``; the CLS row stays (PACL's 14 -> 25 grid).
    ``jax.image.resize(..., "bilinear")`` antialiases where it shrinks:
    its triangle kernel widens by the shrink factor, normalised over the
    cells inside the grid. ``F.interpolate``'s bilinear with
    ``antialias=True`` computes the same weights both ways (up, they are
    plain bilinear); without it, a shrink samples only the two nearest
    cells. fp32 sums, returned in ``pos_embed``'s dtype."""
    cls_pe, patch_pe = pos_embed[:1], pos_embed[1:]
    d = patch_pe.shape[-1]
    grid = patch_pe.float().reshape(1, old_grid, old_grid, d).permute(
        0, 3, 1, 2)
    grid = F.interpolate(grid, size=(new_grid, new_grid), mode="bilinear",
                         align_corners=False, antialias=True)
    grid = grid[0].permute(1, 2, 0).reshape(new_grid * new_grid, d)
    return torch.cat([cls_pe, grid.to(pos_embed.dtype)], dim=0)


def sincos_2d_pos_embed(width: int, grid_size: int,
                        cls_token: bool = True) -> torch.Tensor:
    """Fixed 2D sin-cos positional embedding [(1+)N, width], fp32
    (open_clip's ``get_2d_sincos_pos_embed``, MoCo-v3 layout): the first
    half of the channels encodes the column, the second half the row, each
    as the sines then the cosines of the scaled inverse frequencies; a zero
    CLS row first with ``cls_token``."""
    assert width % 4 == 0
    quarter = width // 4
    omega = 1.0 / (10000.0 ** (torch.arange(quarter, dtype=torch.float32)
                               / quarter))
    pos = torch.arange(grid_size, dtype=torch.float32)
    grid_col = pos.repeat(grid_size)
    grid_row = pos.repeat_interleave(grid_size)

    def encode(coords):
        angles = torch.outer(coords, omega)
        return torch.cat([angles.sin(), angles.cos()], dim=1)

    embed = torch.cat([encode(grid_col), encode(grid_row)], dim=1)
    if cls_token:
        embed = torch.cat([torch.zeros(1, width), embed], dim=0)
    return embed


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

    def tokens(self, images: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> [CLS; patches] + pos, [B, 1+N, W]."""
        dtype = self.compute_dtype or self.class_embedding.dtype
        x = patchify(images.to(dtype), self.cfg.patch_size)
        x = torch.matmul(x, patch_weight(self.conv1.weight).to(dtype).t())
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)

    def forward(
        self, images: torch.Tensor, hidden_layer: Optional[int] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        keep_idx: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, N, W]).

        With ``hidden_layer`` (e.g. -2) returns the raw hidden states
        [B, 1+N, W] after that block (no ln_post, no projection).

        ``deterministic=False`` turns on patch dropout where
        ``cfg.patch_dropout`` > 0: uniform noise [B, n_patches] from
        ``generator``, its top-k, and the kept patches gathered in top-k
        order (not by position), as the JAX tower draws them. torch cannot
        reproduce ``jax.random``'s bits, so ``keep_idx`` [B, keep] (indices
        into the patches) may be given in place of the draw: a test feeds
        it the indices JAX drew."""
        x = self.tokens(images)
        if not deterministic and self.cfg.patch_dropout > 0.0:
            if keep_idx is None:
                noise = torch.rand(x.shape[0], x.shape[1] - 1,
                                   generator=generator, device=x.device)
                keep = patches_kept(x.shape[1] - 1, self.cfg.patch_dropout)
                keep_idx = noise.topk(keep, dim=1).indices
            patches = torch.gather(
                x[:, 1:], 1, keep_idx[..., None].expand(-1, -1, x.shape[-1]))
            x = torch.cat([x[:, :1], patches], dim=1)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
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
