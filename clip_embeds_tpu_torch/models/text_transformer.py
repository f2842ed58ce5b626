"""Causal text tower (counterpart of
``clip_embeds_tpu/models/text_transformer.py``).

token embed + learned pos embed -> causal pre-LN blocks -> ln_final ->
argmax (EOT) pooling -> projection. Padding is not masked in attention:
CLIP never does. The tower computes in ``compute_dtype`` (default: its
parameters' dtype): the embeddings and the projection are cast to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import TextConfig
from .layers import LayerNorm, Remat, Transformer
from .quant import Quant


def text_global_pool(x: torch.Tensor, text_ids: torch.Tensor,
                     pool_type: str = "argmax"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool token features; 'argmax' picks the EOT position (highest id)."""
    if pool_type == "first":
        return x[:, 0], x[:, 1:]
    if pool_type == "last":
        return x[:, -1], x[:, :-1]
    if pool_type == "argmax":
        eot = text_ids.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot], x
    return x, x


def encode_text_tower(tower, cfg: TextConfig, text_ids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the text tower held by ``tower``, any module with the open_clip
    text attributes (``token_embedding``, ``positional_embedding``,
    ``transformer``, ``ln_final``, ``text_projection``) and a
    ``compute_dtype``: a :class:`TextTransformer`, or a CLIP, which keeps
    them at top level."""
    dtype = tower.compute_dtype or tower.text_projection.dtype
    x = tower.token_embedding(text_ids).to(dtype)
    x = x + tower.positional_embedding[: x.shape[1]].to(dtype)
    x = tower.transformer(x, causal=not cfg.no_causal_mask)
    x = tower.ln_final(x)
    pooled, tokens = text_global_pool(x, text_ids, cfg.pool_type)
    return pooled @ tower.text_projection.to(dtype), tokens


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig, embed_dim: int,
                 quick_gelu: bool = False, quant: Quant = False,
                 block_impl: str = "composable", remat: Remat = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.width))
        self.transformer = Transformer(cfg.width, cfg.layers, cfg.heads,
                                       cfg.mlp_ratio, quick_gelu, quant,
                                       block_impl, remat)
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.width, embed_dim))

    def forward(self, text_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """int [B, ctx] -> (pooled [B, embed_dim], tokens [B, ctx, W])."""
        return encode_text_tower(self, self.cfg, text_ids)
