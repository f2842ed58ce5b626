"""BLIP-1 ViT tower + med text encoder, and the ImageReward scorer
(counterpart of ``clip_embeds_tpu/models/blip.py``).

The BLIP ``visual_encoder`` (timm-style ViT-L/16: a biased patchify, CLS
and positional embeddings, pre-LN blocks at LayerNorm eps 1e-6 whose
attention takes the flash kernel in bf16 on the card, a final LN) feeds a
med BertModel (BERT whose every layer has image cross-attention); the CLS
hidden state goes through ImageReward's activation-free MLP chain (768 ->
1024 -> 128 -> 64 -> 16 -> 1) and is standardised by the checkpoint's
mean and std. The BERT blocks are ``models/blip2.py``'s post-LN attention
and FFN (plain attention, as in JAX). Module names are the flax ones
(``visual_encoder.patch_embed``, ``cls_token``, ``pos_embed``,
``blocks.resblocks.{i}``, ``norm``; ``text_encoder.layer.{i}``;
``mlp.{i}`` for ``mlp_{i}``). The HF-layout converters are in
``core/convert.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..core.config import VisionConfig
from .blip2 import BertFFN, BertSelfAttention
from .layers import LayerNorm, Transformer
from .quant import linear
from .vit import patchify

REWARD_DIMS = (1024, 128, 64, 16, 1)


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524          # BLIP adds [DEC]/[ENC] tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=16, width=1024, layers=24,
            head_width=64,
        )
    )
    text: BlipTextConfig = dataclasses.field(default_factory=BlipTextConfig)


class BlipVisionTower(nn.Module):
    """timm-style ViT returning every post-norm hidden state [B, 1+N, W]."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.width, cfg.patch_size
        self.patch_embed = linear(False, p * p * 3, w)
        self.cls_token = nn.Parameter(torch.zeros(w))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches + 1, w))
        self.blocks = Transformer(w, cfg.layers, cfg.heads, cfg.mlp_ratio,
                                  quick_gelu=False, ln_eps=1e-6)
        self.norm = LayerNorm(w, eps=1e-6)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self.cls_token.dtype
        x = self.patch_embed(patchify(images.to(dtype), self.cfg.patch_size))
        cls = self.cls_token.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        return self.norm(self.blocks(x))


class BlipTextLayer(nn.Module):
    """med BertLayer in encoder mode: self-attention, image
    cross-attention and the FFN, each a post-LN residual block."""

    def __init__(self, cfg: BlipTextConfig, encoder_width: int):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(d, cfg.num_heads, eps)
        self.crossattention = BertSelfAttention(d, cfg.num_heads, eps,
                                                encoder_width)
        self.ffn = BertFFN(d, cfg.intermediate_size, eps)

    def forward(self, hidden: torch.Tensor,
                image_embeds: Optional[torch.Tensor],
                self_mask: Optional[torch.Tensor]) -> torch.Tensor:
        hidden = self.attention(hidden, mask=self_mask)
        if image_embeds is not None:
            hidden = self.crossattention(hidden, kv=image_embeds)
        return self.ffn(hidden)


class BlipTextEncoder(nn.Module):
    """med BertModel (encoder mode): embeddings and the cross-attending
    layers; ``encoder_width`` is the vision tower's."""

    def __init__(self, cfg: BlipTextConfig, encoder_width: int):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                d)
        self.embeddings_ln = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layer = nn.ModuleList(BlipTextLayer(cfg, encoder_width)
                                   for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor,
                image_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.embeddings_ln(self.word_embeddings(input_ids)
                               + self.position_embeddings(pos)[None])
        self_mask = (None if attention_mask is None
                     else attention_mask.bool()[:, None, None, :])
        for layer in self.layer:
            x = layer(x, image_embeds, self_mask)
        return x


class ImageReward(nn.Module):
    """BLIP backbone + the activation-free MLP reward head, standardised
    (ImageReward-v1.0's mean and std by default)."""

    def __init__(self, cfg: BlipConfig, mean: float = 0.16717362830052426,
                 std: float = 1.0333394966054072):
        super().__init__()
        self.cfg, self.mean, self.std = cfg, mean, std
        self.visual_encoder = BlipVisionTower(cfg.vision)
        self.text_encoder = BlipTextEncoder(cfg.text, cfg.vision.width)
        dims = (cfg.text.hidden_size,) + REWARD_DIMS
        self.mlp = nn.ModuleList(linear(False, a, b)
                                 for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Standardised reward scores [B]."""
        image_embeds = self.visual_encoder(pixel_values)
        x = self.text_encoder(input_ids, image_embeds, attention_mask)[:, 0]
        for layer in self.mlp:
            x = layer(x)
        return (x[:, 0] - self.mean) / self.std
