"""Dual-tower CLIP (counterpart of ``clip_embeds_tpu/models/clip.py``), ViT
vision tower only for now.

Parameter names are open_clip's (``open_clip/model.py`` CLIP): the vision
tower under ``visual.``, the text tower's modules at top level, so an
open_clip state dict loads with ``load_state_dict``. ``quant`` ('dynamic' /
'static') builds both towers' block projections as int8 QuantLinear (the
W8A8 serving path, ``models/quant.py``). ``block_impl`` and ``remat`` go to
both towers' transformers (the training routes, ``models/layers.py``);
``compute_dtype`` (default: the parameters' dtype) is the dtype the towers
compute in, so fp32 master weights can train in bf16.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core.config import CLIPConfig
from .layers import Remat
from .quant import Quant
from .text_transformer import TextTransformer, encode_text_tower
from .vit import VisionTransformer


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp_min(eps)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, quant: Quant = False,
                 block_impl: str = "composable", remat: Remat = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.visual = VisionTransformer(cfg.vision, cfg.embed_dim,
                                        cfg.quick_gelu, quant, block_impl,
                                        remat, compute_dtype)
        text = TextTransformer(cfg.text, cfg.embed_dim, cfg.quick_gelu, quant,
                               block_impl, remat, compute_dtype)
        # open_clip keeps the text tower's modules at top level
        self.token_embedding = text.token_embedding
        self.positional_embedding = text.positional_embedding
        self.transformer = text.transformer
        self.ln_final = text.ln_final
        self.text_projection = text.text_projection
        self.logit_scale = nn.Parameter(
            torch.tensor(float(cfg.init_logit_scale)))
        self.logit_bias = (None if cfg.init_logit_bias is None else
                           nn.Parameter(torch.tensor(cfg.init_logit_bias)))

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     output_tokens: bool = False, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None):
        """images [B, S, S, 3] -> [B, embed_dim] (and tokens).
        ``deterministic=False`` (the train step's) drops patches where the
        config has patch dropout, drawn from ``generator``; eval and
        serving never drop patches."""
        pooled, tokens = self.visual(images, deterministic=deterministic,
                                     generator=generator)
        if normalize:
            pooled = l2_normalize(pooled)
        return (pooled, tokens) if output_tokens else pooled

    def encode_text(self, text_ids: torch.Tensor, normalize: bool = False,
                    output_tokens: bool = False):
        """int [B, ctx] -> [B, embed_dim] (and tokens)."""
        pooled, tokens = encode_text_tower(self, self.cfg.text, text_ids)
        if normalize:
            pooled = l2_normalize(pooled)
        return (pooled, tokens) if output_tokens else pooled

    def forward(self, images: Optional[torch.Tensor] = None,
                text_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        out = {"logit_scale": self.logit_scale.exp()}
        if images is not None:
            out["image_features"] = self.encode_image(
                images, normalize=True, deterministic=deterministic,
                generator=generator)
        if text_ids is not None:
            out["text_features"] = self.encode_text(text_ids, normalize=True)
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out

    def get_logits(self, images: torch.Tensor, text_ids: torch.Tensor):
        """(logits_per_image, logits_per_text)."""
        img = self.encode_image(images, normalize=True)
        txt = self.encode_text(text_ids, normalize=True)
        logits = self.logit_scale.exp() * img @ txt.t()
        if self.logit_bias is not None:
            logits = logits + self.logit_bias
        return logits, logits.t()
