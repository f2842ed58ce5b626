"""Dual-tower CLIP (counterpart of ``clip_embeds_tpu/models/clip.py``).

The vision tower follows ``cfg.vision.tower`` as JAX's ``CLIP.setup`` does
(:func:`build_visual`): the ViT of ``models/vit.py``, or one of the zoo
towers (ModifiedResNet, EVA01 / EVA02, the timm and rel-pos ViTs, MCi-ViT,
Swin, ViTamin, FastViT, ConvNeXt), each returning (pooled, tokens) as its
JAX counterpart does. Parameter names are open_clip's (``open_clip/
model.py`` CLIP): the vision tower under ``visual.`` (``visual.trunk.*`` and
``visual.head.*`` for the timm trunks), the text tower's modules at top
level, so an open_clip state dict loads with ``load_state_dict``; a
CustomTextCLIP checkpoint's ``text.*`` keys (EVA, ViTamin) load too.
``quant`` ('dynamic' / 'static') builds both towers' block projections as
int8 QuantLinear (the W8A8 serving path, ``models/quant.py``); a zoo tower
takes none (JAX's ``--int8`` fails on them). ``block_impl`` (the fused
training blocks, ``models/layers.py``) goes to both towers of a ViT CLIP
and to the text tower alone of a zoo model, as in JAX; ``remat`` goes to
every tower but ModifiedResNet's, which takes none in JAX either.
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


def build_visual(cfg: CLIPConfig, remat: Remat = False,
                 compute_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The zoo vision tower of ``cfg`` (JAX ``models/clip.py:41-160``),
    computing in ``compute_dtype``; ``remat`` as JAX passes it (a policy
    string reaches EVA01's Transformer; the other towers rematerialise each
    block whole; ModifiedResNet takes none)."""
    v, e = cfg.vision, cfg.embed_dim
    kw = dict(remat=remat, compute_dtype=compute_dtype)
    if v.tower == "resnet":
        from .resnet import ModifiedResNet

        return ModifiedResNet(v.resnet_layers, e, v.width * 32 // 64,
                              v.image_size, v.width, compute_dtype)
    if v.tower == "eva":
        from .eva import EVAVisionTower

        return EVAVisionTower(v, e, **kw)
    if v.tower == "eva02":
        from .eva import EVA02VisionTower

        return EVA02VisionTower(v, e, **kw)
    if v.tower == "timm-vit":
        from .timm_vit import TimmViTConfig, TimmViTTower

        return TimmViTTower(TimmViTConfig(
            image_size=v.image_size, patch_size=v.patch_size, width=v.width,
            depth=v.layers, heads=v.heads, mlp_ratio=v.mlp_ratio,
            class_token=v.pool_type == "tok",
            pool="token" if v.pool_type == "tok" else "avg",
            fc_norm=v.final_ln_after_pool, embed_dim=e), **kw)
    if v.tower == "relpos-vit":
        from .vit_relpos import RelPosViTConfig, RelPosViTTower

        return RelPosViTTower(RelPosViTConfig(
            image_size=v.image_size, patch_size=v.patch_size, width=v.width,
            depth=v.layers, heads=v.heads, mlp_ratio=v.mlp_ratio,
            embed_dim=e), **kw)
    if v.tower == "mci-vit":
        from .mci_vit import MCiViTConfig, MCiViTTower

        return MCiViTTower(MCiViTConfig(
            image_size=v.image_size, width=v.width, depth=v.layers,
            heads=v.width // v.head_width, mlp_ratio=v.mlp_ratio,
            embed_dim=e), **kw)
    if v.tower == "swin":
        from .swin import SwinConfig, SwinTower

        return SwinTower(SwinConfig(
            image_size=v.image_size, patch_size=v.patch_size,
            embed_dim=v.width, depths=tuple(v.swin_depths),
            heads=tuple(v.swin_heads), window=v.swin_window,
            mlp_ratio=v.mlp_ratio, out_dim=e), **kw)
    if v.tower == "vitamin":
        from .vitamin import VitaminConfig, VitaminTower

        return VitaminTower(VitaminConfig(
            image_size=v.image_size,
            mbconv_dims=tuple(v.vitamin_mbconv_dims),
            mbconv_depths=tuple(v.vitamin_mbconv_depths), width=v.width,
            depth=v.layers, heads=v.heads, mlp_ratio=v.mlp_ratio,
            embed_dim=e), **kw)
    if v.tower == "fastvit":
        from .fastvit import FastViTConfig, FastViTTower

        return FastViTTower(FastViTConfig(
            image_size=v.image_size, layers=tuple(v.fastvit_layers),
            dims=tuple(v.fastvit_dims), mlp_ratio=v.mlp_ratio,
            embed_dim=e), **kw)
    if v.tower == "convnext":
        from .convnext import ConvNeXtConfig, ConvNeXtTower

        return ConvNeXtTower(ConvNeXtConfig(
            depths=v.convnext_depths, dims=v.convnext_dims, embed_dim=e,
            proj=v.head_proj, image_size=v.image_size), **kw)
    raise ValueError(f"unknown vision tower {v.tower!r}")


def _custom_text_keys(module, state_dict, prefix, *args) -> None:
    """Load pre-hook: open_clip's CustomTextCLIP keeps the text tower under
    ``text.``; CLIP keeps its modules at top level."""
    head = prefix + "text."
    for key in [k for k in state_dict if k.startswith(head)]:
        state_dict[prefix + key[len(head):]] = state_dict.pop(key)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, quant: Quant = False,
                 block_impl: str = "composable", remat: Remat = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        if cfg.vision.tower == "vit":
            self.visual = VisionTransformer(cfg.vision, cfg.embed_dim,
                                            cfg.quick_gelu, quant, block_impl,
                                            remat, compute_dtype)
        else:
            if quant:
                raise NotImplementedError(
                    f"the {cfg.vision.tower!r} vision tower takes no quant: "
                    "int8 serves the ViT towers only (JAX's --int8 fails on "
                    "the zoo towers, ROADMAP.md queue 3)")
            self.visual = build_visual(cfg, remat, compute_dtype)
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
                           nn.Parameter(torch.tensor(
                               float(cfg.init_logit_bias))))
        self._register_load_state_dict_pre_hook(_custom_text_keys,
                                                with_module=True)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     output_tokens: bool = False, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None,
                     keep_idx: Optional[torch.Tensor] = None):
        """images [B, S, S, 3] -> [B, embed_dim] (and tokens).
        ``deterministic=False`` (the train step's) drops patches where the
        config has patch dropout, drawn from ``generator`` or given as
        ``keep_idx``; eval and serving never drop patches."""
        if self.cfg.vision.tower == "vit":
            pooled, tokens = self.visual(images, deterministic=deterministic,
                                         generator=generator,
                                         keep_idx=keep_idx)
        else:
            pooled, tokens = self.visual(images)
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
                generator: Optional[torch.Generator] = None,
                keep_idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        out = {"logit_scale": self.logit_scale.exp()}
        if images is not None:
            out["image_features"] = self.encode_image(
                images, normalize=True, deterministic=deterministic,
                generator=generator, keep_idx=keep_idx)
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
