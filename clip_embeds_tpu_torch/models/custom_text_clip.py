"""CustomTextCLIP: a CLIP vision tower and an HF-style text tower
(counterpart of ``clip_embeds_tpu/models/custom_text_clip.py``).

open_clip's CustomTextCLIP pairs a vision tower with an HFTextEncoder for
the registry's roberta-, xlm-roberta-, mt5- and nllb-clip configs. The text
side is one of ``models/hf_text.py``'s towers; the vision side the port's
ViT (``models/vit.py``, composable: its attention is the flash kernel #4
on the card in bf16, as JAX's ViT reaches its Pallas kernel), or for the
``nllb-clip-*-siglip`` hybrids the SigLIP MAP-pooled tower of
``models/siglip.py``. :func:`build_custom_text_clip` resolves any of the
registry's nine hf-text names (``coca_roberta-ViT-B-32``, a CoCa, is not
one: ``resolve_coca_config`` raises JAX's NotImplementedError for it).
Module names: ``visual.*`` (open_clip's ViT; the SigLIP tower's are the
port's, as in ``models/siglip.py``), ``text.transformer.*`` and
``text.proj*`` (open_clip's), ``logit_scale`` and ``logit_bias``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .hf_text import (
    BertTextConfig,
    BertTextTower,
    M2M100Config,
    M2M100TextTower,
    T5TextTower,
)
from .t5 import T5Config
from .vit import VisionTransformer

# public shapes for the registry's hf_model_name text towers
HF_TEXT_SHAPES: Dict[str, Dict[str, Any]] = {
    "roberta-base": dict(
        kind="bert", vocab_size=50265, hidden_size=768, num_layers=12,
        num_heads=12, intermediate_size=3072, max_position_embeddings=514,
    ),
    "xlm-roberta-base": dict(
        kind="bert", vocab_size=250002, hidden_size=768, num_layers=12,
        num_heads=12, intermediate_size=3072, max_position_embeddings=514,
    ),
    "xlm-roberta-large": dict(
        kind="bert", vocab_size=250002, hidden_size=1024, num_layers=24,
        num_heads=16, intermediate_size=4096, max_position_embeddings=514,
    ),
    "google/mt5-base": dict(
        kind="t5", vocab_size=250112, d_model=768, d_kv=64, d_ff=2048,
        num_layers=12, num_heads=12,
    ),
    "google/mt5-xl": dict(
        kind="t5", vocab_size=250112, d_model=2048, d_kv=64, d_ff=5120,
        num_layers=24, num_heads=32,
    ),
    "facebook/nllb-200-distilled-600M": dict(
        kind="m2m100", vocab_size=256206, d_model=1024, num_layers=12,
        num_heads=16, ffn_dim=4096,
    ),
    "facebook/nllb-200-distilled-1.3B": dict(
        kind="m2m100", vocab_size=256206, d_model=2048, num_layers=24,
        num_heads=16, ffn_dim=8192,
    ),
}


@dataclasses.dataclass(frozen=True)
class CustomTextCLIPConfig:
    embed_dim: int
    vision: VisionConfig
    hf_model_name: str
    pooler: str = "mean"       # hf_pooler_type mean_pooler
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592
    init_logit_bias: Optional[float] = None  # SigLIP-style pairing bias
    # nllb-clip-*-siglip hybrids: SigLIP MAP-pooled vision trunk with
    # timm_proj 'none' (the MAP head output IS the embedding)
    siglip_vision: Optional[Any] = None      # models.siglip.SiglipVisionConfig


def build_text_tower(cfg: CustomTextCLIPConfig,
                     shapes: Optional[Dict[str, Any]] = None) -> nn.Module:
    """The text tower of ``cfg`` (``shapes``: its HF_TEXT_SHAPES entry)."""
    shape = dict(shapes or HF_TEXT_SHAPES[cfg.hf_model_name])
    kind = shape.pop("kind")
    if kind == "t5":
        return T5TextTower(T5Config(**shape), cfg.embed_dim, cfg.pooler)
    if kind == "m2m100":
        return M2M100TextTower(M2M100Config(**shape), cfg.embed_dim,
                               cfg.pooler)
    return BertTextTower(BertTextConfig(**shape), cfg.embed_dim, cfg.pooler)


class CustomTextCLIP(nn.Module):
    def __init__(self, cfg: CustomTextCLIPConfig,
                 text_shapes: Optional[Dict[str, Any]] = None):
        """``text_shapes`` stands in for ``HF_TEXT_SHAPES[cfg.hf_model_name]``
        (a cut tower)."""
        super().__init__()
        self.cfg = cfg
        if cfg.siglip_vision is not None:
            from .siglip import SiglipVisionTower

            self.visual = SiglipVisionTower(cfg.siglip_vision)
        else:
            self.visual = VisionTransformer(cfg.vision, cfg.embed_dim,
                                            cfg.quick_gelu)
        self.text = build_text_tower(cfg, text_shapes)
        self.logit_scale = nn.Parameter(
            torch.tensor(float(cfg.init_logit_scale)))
        self.logit_bias = (None if cfg.init_logit_bias is None else
                           nn.Parameter(torch.tensor(
                               float(cfg.init_logit_bias))))

    def encode_image(self, images: torch.Tensor,
                     normalize: bool = False) -> torch.Tensor:
        out = self.visual(images)
        pooled = out[0] if isinstance(out, tuple) else out
        return l2_normalize(pooled) if normalize else pooled

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    normalize: bool = False) -> torch.Tensor:
        pooled = self.text(input_ids, attention_mask)
        return l2_normalize(pooled) if normalize else pooled

    def forward(self, images: Optional[torch.Tensor] = None,
                input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        out = {"logit_scale": self.logit_scale.exp()}
        if images is not None:
            out["image_features"] = self.encode_image(images, normalize=True)
        if input_ids is not None:
            out["text_features"] = self.encode_text(
                input_ids, attention_mask, normalize=True)
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


def custom_text_config(name: str) -> CustomTextCLIPConfig:
    """The CustomTextCLIPConfig of an hf-text registry name, as JAX's
    ``build_custom_text_clip`` resolves it."""
    from ..core.openclip_registry import (
        _parse_timm_siglip,
        classify_model,
        get_raw_model_config,
    )

    backend, _ = classify_model(name)
    if backend != "hf-text":
        raise NotImplementedError(f"{name!r} is not an hf-text config")
    raw = get_raw_model_config(name)
    v = raw["vision_cfg"]
    siglip_vision = None
    if v.get("timm_model_name", "").find("siglip") >= 0:
        # nllb-clip-*-siglip hybrid: SigLIP vision trunk (MAP pool, no proj)
        from .siglip import SiglipVisionConfig

        shape = _parse_timm_siglip(v["timm_model_name"])
        siglip_vision = SiglipVisionConfig(
            image_size=v.get("image_size", shape["image_size"]),
            patch_size=shape["patch_size"], width=shape["width"],
            layers=shape["layers"], heads=shape["heads"],
            intermediate_size=shape["intermediate_size"],
        )
        vision = VisionConfig()  # unused placeholder
    else:
        vision = VisionConfig(
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 16),
            width=v.get("width", 768),
            layers=v.get("layers", 12),
            head_width=v.get("head_width", 64),
        )
    pooler = {"mean_pooler": "mean", "cls_pooler": "first"}.get(
        raw["text_cfg"].get("hf_pooler_type", "mean_pooler"), "mean")
    return CustomTextCLIPConfig(
        embed_dim=raw["embed_dim"], vision=vision,
        hf_model_name=raw["text_cfg"]["hf_model_name"], pooler=pooler,
        quick_gelu=raw.get("quick_gelu", False),
        init_logit_bias=raw.get("init_logit_bias"),
        siglip_vision=siglip_vision,
    )


def build_custom_text_clip(name: str,
                           text_shapes: Optional[Dict[str, Any]] = None
                           ) -> CustomTextCLIP:
    """An hf-text registry name (roberta-ViT-B-32, mt5-xl-ViT-H-14,
    nllb-clip-large-siglip, ...) -> its CustomTextCLIP with PyTorch's
    default init, on the CPU in fp32 (:func:`init_custom_text_clip` draws
    seeded weights)."""
    return CustomTextCLIP(custom_text_config(name), text_shapes)


@torch.no_grad()
def init_custom_text_clip(model: CustomTextCLIP,
                          g: torch.Generator) -> CustomTextCLIP:
    """Seeded values, in place, from ``g`` (on the model's device): norms
    at one and zero, biases zero, the logit scale and bias at the config's,
    embedding tables at 0.02 (the ViT's class and positional embeddings at
    width^-1/2), matrices at fan-in^-1/2."""
    done = set()
    for m in model.modules():
        if isinstance(m, nn.LayerNorm) or type(m).__name__ == "T5LayerNorm":
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
            done.update(id(p) for p in m.parameters())
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=0.02, generator=g)
            done.add(id(m.weight))
    cfg = model.cfg
    for name, p in model.named_parameters():
        if id(p) in done:
            continue
        if name == "logit_scale":
            p.fill_(float(cfg.init_logit_scale))
        elif name == "logit_bias":
            p.fill_(float(cfg.init_logit_bias))
        elif name.endswith("bias"):
            p.zero_()
        elif name.endswith(("class_embedding", "positional_embedding")):
            nn.init.normal_(p, std=p.shape[-1] ** -0.5, generator=g)
        elif name.endswith("self_attn.q.weight"):  # T5: unscaled logits
            nn.init.normal_(p, std=(p.shape[1] * model.text.cfg.d_kv)
                            ** -0.5, generator=g)
        elif p.dim() >= 2:
            nn.init.normal_(p, std=p[0].numel() ** -0.5, generator=g)
        else:
            nn.init.normal_(p, std=0.02, generator=g)
    return model
