"""Model configuration dataclasses and the name -> config registry.

The port's own copy of ``clip_embeds_tpu/core/config.py`` (the dataclasses,
``MODEL_CONFIGS`` and ``get_model_config``); ``tests/test_torch_convert.py``
holds the two registries equal field by field. Only the hand-written
configs resolve here: the open_clip registry (``core/openclip_registry.py``)
is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    tower: str = "vit"  # only 'vit' is ported
    resnet_layers: Tuple[int, ...] = ()  # ModifiedResNet stage depths
    convnext_depths: Tuple[int, ...] = ()  # ConvNeXt stage depths
    convnext_dims: Tuple[int, ...] = ()    # ConvNeXt stage widths
    head_proj: str = "linear"  # timm-style head projection: 'linear' | 'mlp'
    head_width: int = 64
    mlp_ratio: float = 4.0
    pool_type: str = "tok"  # 'tok' | 'avg' | 'none'
    # FLIP-style train-time patch dropout (fraction of patch tokens dropped)
    patch_dropout: float = 0.0
    no_ln_pre: bool = False
    final_ln_after_pool: bool = False
    # EVA02 tower variants
    eva_rope: bool = False
    eva_swiglu: bool = False
    eva_attn_inner_norm: bool = False
    eva_post_norm: bool = False
    eva_ref_feat_shape: Tuple[int, int] = ()
    # ViTamin hybrid tower: MbConv stage dims/depths
    vitamin_mbconv_dims: Tuple[int, int] = ()
    vitamin_mbconv_depths: Tuple[int, int] = ()
    # Swin tower: width = stage-0 embed dim
    swin_depths: Tuple[int, ...] = ()
    swin_heads: Tuple[int, ...] = ()
    swin_window: int = 7
    # FastViT-MCI tower: stage depths/dims
    fastvit_layers: Tuple[int, ...] = ()
    fastvit_dims: Tuple[int, ...] = ()

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    pool_type: str = "argmax"  # 'argmax' | 'first' | 'last' | 'none'
    no_causal_mask: bool = False
    pad_id: int = 0


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592  # ln(1/0.07)
    init_logit_bias: Optional[float] = None  # set for SigLIP-style models

    def replace(self, **kw) -> "CLIPConfig":
        return dataclasses.replace(self, **kw)


def _cfg(embed_dim: int, vision: Dict[str, Any], text: Dict[str, Any],
         **kw) -> CLIPConfig:
    return CLIPConfig(embed_dim=embed_dim, vision=VisionConfig(**vision),
                      text=TextConfig(**text), **kw)


# Tower shapes follow open_clip's model_configs/<name>.json.
MODEL_CONFIGS: Dict[str, CLIPConfig] = {
    "ViT-B-32": _cfg(
        512,
        dict(image_size=224, patch_size=32, width=768, layers=12),
        dict(width=512, heads=8, layers=12),
    ),
    "ViT-B-16": _cfg(
        512,
        dict(image_size=224, patch_size=16, width=768, layers=12),
        dict(width=512, heads=8, layers=12),
    ),
    "ViT-L-14": _cfg(
        768,
        dict(image_size=224, patch_size=14, width=1024, layers=24),
        dict(width=768, heads=12, layers=12),
    ),
    "ViT-L-14-336": _cfg(
        768,
        dict(image_size=336, patch_size=14, width=1024, layers=24),
        dict(width=768, heads=12, layers=12),
    ),
    "ViT-H-14": _cfg(
        1024,
        dict(image_size=224, patch_size=14, width=1280, layers=32,
             head_width=80),
        dict(width=1024, heads=16, layers=24),
    ),
    "ViT-g-14": _cfg(
        1024,
        dict(image_size=224, patch_size=14, width=1408, layers=40,
             head_width=88, mlp_ratio=4.3637),
        dict(width=1024, heads=16, layers=24),
    ),
    "ViT-bigG-14": _cfg(
        1280,
        dict(image_size=224, patch_size=14, width=1664, layers=48,
             head_width=104, mlp_ratio=4.9231),
        dict(width=1280, heads=20, layers=32),
    ),
    "EVA01-g-14": _cfg(
        1024,
        dict(tower="eva", image_size=224, patch_size=14, width=1408,
             layers=40, head_width=88, mlp_ratio=6144 / 1408),
        dict(width=768, heads=12, layers=12),
    ),
}

# ModifiedResNet CLIP family (a ResNet tower: not ported)
MODEL_CONFIGS["RN50"] = _cfg(
    1024,
    dict(tower="resnet", image_size=224, width=64, resnet_layers=(3, 4, 6, 3)),
    dict(width=512, heads=8, layers=12),
)
MODEL_CONFIGS["RN101"] = _cfg(
    512,
    dict(tower="resnet", image_size=224, width=64,
         resnet_layers=(3, 4, 23, 3)),
    dict(width=512, heads=8, layers=12),
)
MODEL_CONFIGS["RN50x4"] = _cfg(
    640,
    dict(tower="resnet", image_size=288, width=80,
         resnet_layers=(4, 6, 10, 6)),
    dict(width=640, heads=10, layers=12),
)

# HPSv2 and PickScore are plain CLIP ViT-H-14 checkpoints
MODEL_CONFIGS["HPSv2"] = MODEL_CONFIGS["ViT-H-14"]
MODEL_CONFIGS["PickScore"] = MODEL_CONFIGS["ViT-H-14"]

# A tiny config for tests.
MODEL_CONFIGS["test-tiny"] = _cfg(
    64,
    dict(image_size=32, patch_size=16, width=64, layers=2, head_width=32),
    dict(width=64, heads=2, layers=2, vocab_size=49408),
)

# Tiny tower with the widths of the PACL/SPARC ViT-L head branch.
MODEL_CONFIGS["test-pacl-tiny"] = _cfg(
    768,
    dict(image_size=64, patch_size=32, width=1024, layers=1, head_width=64),
    dict(width=768, heads=12, layers=1, vocab_size=49408),
)

# ViT-L/14-336 widths (1024, head dim 64, 577 tokens; text 768 / 12 heads)
# at a depth of 2.
MODEL_CONFIGS["test-vitl-2layer"] = _cfg(
    768,
    dict(image_size=336, patch_size=14, width=1024, layers=2, head_width=64),
    dict(width=768, heads=12, layers=2, vocab_size=49408),
)

# Pretrained tags whose towers use QuickGELU: OpenAI weights always do.
_QUICK_GELU_TAGS = {"openai"}


def get_model_config(name: str, pretrained: Optional[str] = None
                     ) -> CLIPConfig:
    """Resolve a model name (+ optional pretrained tag, 'openai' selects
    QuickGELU) to a CLIPConfig. Only the hand-written configs resolve: the
    open_clip registry (``core/openclip_registry.py``) is not ported."""
    key = name.replace("/", "-")
    if key not in MODEL_CONFIGS:
        raise KeyError(
            f"unknown model {name!r}; the port knows {sorted(MODEL_CONFIGS)}"
            " (the open_clip registry is not ported yet)"
        )
    cfg = MODEL_CONFIGS[key]
    if pretrained in _QUICK_GELU_TAGS or key.endswith("-quickgelu"):
        cfg = cfg.replace(quick_gelu=True)
    return cfg
