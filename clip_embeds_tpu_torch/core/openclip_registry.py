"""The SigLIP and CoCa parts of the open_clip model-config registry (a copy
of those parts of ``clip_embeds_tpu/core/openclip_registry.py``; the rest of
the registry is not ported yet), and its table of pretrained tags.

``openclip_registry.json`` beside this file holds the registry entries
whose vision tower is a timm ``vit_*_siglip_*`` tower and the four
``coca_*`` entries, copied from the JAX package's
``reference_registry.json`` (open_clip's model-config JSONs).
:func:`classify_model` names the backend of such an entry: 'coca' (an
entry with a ``multimodal_cfg``), 'siglip' (the dual encoder of
``models/siglip.py``) or 'hf-text' (a SigLIP vision tower under an HF text
tower, the nllb-clip hybrids, not built here);
:func:`resolve_siglip_config` maps a 'siglip' entry onto
:class:`~..models.siglip.SiglipConfig`, :func:`resolve_coca_config` a
'coca' one onto :class:`~..models.coca.CoCaConfig` (``coca_roberta-ViT-B-32``,
whose text tower is HF's RoBERTa, raises as in JAX).
``tests/test_torch_siglip.py`` and ``tests/test_torch_coca.py`` hold them
to the JAX package for every entry. ``pretrained_tags.json``
holds the architecture -> tags part of the registry's pretrained table (the
download records are not copied); :func:`list_pretrained` reads it, as the
JAX function of that name reads the whole table.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

_REGISTRY_PATH = os.path.join(os.path.dirname(__file__),
                              "openclip_registry.json")
_registry_cache: Optional[Dict[str, Any]] = None

# public shapes for the timm SigLIP ViT towers (width, layers, heads, mlp)
_SIGLIP_VIT_SHAPES = {
    "base": (768, 12, 12, 3072),
    "large": (1024, 24, 16, 4096),
    "so400m": (1152, 27, 16, 4304),
    "giantopt": (1536, 40, 16, 6144),
}


def _registry() -> Dict[str, Any]:
    global _registry_cache
    if _registry_cache is None:
        with open(_REGISTRY_PATH) as fh:
            _registry_cache = json.load(fh)
    return _registry_cache


def _parse_timm_siglip(name: str) -> Optional[Dict[str, int]]:
    # e.g. vit_so400m_patch14_siglip_384
    parts = name.split("_")
    if len(parts) < 4 or parts[0] != "vit" or "siglip" not in parts:
        return None
    size_key = parts[1]
    if size_key not in _SIGLIP_VIT_SHAPES:
        return None
    patch = int(parts[2].replace("patch", ""))
    img = int(parts[-1]) if parts[-1].isdigit() else 224
    w, l, h, mlp = _SIGLIP_VIT_SHAPES[size_key]
    return dict(
        width=w, layers=l, heads=h, intermediate_size=mlp,
        patch_size=patch, image_size=img,
    )


def list_siglip_models() -> Tuple[str, ...]:
    """The SigLIP-tower entries (SigLIP and the hf-text hybrids)."""
    return tuple(sorted(k for k, v in _registry()["model_configs"].items()
                        if v.get("multimodal_cfg") is None))


def list_coca_models() -> Tuple[str, ...]:
    return tuple(sorted(k for k, v in _registry()["model_configs"].items()
                        if v.get("multimodal_cfg") is not None))


def get_raw_model_config(name: str) -> Optional[Dict[str, Any]]:
    return _registry()["model_configs"].get(name)


def classify_model(name: str) -> Tuple[str, str]:
    """(backend, detail) of a registry name: ('coca', ...), ('siglip',
    timm tower), ('hf-text', ...) for a SigLIP tower under an HF text
    tower, or ('unknown', ...) for a name outside the ported subset."""
    raw = get_raw_model_config(name)
    if raw is None:
        return "unknown", f"no SigLIP or CoCa model config named {name!r}"
    if raw.get("multimodal_cfg") is not None:
        return "coca", "attentional pool + multimodal decoder"
    t = raw.get("text_cfg", {})
    timm = raw.get("vision_cfg", {}).get("timm_model_name", "")
    if t.get("hf_model_name"):
        # nllb-clip-*-siglip hybrid -> CustomTextCLIP assembly
        return "hf-text", f"{t['hf_model_name']} + siglip vision"
    return "siglip", timm


def resolve_siglip_config(name: str):
    """Map a ViT-*-SigLIP* config onto models/siglip.py SiglipConfig."""
    from ..models.siglip import (
        SiglipConfig,
        SiglipTextConfig,
        SiglipVisionConfig,
    )

    raw = get_raw_model_config(name)
    backend, timm = classify_model(name)
    if backend != "siglip":
        raise NotImplementedError(f"{name!r} is not a SigLIP config")
    if raw.get("text_cfg", {}).get("hf_model_name"):
        raise NotImplementedError(
            f"{name!r} pairs a SigLIP vision tower with an HF text tower "
            f"({raw['text_cfg']['hf_model_name']}); not ported yet"
        )
    shape = _parse_timm_siglip(timm)
    assert shape is not None
    t = raw.get("text_cfg", {})
    return SiglipConfig(
        vision=SiglipVisionConfig(
            image_size=raw.get("vision_cfg", {}).get(
                "image_size", shape["image_size"]
            ),
            patch_size=shape["patch_size"],
            width=shape["width"],
            layers=shape["layers"],
            heads=shape["heads"],
            intermediate_size=shape["intermediate_size"],
        ),
        text=SiglipTextConfig(
            vocab_size=t.get("vocab_size", 32000),
            width=t.get("width", shape["width"]),
            layers=t.get("layers", shape["layers"]),
            heads=t.get("heads", shape["heads"]),
            intermediate_size=int(
                t.get("width", shape["width"]) * t.get("mlp_ratio", 4.0)
            )
            if "mlp_ratio" in t
            else shape["intermediate_size"],
            max_position_embeddings=t.get("context_length", 64),
        ),
    )


def resolve_coca_config(name: str):
    """Map a registry ``coca_*`` entry onto models/coca.py CoCaConfig (the
    JAX function's fields and defaults)."""
    from ..models.coca import CoCaConfig, MultimodalConfig
    from .config import TextConfig, VisionConfig

    raw = get_raw_model_config(name)
    if raw is None:
        raise KeyError(name)
    v, t, m = raw["vision_cfg"], raw["text_cfg"], raw["multimodal_cfg"]
    if t.get("hf_model_name"):
        raise NotImplementedError(
            f"{name!r}: CoCa with an HF text tower is not built")
    vision = VisionConfig(
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 32),
        width=v.get("width", 768), layers=v.get("layers", 12),
        head_width=v.get("head_width", 64),
        mlp_ratio=v.get("mlp_ratio", 4.0),
    )
    text = TextConfig(
        context_length=t.get("context_length", 76),
        vocab_size=t.get("vocab_size", 49408),
        width=t.get("width", 512), heads=t.get("heads", 8),
        layers=t.get("layers", 12),
    )
    multimodal = MultimodalConfig(
        context_length=m.get("context_length", 76),
        width=m.get("width", 512), heads=m.get("heads", 8),
        layers=m.get("layers", 12), mlp_ratio=m.get("mlp_ratio", 4.0),
    )
    return CoCaConfig(
        embed_dim=raw["embed_dim"], vision=vision, text=text,
        multimodal=multimodal,
        attn_pooler_queries=v.get("attn_pooler_queries", 256),
        attn_pooler_heads=v.get("attn_pooler_heads", 8),
    )


def is_coca(name: str) -> bool:
    """Whether ``name`` (with '/' read as '-') is a registry CoCa entry."""
    key = name.replace("/", "-")
    return (get_raw_model_config(key) is not None
            and classify_model(key)[0] == "coca")


def list_pretrained(as_str: bool = False
                    ) -> List[Union[str, Tuple[str, str]]]:
    """Every (architecture, pretrained tag) of the registry, or
    "arch:tag" strings."""
    with open(os.path.join(os.path.dirname(__file__),
                           "pretrained_tags.json")) as fh:
        table = json.load(fh)
    return [f"{k}:{t}" if as_str else (k, t)
            for k in table for t in table[k]]
