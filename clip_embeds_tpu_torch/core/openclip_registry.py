"""The SigLIP part of the open_clip model-config registry (a copy of the
SigLIP subset of ``clip_embeds_tpu/core/openclip_registry.py``; the rest of
the registry is not ported yet).

``siglip_registry.json`` beside this file holds the registry entries whose
vision tower is a timm ``vit_*_siglip_*`` tower, copied from the JAX
package's ``reference_registry.json`` (open_clip's model-config JSONs).
:func:`classify_model` names the backend of such an entry: 'siglip' (the
dual encoder of ``models/siglip.py``) or 'hf-text' (a SigLIP vision tower
under an HF text tower, the nllb-clip hybrids, not built here);
:func:`resolve_siglip_config` maps a 'siglip' entry onto
:class:`~..models.siglip.SiglipConfig`. ``tests/test_torch_siglip.py``
holds both to the JAX package for every entry.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

_REGISTRY_PATH = os.path.join(os.path.dirname(__file__),
                              "siglip_registry.json")
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
    return tuple(sorted(_registry()["model_configs"]))


def get_raw_model_config(name: str) -> Optional[Dict[str, Any]]:
    return _registry()["model_configs"].get(name)


def classify_model(name: str) -> Tuple[str, str]:
    """(backend, detail) of a registry name: ('siglip', timm tower),
    ('hf-text', ...) for a SigLIP tower under an HF text tower, or
    ('unknown', ...) for a name outside the SigLIP subset."""
    raw = get_raw_model_config(name)
    if raw is None:
        return "unknown", f"no SigLIP model config named {name!r}"
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
