"""The open_clip name -> config and pretrained-weights registry (a copy of
``clip_embeds_tpu/core/openclip_registry.py``).

``reference_registry.json`` beside this file is a byte copy of the JAX
package's ``core/reference_registry.json``: open_clip's 126 model-config
JSONs and its pretrained table (99 architectures with their tags, URLs and
preprocess stats). :func:`classify_model` names the backend that builds an
entry, as JAX does:

  'clip'    -- ``models/clip.py`` CLIP (ViT, ModifiedResNet, EVA01/EVA02,
               ViTamin, the timm and rel-pos ViTs, MCi-ViT, FastViT,
               Swin and ConvNeXt towers: :func:`resolve_clip_config`)
  'siglip'  -- ``models/siglip.py`` (:func:`resolve_siglip_config`)
  'coca'    -- ``models/coca.py`` (:func:`resolve_coca_config`)
  'hf-text' -- ``models/custom_text_clip.py build_custom_text_clip``

``tests/test_torch_registry.py`` holds every entry to the JAX package.
:func:`download_pretrained` resolves a pretrained entry to a file in the
cache, or fetches its URL as JAX's does (no test reaches the network: they
replace the fetch).
"""

from __future__ import annotations

import json
import os
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Tuple, Union

from .config import CLIPConfig, TextConfig, VisionConfig

_REGISTRY_PATH = os.path.join(os.path.dirname(__file__),
                              "reference_registry.json")
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


# -- the pretrained table ----------------------------------------------------

def _clean_tag(tag: str) -> str:
    return tag.lower().replace("-", "_")


def list_pretrained(as_str: bool = False
                    ) -> List[Union[str, Tuple[str, str]]]:
    """Every (architecture, pretrained tag) of the table, or "arch:tag"."""
    table = _registry()["pretrained"]
    return [f"{k}:{t}" if as_str else (k, t)
            for k in table for t in table[k]]


def list_pretrained_models_by_tag(tag: str) -> List[str]:
    tag = _clean_tag(tag)
    return [k for k, v in _registry()["pretrained"].items() if tag in v]


def list_pretrained_tags_by_model(model: str) -> List[str]:
    return list(_registry()["pretrained"].get(model, {}))


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return _clean_tag(tag) in _registry()["pretrained"].get(model, {})


def get_pretrained_cfg(model: str, tag: str) -> Dict[str, Any]:
    return dict(
        _registry()["pretrained"].get(model, {}).get(_clean_tag(tag), {}))


def download_pretrained(cfg: Dict[str, Any],
                        cache_dir: Optional[str] = None) -> str:
    """A pretrained entry's checkpoint file: ``cache_dir`` (default
    $CLIP_EMBEDS_CKPT_DIR or ~/.cache/clip_embeds_tpu) holds it already, or
    its ``url`` is fetched there (an entry with only an ``hf_hub`` source
    raises FileNotFoundError, as in JAX)."""
    cache_dir = cache_dir or os.environ.get(
        "CLIP_EMBEDS_CKPT_DIR",
        os.path.expanduser("~/.cache/clip_embeds_tpu"))
    url = cfg.get("url", "")
    if not url:
        raise FileNotFoundError(
            "pretrained cfg has no direct url "
            f"(hf_hub={cfg.get('hf_hub')!r}); "
            "download the checkpoint manually into CLIP_EMBEDS_CKPT_DIR")
    fname = os.path.basename(urllib.parse.urlsplit(url).path)
    target = os.path.join(cache_dir, fname)
    if os.path.exists(target):
        return target
    os.makedirs(cache_dir, exist_ok=True)
    urllib.request.urlretrieve(url, target)
    return target


# -- model-config resolution -------------------------------------------------

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
    return dict(width=w, layers=l, heads=h, intermediate_size=mlp,
                patch_size=patch, image_size=img)


def list_openclip_models() -> Tuple[str, ...]:
    return tuple(sorted(_registry()["model_configs"]))


def list_siglip_models() -> Tuple[str, ...]:
    """The entries with a timm SigLIP vision tower (SigLIP and the
    nllb-clip hybrids)."""
    return tuple(n for n in list_openclip_models()
                 if _parse_timm_siglip(get_raw_model_config(n).get(
                     "vision_cfg", {}).get("timm_model_name", "")))


def list_coca_models() -> Tuple[str, ...]:
    return tuple(n for n in list_openclip_models()
                 if get_raw_model_config(n).get("multimodal_cfg")
                 is not None)


def get_raw_model_config(name: str) -> Optional[Dict[str, Any]]:
    return _registry()["model_configs"].get(name)


def classify_model(name: str) -> Tuple[str, str]:
    """(backend, detail) for an open_clip model name."""
    raw = get_raw_model_config(name)
    if raw is None:
        return "unknown", f"no model config named {name!r}"
    v = raw.get("vision_cfg", {})
    t = raw.get("text_cfg", {})
    timm = v.get("timm_model_name", "")
    if raw.get("multimodal_cfg") is not None:
        return "coca", "attentional pool + multimodal decoder"
    if timm:
        if _parse_timm_siglip(timm):
            if t.get("hf_model_name"):
                # nllb-clip-*-siglip hybrid -> CustomTextCLIP assembly
                return "hf-text", f"{t['hf_model_name']} + siglip vision"
            return "siglip", timm
        if timm.startswith("eva_giant"):
            return "clip", "eva01 tower"
        if timm.startswith("eva02"):
            return "clip", f"eva02 tower ({timm})"
        if timm.startswith("vitamin"):
            return "clip", f"vitamin tower ({timm})"
        if timm in ("vit_medium_patch16_gap_256",):
            return "clip", f"timm-vit tower ({timm})"
        if timm.startswith("vit_relpos"):
            return "clip", f"relpos-vit tower ({timm})"
        if timm.startswith("swin_base_patch4_window7"):
            return "clip", f"swin tower ({timm})"
        if timm == "vit_base_mci_224":
            return "clip", f"mci-vit tower ({timm})"
        if timm.startswith("fastvit_mci"):
            return "clip", f"fastvit tower ({timm})"
        if timm.startswith("convnext"):
            return "clip", f"convnext tower ({timm})"
        return "unsupported", f"timm tower {timm!r} not built yet"
    if t.get("hf_model_name"):
        hf = t["hf_model_name"]
        if "t5" in hf or "roberta" in hf.lower() or "nllb" in hf:
            return "hf-text", hf
        return "unsupported", f"HF text tower {hf!r} not built yet"
    if isinstance(v.get("layers"), (list, tuple)):
        return "clip", "modified-resnet tower"
    return "clip", "native vit tower"


def is_coca(name: str) -> bool:
    """Whether ``name`` (with '/' read as '-') is a registry CoCa entry."""
    key = name.replace("/", "-")
    return (get_raw_model_config(key) is not None
            and classify_model(key)[0] == "coca")


def resolve_coca_config(name: str):
    """Map a registry ``coca_*`` entry onto models/coca.py CoCaConfig (the
    JAX function's fields and defaults)."""
    from ..models.coca import CoCaConfig, MultimodalConfig

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


def _zoo_vision(detail: str, v: Dict[str, Any], embed_dim: int
                ) -> Optional[VisionConfig]:
    """The VisionConfig of a timm-trunk 'clip' entry, None for the others."""
    if detail == "eva01 tower":
        return VisionConfig(
            tower="eva", image_size=v.get("image_size", 224), patch_size=14,
            width=1408, layers=40, head_width=88, mlp_ratio=6144 / 1408)
    if detail.startswith("eva02 tower"):
        from ..models.eva import eva02_vision_config

        return eva02_vision_config(v["timm_model_name"],
                                   v.get("image_size", 224))
    if detail.startswith("vitamin tower"):
        from ..models.vitamin import vitamin_config

        vc = vitamin_config(v["timm_model_name"], v.get("image_size", 224),
                            embed_dim)
        return VisionConfig(
            tower="vitamin", image_size=vc.image_size, width=vc.width,
            layers=vc.depth, head_width=vc.width // vc.heads,
            mlp_ratio=vc.mlp_ratio, vitamin_mbconv_dims=vc.mbconv_dims,
            vitamin_mbconv_depths=vc.mbconv_depths, patch_size=16)
    if detail.startswith("timm-vit tower"):
        from ..models.timm_vit import TIMM_VIT_SHAPES

        tc = TIMM_VIT_SHAPES[v["timm_model_name"]]
        return VisionConfig(
            tower="timm-vit", image_size=v.get("image_size", tc.image_size),
            patch_size=tc.patch_size, width=tc.width, layers=tc.depth,
            head_width=tc.width // tc.heads, mlp_ratio=tc.mlp_ratio,
            pool_type="tok" if tc.class_token else "avg",
            final_ln_after_pool=tc.fc_norm)
    if detail.startswith("relpos-vit tower"):
        from ..models.vit_relpos import RELPOS_VIT_SHAPES

        rc = RELPOS_VIT_SHAPES[v["timm_model_name"]]
        return VisionConfig(
            tower="relpos-vit", image_size=v.get("image_size", rc.image_size),
            patch_size=rc.patch_size, width=rc.width, layers=rc.depth,
            head_width=rc.width // rc.heads, mlp_ratio=rc.mlp_ratio)
    if detail.startswith("mci-vit tower"):
        from ..models.mci_vit import MCI_VIT_SHAPES

        mc = MCI_VIT_SHAPES[v["timm_model_name"]]
        return VisionConfig(
            tower="mci-vit", image_size=v.get("image_size", mc.image_size),
            patch_size=16, width=mc.width, layers=mc.depth,
            head_width=mc.width // mc.heads, mlp_ratio=mc.mlp_ratio)
    if detail.startswith("fastvit tower"):
        from ..models.fastvit import MCI_FASTVIT_SHAPES

        fc = MCI_FASTVIT_SHAPES[v["timm_model_name"]]
        return VisionConfig(
            tower="fastvit", image_size=v.get("image_size", fc.image_size),
            patch_size=32, width=fc.dims[-1], fastvit_layers=fc.layers,
            fastvit_dims=fc.dims, mlp_ratio=fc.mlp_ratio)
    if detail.startswith("swin tower"):
        return VisionConfig(
            tower="swin", image_size=v.get("image_size", 224), patch_size=4,
            width=128, swin_depths=(2, 2, 18, 2), swin_heads=(4, 8, 16, 32),
            swin_window=7)
    if detail.startswith("convnext tower"):
        from ..models.convnext import CONVNEXT_SHAPES

        depths, dims = CONVNEXT_SHAPES[v["timm_model_name"]]
        return VisionConfig(
            tower="convnext", image_size=v.get("image_size", 224),
            width=dims[0], convnext_depths=depths, convnext_dims=dims,
            head_proj=v.get("timm_proj", "linear"))
    return None


def resolve_clip_config(name: str) -> CLIPConfig:
    """Map a raw open_clip JSON onto CLIPConfig (backend 'clip' only)."""
    raw = get_raw_model_config(name)
    if raw is None:
        raise KeyError(name)
    backend, detail = classify_model(name)
    if backend != "clip":
        raise NotImplementedError(
            f"model {name!r} needs backend {backend!r} ({detail}); "
            "use the dedicated builder")
    v, t = raw.get("vision_cfg", {}), raw.get("text_cfg", {})
    vision = _zoo_vision(detail, v, raw["embed_dim"])
    if vision is None and isinstance(v.get("layers"), (list, tuple)):
        vision = VisionConfig(
            tower="resnet", image_size=v.get("image_size", 224),
            width=v.get("width", 64), resnet_layers=tuple(v["layers"]))
    elif vision is None:
        vision = VisionConfig(
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 16),
            width=v.get("width", 768),
            layers=v.get("layers", 12),
            head_width=v.get("head_width", 64),
            mlp_ratio=v.get("mlp_ratio", 4.0),
            pool_type=v.get("pool_type", "tok"),
            no_ln_pre=v.get("no_ln_pre", False),
            final_ln_after_pool=v.get("final_ln_after_pool", False))
    text = TextConfig(
        context_length=t.get("context_length", 77),
        vocab_size=t.get("vocab_size", 49408),
        width=t.get("width", 512),
        heads=t.get("heads", 8),
        layers=t.get("layers", 12),
        mlp_ratio=t.get("mlp_ratio", 4.0),
        pool_type=t.get("pool_type", "argmax"),
        no_causal_mask=t.get("no_causal_mask", False))
    return CLIPConfig(
        embed_dim=raw["embed_dim"], vision=vision, text=text,
        quick_gelu=raw.get("quick_gelu", False),
        init_logit_bias=raw.get("init_logit_bias"))


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
            f"({raw['text_cfg']['hf_model_name']}); build it with "
            "models.custom_text_clip.build_custom_text_clip")
    shape = _parse_timm_siglip(timm)
    assert shape is not None
    t = raw.get("text_cfg", {})
    return SiglipConfig(
        vision=SiglipVisionConfig(
            image_size=raw.get("vision_cfg", {}).get(
                "image_size", shape["image_size"]),
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
                t.get("width", shape["width"]) * t.get("mlp_ratio", 4.0))
            if "mlp_ratio" in t else shape["intermediate_size"],
            max_position_embeddings=t.get("context_length", 64),
        ),
    )
