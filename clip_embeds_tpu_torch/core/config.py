"""Model configurations: the JAX package's one registry
(``clip_embeds_tpu/core/config.py``), loaded by path (see ``shared``)."""

from __future__ import annotations

from typing import Optional

from ..shared import load_shared

_ref = load_shared("core/config.py")

CLIPConfig = _ref.CLIPConfig
VisionConfig = _ref.VisionConfig
TextConfig = _ref.TextConfig
MODEL_CONFIGS = _ref.MODEL_CONFIGS


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
    return _ref.get_model_config(key, pretrained)
