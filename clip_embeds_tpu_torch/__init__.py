"""clip_embeds_tpu_torch: the PyTorch/CUDA port of clip_embeds_tpu for one
NVIDIA H100.

It imports torch and never jax or the JAX package, which stays beside it as
the reference. Importing this package is cheap: names resolve on first use.
"""

_LAZY = {
    "create_model": "core.factory",
    "get_model_config": "core.config",
    "CLIPConfig": "core.config",
    "VisionConfig": "core.config",
    "TextConfig": "core.config",
    "CLIP": "models.clip",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
