"""Model bundles: open_clip's ``push_to_hf_hub`` layout (counterpart of
``clip_embeds_tpu/core/export.py``).

A bundle folder holds ``clip_embeds_tpu_model.npz``, the JAX ``CLIP``'s
flax tree flattened to "a/b/kernel" keys, and ``open_clip_config.json``
with ``model_cfg`` (the config dataclass) and ``preprocess_cfg`` (the
image size, and the pretrained tag's mean / std / interpolation / resize
mode from the registry), byte for byte as JAX writes them, so a bundle of
either package loads in the other. The port writes and reads the flax
trees of every vision tower, exactly (``core/convert.py``
``jax_params_from_clip`` and ``state_dict_from_jax_params``).
``push_to_hub`` uploads a folder through ``huggingface_hub`` where it is
installed.

    from clip_embeds_tpu_torch.core.export import (
        load_model_bundle, save_model_bundle)
    save_model_bundle("bundle/", model, "ViT-L-14-336", "openai")
    model = load_model_bundle("bundle/")          # on the card
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .config import CLIPConfig, TextConfig, VisionConfig

WEIGHTS_NAME = "clip_embeds_tpu_model.npz"
CONFIG_NAME = "open_clip_config.json"


def _cfg_to_dict(cfg: CLIPConfig) -> Dict[str, Any]:
    # tuples -> lists, as JSON round-trips them
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def save_model_bundle(folder: str, model, model_name: Optional[str] = None,
                      pretrained_tag: Optional[str] = None) -> str:
    """Write ``model``'s weights (its flax tree, fp32) and config, with the
    pretrained tag's preprocess config, into ``folder``."""
    from .convert import jax_params_from_clip
    from .factory import save_params_npz

    params = jax_params_from_clip(model)
    os.makedirs(folder, exist_ok=True)
    save_params_npz(params, os.path.join(folder, WEIGHTS_NAME))
    preprocess_cfg: Dict[str, Any] = {"size": model.cfg.vision.image_size,
                                      "mode": "RGB"}
    if model_name and pretrained_tag:
        from .openclip_registry import get_pretrained_cfg

        pc = get_pretrained_cfg(model_name, pretrained_tag)
        for k in ("mean", "std", "interpolation", "resize_mode"):
            if k in pc:
                preprocess_cfg[k] = pc[k]
    config = {"model_cfg": _cfg_to_dict(model.cfg),
              "preprocess_cfg": preprocess_cfg}
    if model_name:
        config["model_name"] = model_name
    with open(os.path.join(folder, CONFIG_NAME), "w") as fh:
        json.dump(config, fh, indent=2)
    return folder


def load_model_bundle(folder: str,
                      device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.float32):
    """The port's CLIP of a bundle folder, in eval mode on ``device`` (the
    card by default; without one it raises) with parameters in
    ``dtype``."""
    from ..models.clip import CLIP
    from .convert import state_dict_from_jax_params
    from .factory import resolve_device, unflatten_params

    device = resolve_device(str(device))
    with open(os.path.join(folder, CONFIG_NAME)) as fh:
        mc = json.load(fh)["model_cfg"]
    vision = VisionConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in mc["vision"].items()})
    cfg = CLIPConfig(**{
        **{k: v for k, v in mc.items() if k not in ("vision", "text")},
        "vision": vision, "text": TextConfig(**mc["text"])})
    with np.load(os.path.join(folder, WEIGHTS_NAME)) as data:
        params = unflatten_params({k: data[k] for k in data.files})
    with torch.device("meta"):  # the loaded tensors become the weights
        model = CLIP(cfg)
    model.load_state_dict(state_dict_from_jax_params(params), assign=True)
    return model.to(device=device, dtype=dtype).eval()


def push_to_hub(folder: str, repo_id: str, token: Optional[str] = None,
                private: bool = False) -> None:
    """Upload a bundle folder (needs ``huggingface_hub`` and a network)."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError(
            "push_to_hub needs the huggingface_hub package (not installed "
            "in this environment); the local bundle folder is complete and "
            "can be uploaded from any connected machine") from e
    api = HfApi(token=token)
    api.create_repo(repo_id, private=private, exist_ok=True)
    api.upload_folder(folder_path=folder, repo_id=repo_id)
