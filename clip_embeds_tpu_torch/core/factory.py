"""Model factory: name -> the port's CLIP, with seeded random weights or a
local open_clip state dict (counterpart of ``clip_embeds_tpu/core/
factory.py``; nothing is downloaded); and the JAX package's ``.npz``
parameter files (``save_params_npz`` / ``load_params_npz``: flax trees
flattened to "a/b/kernel" keys), in which the PACL/SPARC heads travel; and
:func:`init_llava`, a seeded LLaVA built where it will run."""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Union

import numpy as np

import torch
from torch import nn

from ..models.clip import CLIP
from ..models.layers import Remat
from .config import get_model_config
from .convert import load_open_clip_state_dict

_CKPT_EXTS = (".pt", ".pth", ".bin")


def _init_tower(tower_blocks, width: int, layers: int,
                g: torch.Generator) -> None:
    """open_clip's block init (``init_parameters``), from generator g."""
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    for blk in tower_blocks:
        nn.init.normal_(blk.attn.in_proj_weight, std=attn_std, generator=g)
        nn.init.normal_(blk.attn.out_proj.weight, std=proj_std, generator=g)
        nn.init.normal_(blk.mlp.c_fc.weight, std=fc_std, generator=g)
        nn.init.normal_(blk.mlp.c_proj.weight, std=proj_std, generator=g)
        for lin in (blk.mlp.c_fc, blk.mlp.c_proj, blk.attn.out_proj):
            nn.init.zeros_(lin.bias)
        nn.init.zeros_(blk.attn.in_proj_bias)


@torch.no_grad()
def init_params(model: CLIP, seed: int = 0) -> None:
    """Seeded random init in place, on the CPU in fp32, so one seed gives
    the same weights whatever the target device and dtype."""
    g = torch.Generator().manual_seed(seed)
    cfg = model.cfg
    v, t = cfg.vision, cfg.text
    vis = model.visual
    scale = v.width ** -0.5
    fan_in = 3 * v.patch_size ** 2
    nn.init.normal_(vis.conv1.weight, std=fan_in ** -0.5, generator=g)
    nn.init.normal_(vis.class_embedding, std=scale, generator=g)
    nn.init.normal_(vis.positional_embedding, std=scale, generator=g)
    nn.init.normal_(vis.proj, std=scale, generator=g)
    _init_tower(vis.transformer.resblocks, v.width, v.layers, g)
    nn.init.normal_(model.token_embedding.weight, std=0.02, generator=g)
    nn.init.normal_(model.positional_embedding, std=0.01, generator=g)
    nn.init.normal_(model.text_projection, std=t.width ** -0.5, generator=g)
    _init_tower(model.transformer.resblocks, t.width, t.layers, g)
    model.logit_scale.fill_(math.log(1 / 0.07))


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on. ``'cuda'`` (the entry points'
    default) must exist: without a card the command exits with an error
    instead of running on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def device_name(device: torch.device) -> str:
    """The card's name, or 'cpu', for an entry point's output."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def create_model(
    name: str,
    pretrained: Optional[str] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
    remat: Remat = False,
    block_impl: str = "composable",
    compute_dtype: Optional[torch.dtype] = None,
    force_quick_gelu: bool = False,
    train: bool = False,
) -> CLIP:
    """Build the port's CLIP on ``device`` with parameters in ``dtype``.

    ``pretrained`` may be None, a tag ('openai' selects QuickGELU; the
    weights are still seeded random), or the path of a torch checkpoint
    (``.pt``/``.pth``/``.bin``) holding an open_clip state dict.
    ``remat``, ``block_impl`` and ``compute_dtype`` (default: ``dtype``)
    are the training options of :class:`~..models.clip.CLIP`; the model is
    returned in train mode when ``train``, else in eval mode.
    """
    cfg = get_model_config(name, pretrained)
    if force_quick_gelu:
        cfg = cfg.replace(quick_gelu=True)
    model = CLIP(cfg, block_impl=block_impl, remat=remat,
                 compute_dtype=compute_dtype)
    if pretrained and os.path.exists(pretrained):
        sd = torch.load(pretrained, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        load_open_clip_state_dict(model, sd)
    elif pretrained and pretrained.endswith(_CKPT_EXTS):
        raise FileNotFoundError(pretrained)
    else:
        init_params(model, seed)
    return model.to(device=device, dtype=dtype).train(train)


def flatten_params(params: Dict[str, Any], prefix: str = ""
                   ) -> Dict[str, np.ndarray]:
    """A nested params dict -> {"a/b/kernel": array}, the JAX package's
    ``flatten_params``."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(params: Dict[str, Any], path: str) -> None:
    """Write a params tree as the JAX package's ``save_params_npz`` does
    (``np.savez``, which adds ".npz" to a path without it)."""
    np.savez(path, **flatten_params(params))


def load_params_npz(path: str) -> Dict[str, Any]:
    """Read an ``.npz`` params file of either package into a nested dict of
    numpy arrays."""
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


@torch.no_grad()
def init_llava(cfg, seed: int = 0,
               device: Union[str, torch.device] = "cuda",
               dtype: torch.dtype = torch.bfloat16):
    """A :class:`~..models.llava.Llava` of config ``cfg`` with seeded random
    weights, allocated on ``device`` in ``dtype`` and drawn there from a
    ``torch.Generator`` of that device: the vision tower at open_clip's
    block scales, the projector and the Llama trunk at HF's
    ``initializer_range`` (normals of std 0.02, zero biases, norms at
    one). No copy is made on the host, so a 7B model is built on the card
    directly. A seed gives other values on another device type (each has
    its own generator stream)."""
    from ..models.llava import Llava

    device = torch.device(device)
    with torch.device("meta"):
        model = Llava(cfg).to(dtype)
    model.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    vis, v = model.vision_tower, cfg.vision
    nn.init.normal_(vis.conv1.weight, std=(3 * v.patch_size ** 2) ** -0.5,
                    generator=g)
    nn.init.normal_(vis.class_embedding, std=v.width ** -0.5, generator=g)
    nn.init.normal_(vis.positional_embedding, std=v.width ** -0.5,
                    generator=g)
    _init_tower(vis.transformer.resblocks, v.width, v.layers, g)
    for name, p in model.named_parameters():
        if name.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight",
                          "ln_post.weight", "norm.weight",
                          "layernorm.weight")):
            p.fill_(1.0)
        elif name.endswith(("ln_1.bias", "ln_2.bias", "ln_pre.bias",
                            "ln_post.bias")):
            p.zero_()
        elif not name.startswith("vision_tower."):
            if name.endswith("bias"):
                p.zero_()
            else:
                nn.init.normal_(p, std=0.02, generator=g)
    return model.eval()
