"""Model factory: name -> the port's CLIP, with seeded random weights or a
local open_clip state dict (counterpart of ``clip_embeds_tpu/core/
factory.py``; nothing is downloaded); and the JAX package's ``.npz``
parameter files (``save_params_npz`` / ``load_params_npz``: flax trees
flattened to "a/b/kernel" keys), in which the PACL/SPARC heads travel; and
:func:`init_llava`, :func:`init_score_model` and :func:`init_vlm`, a
seeded LLaVA, T5 / BLIP family model or VLM2Vec backbone built where it
will run."""

from __future__ import annotations

import dataclasses
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
    force_patch_dropout: Optional[float] = None,
    train: bool = False,
) -> CLIP:
    """Build the port's CLIP on ``device`` with parameters in ``dtype``.

    ``pretrained`` may be None, a tag ('openai' selects QuickGELU; the
    weights are still seeded random), or the path of a torch checkpoint
    (``.pt``/``.pth``/``.bin``) holding an open_clip state dict.
    ``remat``, ``block_impl`` and ``compute_dtype`` (default: ``dtype``)
    are the training options of :class:`~..models.clip.CLIP`; the model is
    returned in train mode when ``train``, else in eval mode.
    ``force_quick_gelu`` and ``force_patch_dropout`` override the config
    (open_clip's ``--force-quick-gelu`` / ``--force-patch-dropout``).
    """
    cfg = get_model_config(name, pretrained)
    if force_quick_gelu:
        cfg = cfg.replace(quick_gelu=True)
    if force_patch_dropout is not None:
        cfg = cfg.replace(vision=dataclasses.replace(
            cfg.vision, patch_dropout=force_patch_dropout))
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


def init_llava(cfg, seed: int = 0,
               device: Union[str, torch.device] = "cuda",
               dtype: torch.dtype = torch.bfloat16):
    """A :class:`~..models.llava.Llava` of config ``cfg`` with seeded random
    weights: :func:`init_vlm` of the ``llava_15`` family."""
    return init_vlm("llava_15", cfg, seed, device, dtype)


@torch.no_grad()
def init_vlm(name: str, cfg=None, seed: int = 0,
             device: Union[str, torch.device] = "cuda",
             dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """One of VLM2Vec's backbones (``name``: a family of
    ``models/backbones.py`` or an HF model name; ``cfg`` defaults to the
    family's config) with seeded random weights, built on the meta device,
    allocated on ``device`` in ``dtype`` and drawn there from a
    ``torch.Generator`` of that device (no host copy), so a 7B model is
    built on the card directly: norms at one and zero, every CLIP tower
    at open_clip's scales (the patchify at (3 p^2)^-1/2, the class and
    positional embeddings at width^-1/2, the blocks at open_clip's block
    scales), LLaVA-NeXT's ``image_newline`` at hidden^-1/2 (the JAX
    init), other biases zero, other weights (trunks, projections, the
    Qwen towers, Phi-3-V's separators) normals of std 0.02 (HF's
    ``initializer_range``). A seed gives other values on another device
    type (each has its own generator stream). Without a card ``device``
    must be 'cpu'.
    Qwen2-VL's W8A8 twin: ``models/quant.py quantize_llava_trunk``."""
    from ..models.backbones import get_backbone
    from ..models.llama import RMSNorm
    from ..models.vit import VisionTransformer

    device = resolve_device(str(device))
    backbone = get_backbone(name)
    with torch.device("meta"):
        model = backbone.model_cls(cfg or backbone.config_factory())
    model.to(dtype).to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    done = set()
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, RMSNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, VisionTransformer):
            v = m.cfg
            nn.init.normal_(m.conv1.weight, std=(3 * v.patch_size ** 2)
                            ** -0.5, generator=g)
            for p in (m.class_embedding, m.positional_embedding):
                nn.init.normal_(p, std=v.width ** -0.5, generator=g)
            _init_tower(m.transformer.resblocks, v.width, v.layers, g)
        else:
            continue
        done.update(id(p) for p in m.parameters())
    for pname, p in model.named_parameters():
        if id(p) in done:
            continue
        if pname.endswith("bias"):
            p.zero_()
        else:
            std = p.shape[-1] ** -0.5 if pname == "image_newline" else 0.02
            nn.init.normal_(p, std=std, generator=g)
    return model.eval()


def _t5_std(name: str, cfg) -> float:
    """HF ``T5PreTrainedModel._init_weights``' std (factor 1.0) of a T5
    parameter named within the T5 module; ``lm_head`` at d_model^-0.5
    (HF draws it at 1.0, whose logits of std ~sqrt(d_model) would put
    every seeded score near exp(-100))."""
    d, kv, heads = cfg.d_model, cfg.d_kv, cfg.num_heads
    if name == "shared.weight":
        return 1.0
    leaf = name.split(".")[-2]
    return {"q": (d * kv) ** -0.5, "k": d ** -0.5, "v": d ** -0.5,
            "o": (heads * kv) ** -0.5, "relative_attention_bias": d ** -0.5,
            "wi_0": d ** -0.5, "wi_1": d ** -0.5, "wi": d ** -0.5,
            "wo": cfg.d_ff ** -0.5, "lm_head": d ** -0.5}[leaf]


@torch.no_grad()
def init_score_model(model: nn.Module, seed: int = 0,
                     device: Union[str, torch.device] = "cuda",
                     dtype: torch.dtype = torch.bfloat16,
                     t5: Optional[nn.Module] = None) -> nn.Module:
    """Seeded random weights, drawn on ``device`` in ``dtype`` from a
    ``torch.Generator`` of that device, for one of the T5 / BLIP family
    models (``CLIPT5``, ``InstructBlipT5``, ``Blip2ITM``, ``ImageReward``)
    built on the meta device; no host copy is made. The T5 trunk takes
    HF's T5 scales (:func:`_t5_std`); the vision towers open_clip's block
    scales (the patchify at (3 p^2)^-1/2, the class and positional
    embeddings at width^-1/2); the Q-Former, the BERT text encoder and the
    projections BERT's std 0.02, ImageReward's MLP in^-1/2 (so its reward
    spreads); norms at one, biases at zero. With ``t5`` (a model's
    ``t5`` module, e.g. CLIP-FlanT5's) that trunk is shared instead of
    drawn: InstructBLIP-FlanT5 and CLIP-FlanT5 share one T5-XXL."""
    from ..models.layers import Transformer
    from ..models.t5 import T5LayerNorm

    device = torch.device(device)
    shared = t5 is not None
    for name, child in model.named_children():
        if not (shared and name == "t5"):
            child.to(dtype).to_empty(device=device)
    for name, p in list(model.named_parameters(recurse=False)):
        setattr(model, name, nn.Parameter(
            torch.empty(p.shape, dtype=dtype, device=device)))
    if shared:
        model.t5 = t5
    g = torch.Generator(device=device).manual_seed(seed)
    done = set()  # the towers' blocks and every norm, set first
    for name, m in model.named_modules():
        if name.startswith("t5") and shared:
            continue
        if isinstance(m, (nn.LayerNorm, T5LayerNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
            done.update(id(p) for p in m.parameters())
        elif isinstance(m, Transformer):
            width = m.resblocks[0].ln_1.weight.shape[0]
            _init_tower(m.resblocks, width, len(m.resblocks), g)
            done.update(id(p) for p in m.parameters())
    for name, p in model.named_parameters():
        if id(p) in done or (shared and name.startswith("t5.")):
            continue
        if name.startswith("t5."):
            std = _t5_std(name[len("t5."):], model.cfg.t5)
        elif name.endswith("bias"):
            p.zero_()
            continue
        elif name.endswith(("class_embedding", "cls_token",
                            "positional_embedding", "pos_embed")):
            std = p.shape[-1] ** -0.5
        elif name.endswith(("patch_embed.weight", "conv1.weight")):
            std = p[0].numel() ** -0.5
        elif name.startswith("mlp."):
            std = p.shape[-1] ** -0.5
        else:
            std = 0.02
        p.normal_(0.0, std, generator=g)
    return model.requires_grad_(False).eval()
