"""Model factory: name -> the port's CLIP, with seeded random weights or a
local open_clip state dict (counterpart of ``clip_embeds_tpu/core/
factory.py``; nothing is downloaded), or for a registry ``coca_*`` name
the port's CoCa (:func:`create_coca_model`); and the JAX package's ``.npz``
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
from .config import MODEL_CONFIGS, get_model_config
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


# the last layer of each residual branch in the zoo towers (and the
# BatchNorm after a bottleneck's last conv), drawn at fan-in^-1/2 and then
# scaled by (branches)^-1/2, as open_clip scales its blocks' out_proj and
# c_proj by (2 layers)^-1/2
_ZOO_BRANCH_ENDS = ("attn.proj.weight", "attn.out_proj.weight",
                    "mlp.fc2.weight", "mlp.c_proj.weight", "mlp.w2.weight",
                    "conv3_1x1.weight", "token_mixer.proj.weight",
                    "bn3.weight")


@torch.no_grad()
def init_zoo_tower(tower: nn.Module, g: torch.Generator) -> None:
    """Seeded values, in place, for a zoo vision tower: norms at one and
    zero (BatchNorm statistics at 0 / 1), biases zero, layer scales at one,
    matrices and conv kernels normal at fan-in^-1/2, the other tensors
    (class tokens, positional embeddings, relative-position tables) normal
    at 0.02; then the residual branches' last layers, and the LayerNorms
    that close a post-norm block's branches, scaled by (branches)^-1/2,
    so the stream stays near unit scale at any depth (unscaled, 64
    post-norm EVA02-E blocks saturate every softmax)."""
    done = set()
    for m in tower.modules():
        if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
            done.update(id(p) for p in m.parameters())
    for name, p in tower.named_parameters():
        if id(p) in done:
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("bias"):
            p.zero_()
        elif leaf == "gamma":
            p.fill_(1.0)
        elif p.dim() >= 2 and leaf in ("weight", "in_proj_weight"):
            nn.init.normal_(p, std=p[0].numel() ** -0.5, generator=g)
        else:
            nn.init.normal_(p, std=0.02, generator=g)
    ends = [p for name, p in tower.named_parameters()
            if name.endswith(_ZOO_BRANCH_ENDS)]
    for m in tower.modules():  # EVA02-E's post-norm blocks
        if getattr(m, "post", False) and hasattr(m, "norm2"):
            ends += [m.norm1.weight, m.norm2.weight]
            ends = [p for p in ends if p is not m.attn.proj.weight
                    and p is not m.mlp.fc2.weight]
    for p in ends:
        p.mul_(len(ends) ** -0.5)


@torch.no_grad()
def init_params(model: CLIP, seed: int = 0,
                generator: Optional[torch.Generator] = None) -> None:
    """Seeded random init in place, on the CPU in fp32, so one seed gives
    the same weights whatever the target device and dtype; or from
    ``generator``, on its device (a model there: no host copy, other
    values than the CPU's for the seed)."""
    g = generator or torch.Generator().manual_seed(seed)
    cfg = model.cfg
    v, t = cfg.vision, cfg.text
    vis = model.visual
    if v.tower == "vit":
        scale = v.width ** -0.5
        fan_in = 3 * v.patch_size ** 2
        nn.init.normal_(vis.conv1.weight, std=fan_in ** -0.5, generator=g)
        nn.init.normal_(vis.class_embedding, std=scale, generator=g)
        nn.init.normal_(vis.positional_embedding, std=scale, generator=g)
        nn.init.normal_(vis.proj, std=scale, generator=g)
        _init_tower(vis.transformer.resblocks, v.width, v.layers, g)
    else:
        init_zoo_tower(vis, g)
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


@torch.no_grad()
def _empty_clip(cfg, **kw) -> CLIP:
    """``CLIP(cfg, **kw)`` on the CPU without PyTorch's default init, which
    the seeded init or a loaded state dict overwrites (for ViT-L, about 2 s
    of host time a build): built on the meta device, given storage, and
    its LayerNorms and logit scale and bias set to their defaults, the
    values no init draws."""
    with torch.device("meta"):
        model = CLIP(cfg, **kw)
    model.to_empty(device="cpu")
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
    model.logit_scale.fill_(float(cfg.init_logit_scale))
    if model.logit_bias is not None:
        model.logit_bias.fill_(float(cfg.init_logit_bias))
    return model


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
    (``.pt``/``.pth``/``.bin``) holding an open_clip state dict. Every
    registry name whose backend is 'clip' builds (the zoo towers too);
    the other backends raise NotImplementedError, as in JAX.
    ``remat``, ``block_impl`` and ``compute_dtype`` (default: ``dtype``)
    are the training options of :class:`~..models.clip.CLIP` (on a zoo
    model ``block_impl`` reaches the text tower alone, and ModifiedResNet
    takes no ``remat``); the model is returned in train mode when
    ``train``, else in eval mode. The meta-device build leaves
    ModifiedResNet's BatchNorm statistics at mean 0 / var 1, where the
    seeded init keeps them and a loaded state dict sets them.
    ``force_quick_gelu`` and ``force_patch_dropout`` override the config
    (open_clip's ``--force-quick-gelu`` / ``--force-patch-dropout``).
    A registry ``coca_*`` name (outside the hand-written configs) builds a
    CoCa through :func:`create_coca_model`, which takes ``pretrained``,
    ``seed``, ``dtype``, ``device``, ``compute_dtype``,
    ``force_quick_gelu`` and ``train``; as JAX's ``create_model``, it
    forwards none of ``remat``, ``block_impl`` or ``force_patch_dropout``
    (``cli/train.py`` exits on the flags that set them).
    """
    from .openclip_registry import is_coca

    if name not in MODEL_CONFIGS and is_coca(name):
        # CoCa archs build their own model class, as in JAX
        return create_coca_model(
            name.replace("/", "-"), pretrained, seed=seed, dtype=dtype,
            device=device, compute_dtype=compute_dtype,
            force_quick_gelu=force_quick_gelu, train=train)
    cfg = get_model_config(name, pretrained)
    if force_quick_gelu:
        cfg = cfg.replace(quick_gelu=True)
    if force_patch_dropout is not None:
        cfg = cfg.replace(vision=dataclasses.replace(
            cfg.vision, patch_dropout=force_patch_dropout))
    model = _empty_clip(cfg, block_impl=block_impl, remat=remat,
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


def create_model_and_transforms(name: str, pretrained: Optional[str] = None,
                                aug_cfg=None, **kw):
    """(model, preprocess, tokenizer), or with ``aug_cfg`` (a dict or an
    ``image.transform.AugmentationCfg``) (model, preprocess, tokenizer,
    preprocess_train): JAX's ``create_model_and_transforms`` without its
    params (the port's model holds them). ``preprocess`` takes the
    pretrained tag's mean / std / interpolation / resize mode from the
    registry (``image.transform.pretrained_preprocess_cfg``); ``kw`` goes
    to :func:`create_model`."""
    from ..image.transform import (
        image_transform_v2,
        pretrained_preprocess_cfg,
    )
    from ..text.tokenizer import get_tokenizer

    model = create_model(name, pretrained, **kw)
    size = model.cfg.vision.image_size
    tag = pretrained if (pretrained and not os.path.exists(pretrained)) \
        else ""
    pp_cfg = pretrained_preprocess_cfg(name.replace("/", "-"), tag, size)
    preprocess = image_transform_v2(pp_cfg, is_train=False)
    tokenizer = get_tokenizer(model.cfg.text.context_length)
    if aug_cfg is not None:
        return model, preprocess, tokenizer, image_transform_v2(
            pp_cfg, is_train=True, aug_cfg=aug_cfg)
    return model, preprocess, tokenizer


# the pretrained tags whose CoCa checkpoints need QuickGELU (none in the
# registry, as in JAX)
_QUICK_GELU_TAGS_COCA: tuple = ()


@torch.no_grad()
def init_coca(model: nn.Module, g: torch.Generator) -> None:
    """Seeded values, in place, for every tensor of a CoCa whose storage
    is allocated but not set: norms at one and zero, the three towers'
    blocks at open_clip's block scales (:func:`_init_tower`), the patchify
    at (3 p^2)^-1/2, the class and positional embeddings and the
    projections at width^-1/2, the token embedding at 0.02, the text
    positions and CLS at 0.01, the pooler's queries at 1 (as JAX's), the
    other weights at fan-in^-1/2, biases zero, the logit scale at the
    config's."""
    from ..models.coca import CoCa

    assert isinstance(model, CoCa)
    cfg = model.cfg
    done = set()
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif isinstance(getattr(m, "resblocks", None), nn.ModuleList):
            width = m.resblocks[0].ln_1.weight.shape[0]
            _init_tower(m.resblocks, width, len(m.resblocks), g)
            m = m.resblocks
        else:
            continue
        done.update(id(p) for p in m.parameters())
    v = cfg.vision
    named = {
        "visual.conv1.weight": (3 * v.patch_size ** 2) ** -0.5,
        "visual.class_embedding": v.width ** -0.5,
        "visual.positional_embedding": v.width ** -0.5,
        "visual.proj": cfg.embed_dim ** -0.5,
        "visual.attn_pool.query": 1.0,
        "text.token_embedding.weight": 0.02,
        "text.positional_embedding": 0.01,
        "text.cls_emb": 0.01,
        "text.text_projection": cfg.text.width ** -0.5,
        "text_decoder.text_projection": cfg.multimodal.width ** -0.5,
    }
    for pname, p in model.named_parameters():
        if id(p) in done:
            continue
        if pname == "logit_scale":
            p.fill_(float(cfg.init_logit_scale))
        elif pname.endswith("bias"):
            p.zero_()
        else:
            std = named.get(pname, p.shape[-1] ** -0.5)
            nn.init.normal_(p, std=std, generator=g)


def create_coca_model(
    name: str,
    pretrained: Optional[str] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
    compute_dtype: Optional[torch.dtype] = None,
    force_quick_gelu: bool = False,
    train: bool = False,
) -> nn.Module:
    """A ``models/coca.py CoCa`` of registry name ``name`` (JAX
    ``create_coca_model``) on ``device`` with parameters in ``dtype``:
    from the open_clip CoCa state dict at ``pretrained`` (a ``.pt`` /
    ``.pth`` / ``.bin`` path) or seeded (:func:`init_coca`), built on the
    meta device and drawn on ``device`` from a ``torch.Generator`` of that
    device, so a seed gives other values on another device type.
    ``compute_dtype`` (default ``dtype``) is the dtype the towers compute
    in; train mode when ``train``."""
    from ..models.coca import CoCa
    from .openclip_registry import resolve_coca_config

    device = resolve_device(str(device))
    cfg = resolve_coca_config(name)
    if force_quick_gelu or pretrained in _QUICK_GELU_TAGS_COCA:
        cfg = dataclasses.replace(cfg, quick_gelu=True)
    with torch.device("meta"):
        model = CoCa(cfg, compute_dtype=compute_dtype)
    if pretrained and os.path.exists(pretrained):
        sd = torch.load(pretrained, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        model.to_empty(device="cpu")
        load_open_clip_state_dict(model, sd)
        model.to(device=device, dtype=dtype)
    elif pretrained and pretrained.endswith(_CKPT_EXTS):
        raise FileNotFoundError(pretrained)
    else:
        model.to(dtype).to_empty(device=device)
        init_coca(model, torch.Generator(device=device).manual_seed(seed))
    return model.train(train)


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
