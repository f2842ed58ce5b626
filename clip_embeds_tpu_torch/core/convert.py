"""Weights across packages: open_clip state dicts in, the JAX package's
flax CLIP params back to an open_clip state dict, and the PACL/SPARC heads'
flax params to and from the port's heads.

:func:`state_dict_from_jax_params` inverts
``clip_embeds_tpu/core/torch_convert.py`` ``convert_clip_state_dict`` for
the plain ViT + text layout and EVA01's: flax Dense kernels are [in, out]
and come back as ``nn.Linear`` [out, in] weights, ``in_proj`` is repacked
into ``attn.in_proj_weight``, and the patch kernel, whose rows are ordered
(kh, kw, cin), is rebuilt into the conv [W, 3, p, p];
:func:`jax_params_from_clip` writes the same trees from the port's CLIP
(``core/export.py``).

:func:`head_state_dict_from_jax_params` and :func:`jax_params_from_head`
carry a head (``models/heads.py``, whose submodule names are flax's) across:
a Dense ``kernel`` [in, out] is ``nn.Linear.weight`` [out, in], a LayerNorm
``scale`` is its ``weight``.

:func:`llava_state_dict_from_hf` loads an HF
``LlavaForConditionalGeneration`` state dict (either key layout) into the
port's ``models/llava.py`` :class:`Llava`, as the JAX
``convert_llava_state_dict`` reads it;
:func:`vlm_state_dict_from_jax_params` carries the JAX ``Llava`` params
(a score bundle's ``params.npz``, int8 trunks included) across, and those
of VLM2Vec's other backbones.

:func:`siglip_state_dict_from_hf` loads HF ``SiglipModel`` weights into the
port's SigLIP (``models/siglip.py``), as the JAX
``convert_siglip_state_dict`` reads them.

CoCa's modules keep open_clip's names, so an open_clip CoCa state dict
loads with ``load_state_dict`` (and the JAX package's
``convert_coca_state_dict`` reads the port's ``state_dict()`` as it is);
:func:`coca_state_dict_from_flax` carries a JAX CoCa's flax tree in.

The models whose module names are flax's (the Llama trunk, SigLIP,
CLIP-FlanT5's T5, InstructBLIP-FlanT5, BLIP-2, ImageReward):
:func:`state_dict_from_flax` carries a flax tree into the port
(:func:`vlm_state_dict_from_jax_params` and
:func:`clip_t5_state_dict_from_jax_params` add their CLIP tower), and
:func:`jax_params_from_module` carries any of these models (and LLaVA)
back; ``convert_*_state_dict`` read the HF layouts of the T5 and BLIP
families into the same flax trees the JAX converters give.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# Keys of OpenAI's original checkpoints that are not parameters.
_NON_PARAM_KEYS = ("input_resolution", "context_length", "vocab_size")


def load_open_clip_state_dict(model: torch.nn.Module,
                              sd: Mapping[str, Any]) -> None:
    """Load an open_clip (or OpenAI) CLIP state dict into the port's CLIP.

    A ``module.`` prefix (DataParallel checkpoints) is stripped; every
    parameter must be present (strict load)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    model.load_state_dict({k: v for k, v in sd.items()
                           if k not in _NON_PARAM_KEYS})


def _t(a) -> torch.Tensor:
    # a writable, C-contiguous copy (a transposed kernel comes back in the
    # layout nn.Linear's own weights have)
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _ln(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]),
            f"{prefix}.bias": _t(p["bias"])}


def _linear(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}.bias": _t(p["bias"])}


def _transformer(p: Mapping[str, Any], prefix: str
                 ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"resblocks_{i}" in p:
        bp, pre = p[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        out.update(_ln(bp["ln_1"], pre + ".ln_1"))
        out[pre + ".attn.in_proj_weight"] = _t(
            np.asarray(bp["attn"]["in_proj"]["kernel"]).T)
        out[pre + ".attn.in_proj_bias"] = _t(bp["attn"]["in_proj"]["bias"])
        out.update(_linear(bp["attn"]["out_proj"], pre + ".attn.out_proj"))
        out.update(_ln(bp["ln_2"], pre + ".ln_2"))
        out.update(_linear(bp["mlp"]["c_fc"], pre + ".mlp.c_fc"))
        out.update(_linear(bp["mlp"]["c_proj"], pre + ".mlp.c_proj"))
        i += 1
    return out


def _vision_tower(v: Mapping[str, Any], prefix: str, head: bool = True
                  ) -> Dict[str, torch.Tensor]:
    """A flax ``VisionTransformer``'s params (numpy) -> the port's tower
    state dict under ``prefix``, without the output projection; without
    ``ln_post`` either unless ``head``."""
    kernel = np.asarray(v["patch_embed"]["kernel"])       # [p*p*3, W]
    width = kernel.shape[1]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    conv = kernel.reshape(p, p, 3, width).transpose(3, 2, 0, 1)
    sd: Dict[str, torch.Tensor] = {
        f"{prefix}.conv1.weight": _t(conv),
        f"{prefix}.class_embedding": _t(v["class_embedding"]),
        f"{prefix}.positional_embedding": _t(v["positional_embedding"]),
    }
    if "ln_pre" in v:
        sd.update(_ln(v["ln_pre"], f"{prefix}.ln_pre"))
    sd.update(_transformer(v["transformer"], f"{prefix}.transformer"))
    if head:
        sd.update(_ln(v["ln_post"], f"{prefix}.ln_post"))
    return sd


def _eva01_tower(v: Mapping[str, Any], prefix: str
                 ) -> Dict[str, torch.Tensor]:
    """A flax ``EVAVisionTower``'s params -> the port's EVA01 tower under
    ``prefix`` in its Transformer's names (its load pre-hook takes them)."""
    kernel = np.asarray(v["patch_embed"]["kernel"])       # [p*p*3, W]
    width = kernel.shape[1]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    sd = {f"{prefix}.patch_embed.proj.weight": _t(
              kernel.reshape(p, p, 3, width).transpose(3, 2, 0, 1)),
          f"{prefix}.patch_embed.proj.bias": _t(v["patch_embed"]["bias"]),
          f"{prefix}.cls_token": _t(np.reshape(v["cls_token"],
                                               (1, 1, width))),
          f"{prefix}.pos_embed": _t(np.asarray(v["pos_embed"])[None])}
    sd.update(_transformer(v["blocks"], f"{prefix}.blocks"))
    sd.update(_ln(v["norm"], f"{prefix}.norm"))
    sd.update(_linear(v["head"], f"{prefix}.head"))
    return sd


def state_dict_from_jax_params(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.clip.CLIP`` (ViT or EVA01
    tower), as numpy arrays -> the port's CLIP state dict of fp32 tensors
    (open_clip's, or EVA01's Transformer names)."""
    v, t = params["visual"], params["text"]
    if "cls_token" in v:
        sd = _eva01_tower(v, "visual.trunk")
    else:
        sd = _vision_tower(v, "visual")
        sd["visual.proj"] = _t(v["proj"])
    sd["token_embedding.weight"] = _t(t["token_embedding"]["embedding"])
    sd["positional_embedding"] = _t(t["positional_embedding"])
    sd.update(_transformer(t["transformer"], "transformer"))
    sd.update(_ln(t["ln_final"], "ln_final"))
    sd["text_projection"] = _t(t["text_projection"])
    sd["logit_scale"] = _t(np.asarray(params["logit_scale"]).reshape(()))
    if "logit_bias" in params:
        sd["logit_bias"] = _t(np.asarray(params["logit_bias"]).reshape(()))
    return sd


def _flax_blocks(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The port's ``{prefix}.resblocks.{i}`` (open_clip names) -> a flax
    ``Transformer``'s ``resblocks_{i}`` tree."""
    out: Dict[str, Any] = {}
    i = 0
    while f"{prefix}.resblocks.{i}.ln_1.weight" in sd:
        pre = f"{prefix}.resblocks.{i}"
        out[f"resblocks_{i}"] = {
            "ln_1": _flax_ln(sd, pre + ".ln_1"),
            "attn": {"in_proj": {
                         "kernel": _hf(sd, pre + ".attn.in_proj_weight").T,
                         "bias": _hf(sd, pre + ".attn.in_proj_bias")},
                     "out_proj": _flax_linear(sd, pre + ".attn.out_proj")},
            "ln_2": _flax_ln(sd, pre + ".ln_2"),
            "mlp": {"c_fc": _flax_linear(sd, pre + ".mlp.c_fc"),
                    "c_proj": _flax_linear(sd, pre + ".mlp.c_proj")},
        }
        i += 1
    return out


def _flax_patch(conv_weight: np.ndarray) -> np.ndarray:
    """A stride-p conv [W, 3, p, p] -> JAX's patchify kernel [p*p*3, W]
    (rows in (kh, kw, cin) order)."""
    return conv_weight.transpose(2, 3, 1, 0).reshape(-1,
                                                     conv_weight.shape[0])


def jax_params_from_clip(model: torch.nn.Module) -> Dict[str, Any]:
    """The port's CLIP -> the flax tree of JAX's ``CLIP`` (numpy fp32), the
    inverse of :func:`state_dict_from_jax_params`: the ViT and EVA01 vision
    towers. The other zoo towers raise NotImplementedError: their flax
    layouts are JAX's converters' own (ROADMAP.md queue 1 item 15d)."""
    sd = dict(model.named_parameters())
    tower = model.cfg.vision.tower
    if tower == "vit":
        visual = {"patch_embed": {"kernel": _flax_patch(
                      _hf(sd, "visual.conv1.weight"))},
                  "class_embedding": _hf(sd, "visual.class_embedding"),
                  "positional_embedding": _hf(sd,
                                              "visual.positional_embedding"),
                  "transformer": _flax_blocks(sd, "visual.transformer"),
                  "ln_post": _flax_ln(sd, "visual.ln_post"),
                  "proj": _hf(sd, "visual.proj")}
        if "visual.ln_pre.weight" in sd:
            visual["ln_pre"] = _flax_ln(sd, "visual.ln_pre")
    elif tower == "eva":
        pre = "visual.trunk"
        visual = {"patch_embed": {
                      "kernel": _flax_patch(_hf(sd, pre + ".patch_embed"
                                                ".proj.weight")),
                      "bias": _hf(sd, pre + ".patch_embed.proj.bias")},
                  "cls_token": _hf(sd, pre + ".cls_token").reshape(-1),
                  "pos_embed": _hf(sd, pre + ".pos_embed")[0],
                  "blocks": _flax_blocks(sd, pre + ".blocks"),
                  "norm": _flax_ln(sd, pre + ".norm"),
                  "head": _flax_linear(sd, pre + ".head")}
    else:
        raise NotImplementedError(
            f"the {tower!r} vision tower has no flax writer in the port: "
            "its layout is JAX's converters' own (ROADMAP.md queue 1 item "
            "15d)")
    text = {"token_embedding": {"embedding": _hf(sd,
                                                 "token_embedding.weight")},
            "positional_embedding": _hf(sd, "positional_embedding"),
            "transformer": _flax_blocks(sd, "transformer"),
            "ln_final": _flax_ln(sd, "ln_final"),
            "text_projection": _hf(sd, "text_projection")}
    params = {"visual": visual, "text": text,
              "logit_scale": _hf(sd, "logit_scale")}
    if "logit_bias" in sd:
        params["logit_bias"] = _hf(sd, "logit_bias")
    return params


def head_state_dict_from_jax_params(params: Mapping[str, Any], prefix: str = ""
                                    ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.heads`` PACLHead / SPARCHead
    (numpy arrays) -> the port's head state dict of fp32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if isinstance(value, Mapping):
            out.update(head_state_dict_from_jax_params(
                value, f"{prefix}{name}."))
        elif name == "kernel":
            out[prefix + "weight"] = _t(np.asarray(value).T)
        elif name == "scale":
            out[prefix + "weight"] = _t(value)
        elif name == "bias":
            out[prefix + "bias"] = _t(value)
        else:
            raise KeyError(f"unexpected head parameter {prefix}{name}")
    return out


def jax_params_from_head(head: torch.nn.Module) -> Dict[str, Any]:
    """The port's head -> flax params (nested dicts of float32 numpy
    arrays), the layout the JAX heads and ``save_params_npz`` use."""
    tree: Dict[str, Any] = {}
    for name, module in head.named_modules():
        if isinstance(module, torch.nn.Linear):
            leaf = {"kernel": module.weight.detach().float().cpu().numpy().T}
        elif isinstance(module, torch.nn.LayerNorm):
            leaf = {"scale": module.weight.detach().float().cpu().numpy()}
        else:
            continue
        leaf["bias"] = module.bias.detach().float().cpu().numpy()
        node = tree
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[name.split(".")[-1]] = {k: np.ascontiguousarray(v)
                                     for k, v in leaf.items()}
    return tree


# -- SigLIP ------------------------------------------------------------------


def _hf(sd: Mapping[str, Any], key: str) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def siglip_state_dict_from_hf(sd: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """HF ``SiglipModel`` state dict -> the port's ``models/siglip.py``
    :class:`Siglip` state dict of fp32 tensors. Reads what the JAX
    ``convert_siglip_state_dict`` (``clip_embeds_tpu/models/siglip.py``)
    reads: q/k/v packed into ``in_proj`` (q, k, v stacked on the output
    axis), the patch conv [W, 3, p, p] flattened in patchify's (kh, kw, c)
    order, the probe [1, 1, W] as [1, W]; other keys (``position_ids``)
    are ignored."""
    out: Dict[str, torch.Tensor] = {}

    def lin(src: str, dst: str) -> None:
        out[dst + ".weight"] = _t(_hf(sd, src + ".weight"))
        out[dst + ".bias"] = _t(_hf(sd, src + ".bias"))

    for tower in ("vision_model", "text_model"):
        i = 0
        while f"{tower}.encoder.layers.{i}.layer_norm1.weight" in sd:
            src, dst = f"{tower}.encoder.layers.{i}", f"{tower}.blocks.{i}"
            attn = f"{src}.self_attn"
            for part in ("weight", "bias"):
                out[f"{dst}.in_proj.{part}"] = _t(np.concatenate(
                    [_hf(sd, f"{attn}.{x}_proj.{part}") for x in "qkv"]))
            lin(f"{attn}.out_proj", f"{dst}.out_proj")
            lin(f"{src}.layer_norm1", f"{dst}.ln_1")
            lin(f"{src}.layer_norm2", f"{dst}.ln_2")
            lin(f"{src}.mlp.fc1", f"{dst}.fc1")
            lin(f"{src}.mlp.fc2", f"{dst}.fc2")
            i += 1
        out[f"{tower}.position_embedding"] = _t(_hf(
            sd, f"{tower}.embeddings.position_embedding.weight"))
    conv = _hf(sd, "vision_model.embeddings.patch_embedding.weight")
    out["vision_model.patch_embed.weight"] = _t(
        conv.transpose(0, 2, 3, 1).reshape(conv.shape[0], -1))
    out["vision_model.patch_embed.bias"] = _t(
        _hf(sd, "vision_model.embeddings.patch_embedding.bias"))
    lin("vision_model.post_layernorm", "vision_model.post_layernorm")
    head = "vision_model.head"
    out[head + ".probe"] = _t(_hf(sd, head + ".probe").reshape(1, -1))
    out[head + ".in_proj_weight"] = _t(
        _hf(sd, head + ".attention.in_proj_weight"))
    out[head + ".in_proj_bias"] = _t(_hf(sd, head + ".attention.in_proj_bias"))
    lin(head + ".attention.out_proj", head + ".out_proj")
    lin(head + ".layernorm", head + ".ln")
    lin(head + ".mlp.fc1", head + ".fc1")
    lin(head + ".mlp.fc2", head + ".fc2")
    out["text_model.token_embedding.weight"] = _t(
        _hf(sd, "text_model.embeddings.token_embedding.weight"))
    lin("text_model.final_layer_norm", "text_model.final_layer_norm")
    lin("text_model.head", "text_model.head")
    for name in ("logit_scale", "logit_bias"):
        out[name] = _t(_hf(sd, name).reshape(()))
    return out


# -- LLaVA -------------------------------------------------------------------


def _normalize_llava_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The newer transformers LLaVA layout (``model.vision_tower.*``,
    ``model.language_model.*``, top-level ``lm_head``) renamed to the
    classic ``vision_tower.`` / ``multi_modal_projector.`` /
    ``language_model.model.`` / ``language_model.lm_head`` keys (the JAX
    ``normalize_llava_state_dict``)."""
    if not any(k.startswith("model.vision_tower.") for k in sd):
        return dict(sd)
    renamed = {(k[len("model."):] if k.startswith("model.") else k): v
               for k, v in sd.items()}
    if "lm_head.weight" in renamed:
        renamed["language_model.lm_head.weight"] = renamed.pop(
            "lm_head.weight")
    out: Dict[str, Any] = {}
    for k, v in renamed.items():
        if k.startswith("language_model.") and not k.startswith(
                ("language_model.model.", "language_model.lm_head")):
            k = "language_model.model." + k[len("language_model."):]
        out[k] = v
    return out


def _tapped_blocks(sd: Dict[str, torch.Tensor], cfg,
                   tower: str = "vision_tower") -> Dict[str, torch.Tensor]:
    """``sd`` without the blocks of the CLIP tower under ``tower`` past
    the hidden tap (``cfg.tower_blocks``), which the port's tower does not
    hold."""
    pre = f"{tower}.transformer.resblocks."
    return {k: v for k, v in sd.items() if not (
        k.startswith(pre)
        and int(k[len(pre):].split(".")[0]) >= cfg.tower_blocks)}


def llava_state_dict_from_hf(sd: Mapping[str, Any], cfg
                             ) -> Dict[str, torch.Tensor]:
    """HF ``LlavaForConditionalGeneration`` state dict (llava-hf layout,
    old or new key spelling) -> the state dict of fp32 tensors of the
    port's :class:`Llava` of config ``cfg`` (``models/llava.py
    LlavaConfig``), through the flax tree the JAX converter gives
    (:func:`convert_llava_state_dict`): the HF CLIP tower's separate
    q/k/v projections packed into ``attn.in_proj`` (q, k, v stacked),
    ``pre_layrnorm`` (sic) as ``ln_pre``; keys the port's model does not
    hold (``post_layernorm``, which the tap never reads, ``position_ids``)
    are dropped."""
    return vlm_state_dict_from_jax_params(convert_llava_state_dict(sd), cfg)


def flax_module_path(name: str, sep: str = "/") -> str:
    """A module name of the port's LLaVA / Llama (``language_model.model.
    layers.3.self_attn.q_proj``) -> its flax scope path
    (``language_model/model/layers_3/self_attn/q_proj``): a list index
    joins its list's name with '_'."""
    out: list = []
    for part in name.split("."):
        if part.isdigit():
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return sep.join(out)


def lora_targets_by_key(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """The LoRA adapter key of each linear layer of ``model`` -> the layer:
    the flat canonical key of JAX ``models/lora.py`` (the flax path of the
    Dense kernel, ``.../q_proj/kernel``, also over a QuantDense's
    ``kernel_q``), so that an adapter file of either package addresses the
    same layers. Orientation stays JAX's: a [in, r], b [r, out]."""
    from ..models.quant import QuantLinear

    return {flax_module_path(name) + "/kernel": m
            for name, m in model.named_modules()
            if isinstance(m, (torch.nn.Linear, QuantLinear))}


def jax_params_from_module(model: torch.nn.Module) -> Dict[str, Any]:
    """Any of the port's models whose module names are flax's (LLaVA,
    CLIP-FlanT5, InstructBLIP, BLIP-2, ImageReward) -> its flax params:
    nested dicts of numpy arrays, float32 and int8 ``kernel_q``, the
    layout of a score bundle's ``params.npz``. A linear layer's ``weight``
    [out, in] is a Dense ``kernel`` [in, out]; an embedding's ``weight``
    its ``embedding``; a LayerNorm's ``weight`` its ``scale``; an RMS or
    T5 norm keeps ``weight``; a packed attention's ``in_proj_weight`` is
    ``in_proj/kernel``; the CLIP tower's ``conv1`` is ``patch_embed``; a
    list index joins its list's name with '_'; any other parameter keeps
    its name."""
    from ..models.layers import LayerNorm, MultiHeadAttention
    from ..models.llama import RMSNorm
    from ..models.quant import QuantLinear
    from ..models.t5 import T5LayerNorm
    from ..models.vit import VisionTransformer

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return np.ascontiguousarray(
            t.numpy() if t.dtype == torch.int8 else t.float().numpy())

    tree: Dict[str, Any] = {}

    def put(path: str, leaf: Dict[str, np.ndarray]) -> None:
        node = tree
        for part in (path.split(".") if path else []):
            node = node.setdefault(part, {})
        node.update(leaf)

    for name, m in model.named_modules():
        path = flax_module_path(name, ".") if name else ""
        if isinstance(m, QuantLinear):
            leaf = {"kernel_q": arr(m.weight_q).T, "scale": arr(m.scale)}
            if m.bias is not None:
                leaf["bias"] = arr(m.bias)
            if m.mode == "static":
                leaf["act_scale"] = arr(m.act_scale)
            put(path, leaf)
        elif isinstance(m, torch.nn.Linear):
            leaf = {"kernel": arr(m.weight).T}
            if m.bias is not None:
                leaf["bias"] = arr(m.bias)
            put(path, leaf)
        elif isinstance(m, torch.nn.Embedding):
            put(path, {"embedding": arr(m.weight)})
        elif isinstance(m, (RMSNorm, T5LayerNorm)):
            put(path, {"weight": arr(m.weight)})
        elif isinstance(m, LayerNorm):
            put(path, {"scale": arr(m.weight), "bias": arr(m.bias)})
        elif isinstance(m, torch.nn.Conv2d):
            continue  # the CLIP tower's patchify, written with the tower
        elif isinstance(m, MultiHeadAttention):
            if not hasattr(m, "in_proj"):
                put(path + ".in_proj", {"kernel": arr(m.in_proj_weight).T,
                                        "bias": arr(m.in_proj_bias)})
        else:
            own = {k: arr(v) for k, v in m.named_parameters(recurse=False)}
            if isinstance(m, VisionTransformer):
                conv = arr(m.conv1.weight)
                width, cin, p, _ = conv.shape
                own["patch_embed"] = {"kernel": np.ascontiguousarray(
                    conv.transpose(2, 3, 1, 0).reshape(p * p * cin, width))}
            if own:
                put(path, own)
    return tree


# -- flax trees in, generically ------------------------------------------------

# the flax names of lists of modules: ``block_3`` is the port's ``block.3``
_LIST_NAMES = ("block", "blocks", "layer", "layers", "resblocks", "mlp")


def _port_name(name: str) -> str:
    head, _, idx = name.rpartition("_")
    return f"{head}.{idx}" if head in _LIST_NAMES and idx.isdigit() else name


def state_dict_from_flax(params: Mapping[str, Any], prefix: str = "",
                         packed_in_proj: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """A flax param tree (numpy arrays) of one of the port's models whose
    module names are flax's -> its state dict under ``prefix``, the
    inverse of :func:`jax_params_from_module` without the CLIP tower's
    conv: Dense kernels [in, out] become ``[out, in]`` weights, embeddings
    and LayerNorm scales ``weight``, an ``in_proj`` Dense the packed
    attention's ``in_proj_weight`` / ``in_proj_bias`` (with
    ``packed_in_proj=False``, for SigLIP's blocks, a linear ``in_proj``),
    SigLIP's MAP head's ``in_proj_kernel`` its ``in_proj_weight``,
    ``block_{i}`` ``block.{i}`` (``_LIST_NAMES``), and each QuantDense the
    QuantLinear buffers (a dynamic layer's ``act_scale`` and every
    ``act_max`` start at 1 and 0)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        if "kernel_q" in node:  # a QuantDense
            sd[prefix + "weight_q"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(node["kernel_q"]).T))
            sd[prefix + "scale"] = _t(node["scale"])
            if "bias" in node:
                sd[prefix + "bias"] = _t(node["bias"])
            sd[prefix + "act_scale"] = _t(np.asarray(
                node.get("act_scale", 1.0)).reshape(()))
            sd[prefix + "act_max"] = torch.zeros(())
            return
        for name, value in node.items():
            if isinstance(value, Mapping):
                if packed_in_proj and name == "in_proj" and "kernel" in value:
                    sd[prefix + "in_proj_weight"] = _t(
                        np.asarray(value["kernel"]).T)
                    sd[prefix + "in_proj_bias"] = _t(value["bias"])
                else:
                    walk(value, f"{prefix}{_port_name(name)}.")
            elif name in ("kernel", "in_proj_kernel"):
                sd[prefix + name.replace("kernel", "weight")] = _t(
                    np.asarray(value).T)
            elif name in ("embedding", "scale"):
                sd[prefix + "weight"] = _t(value)
            else:  # bias, a norm's weight, an embedding parameter
                sd[prefix + name] = _t(value)

    walk(params, prefix)
    return sd


def clip_t5_state_dict_from_jax_params(params: Mapping[str, Any], cfg
                                       ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.clip_t5.CLIPT5`` (numpy
    arrays, a score bundle's tree, int8 T5 projections included) -> the
    state dict of the port's :class:`~..models.clip_t5.CLIPT5` of config
    ``cfg``. As for LLaVA, the tower's ``ln_post``, projection and blocks
    past the tap (in a tree converted from HF) are not carried."""
    sd = _vision_tower(params["vision_tower"], "vision_tower", head=False)
    for name, lin in params["multi_modal_projector"].items():
        sd.update(_linear(lin, f"multi_modal_projector.{name}"))
    sd.update(state_dict_from_flax(params["t5"], "t5."))
    return _tapped_blocks(sd, cfg)


# -- HF layouts: T5, BLIP-2, InstructBLIP, CLIP-FlanT5, ImageReward ----------
#
# Each ``convert_*`` reads what the JAX function of the same name
# (``core/torch_convert.py``, ``models/blip.py``) reads and returns the same
# flax-layout tree of numpy arrays; :func:`state_dict_from_flax` (or
# :func:`clip_t5_state_dict_from_jax_params`) carries it into the port.


def _flax_linear(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _hf(sd, prefix + ".weight").T}
    if prefix + ".bias" in sd:
        out["bias"] = _hf(sd, prefix + ".bias")
    return out


def _flax_dense_nb(sd: Mapping[str, Any], prefix: str
                   ) -> Dict[str, np.ndarray]:
    return {"kernel": _hf(sd, prefix + ".weight").T}


def _flax_ln(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _hf(sd, prefix + ".weight"),
            "bias": _hf(sd, prefix + ".bias")}


def _count(sd: Mapping[str, Any], pattern: str) -> int:
    n = 0
    while pattern.format(n) in sd:
        n += 1
    return n


def _t5_attn(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {name: _flax_dense_nb(sd, f"{prefix}.{name}")
                           for name in ("q", "k", "v", "o")}
    if f"{prefix}.relative_attention_bias.weight" in sd:
        out["relative_attention_bias"] = {"embedding": _hf(
            sd, f"{prefix}.relative_attention_bias.weight")}
    return out


def _t5_stack(sd: Mapping[str, Any], prefix: str, is_decoder: bool
              ) -> Dict[str, Any]:
    stack: Dict[str, Any] = {}
    for i in range(_count(sd, prefix + ".block.{}.layer.0.layer_norm.weight")):
        p = f"{prefix}.block.{i}.layer"
        blk: Dict[str, Any] = {
            "self_ln": {"weight": _hf(sd, f"{p}.0.layer_norm.weight")},
            "self_attn": _t5_attn(sd, f"{p}.0.SelfAttention"),
        }
        ff = 1
        if is_decoder:
            blk["cross_ln"] = {"weight": _hf(sd, f"{p}.1.layer_norm.weight")}
            blk["cross_attn"] = _t5_attn(sd, f"{p}.1.EncDecAttention")
            ff = 2
        blk["ff_ln"] = {"weight": _hf(sd, f"{p}.{ff}.layer_norm.weight")}
        dense = f"{p}.{ff}.DenseReluDense"
        names = (("wi_0", "wi_1", "wo") if f"{dense}.wi_0.weight" in sd
                 else ("wi", "wo"))
        blk["ff"] = {n: _flax_dense_nb(sd, f"{dense}.{n}") for n in names}
        stack[f"block_{i}"] = blk
    stack["final_ln"] = {"weight": _hf(sd, f"{prefix}.final_layer_norm.weight")}
    return stack


def convert_t5_state_dict(sd: Mapping[str, Any], prefix: str = ""
                          ) -> Dict[str, Any]:
    """HF ``T5ForConditionalGeneration`` -> the flax tree of
    ``models/t5.py`` (``lm_head`` where the checkpoint has one)."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {
        "shared": {"embedding": _hf(sd, "shared.weight")},
        "encoder": _t5_stack(sd, "encoder", is_decoder=False),
        "decoder": _t5_stack(sd, "decoder", is_decoder=True),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = _flax_dense_nb(sd, "lm_head")
    return params


def _bert_attn(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        "query": _flax_linear(sd, f"{prefix}.attention.query"),
        "key": _flax_linear(sd, f"{prefix}.attention.key"),
        "value": _flax_linear(sd, f"{prefix}.attention.value"),
        "out_dense": _flax_linear(sd, f"{prefix}.output.dense"),
        "out_ln": _flax_ln(sd, f"{prefix}.output.LayerNorm"),
    }


def _blip2_vision(sd: Mapping[str, Any], prefix: str = "vision_model"
                  ) -> Dict[str, Any]:
    """HF Blip2 / InstructBlip vision model -> the tower's flax tree. The
    qkv bias is read as ``self_attn.qkv.bias`` ([q_bias; 0; v_bias], the
    layout HF builds); a state dict that holds ``q_bias`` / ``v_bias``
    apart raises rather than load without them."""
    conv = _hf(sd, f"{prefix}.embeddings.patch_embedding.weight")
    width, cin, p, _ = conv.shape
    blocks: Dict[str, Any] = {}
    for i in range(_count(sd, prefix + ".encoder.layers.{}.layer_norm1.weight")):
        pre = f"{prefix}.encoder.layers.{i}"
        if f"{pre}.self_attn.qkv.bias" not in sd and (
                f"{pre}.self_attn.q_bias" in sd):
            raise ValueError(
                f"{pre}.self_attn holds q_bias / v_bias apart: store them "
                "as self_attn.qkv.bias = [q_bias; 0; v_bias]")
        blocks[f"resblocks_{i}"] = {
            "ln_1": _flax_ln(sd, f"{pre}.layer_norm1"),
            "attn": {
                "in_proj": _flax_linear(sd, f"{pre}.self_attn.qkv"),
                "out_proj": _flax_linear(sd, f"{pre}.self_attn.projection"),
            },
            "ln_2": _flax_ln(sd, f"{pre}.layer_norm2"),
            "mlp": {
                "c_fc": _flax_linear(sd, f"{pre}.mlp.fc1"),
                "c_proj": _flax_linear(sd, f"{pre}.mlp.fc2"),
            },
        }
    return {
        "patch_embed": {
            "kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * cin, width),
            "bias": _hf(sd, f"{prefix}.embeddings.patch_embedding.bias"),
        },
        "class_embedding": _hf(
            sd, f"{prefix}.embeddings.class_embedding").reshape(-1),
        "positional_embedding": _hf(
            sd, f"{prefix}.embeddings.position_embedding").reshape(-1, width),
        "transformer": blocks,
        "post_layernorm": _flax_ln(sd, f"{prefix}.post_layernorm"),
    }


def _qformer_layers(sd: Mapping[str, Any], prefix: str = "qformer"
                    ) -> Dict[str, Any]:
    """HF Blip2 / InstructBlip Q-Former layers -> ``layer_{i}`` trees
    (without the input LayerNorm, whose key differs between the two)."""
    layers: Dict[str, Any] = {}
    n = _count(sd, prefix + ".encoder.layer.{}.attention.attention.query.weight")
    for i in range(n):
        pre = f"{prefix}.encoder.layer.{i}"
        layer: Dict[str, Any] = {
            "attention": _bert_attn(sd, f"{pre}.attention"),
            "ffn_query": {
                "intermediate": _flax_linear(
                    sd, f"{pre}.intermediate_query.dense"),
                "output": _flax_linear(sd, f"{pre}.output_query.dense"),
                "ln": _flax_ln(sd, f"{pre}.output_query.LayerNorm"),
            },
        }
        if f"{pre}.crossattention.attention.query.weight" in sd:
            layer["crossattention"] = _bert_attn(sd, f"{pre}.crossattention")
        if f"{pre}.intermediate.dense.weight" in sd:
            layer["ffn"] = {
                "intermediate": _flax_linear(sd, f"{pre}.intermediate.dense"),
                "output": _flax_linear(sd, f"{pre}.output.dense"),
                "ln": _flax_ln(sd, f"{pre}.output.LayerNorm"),
            }
        layers[f"layer_{i}"] = layer
    return layers


def _query_tokens(sd: Mapping[str, Any]) -> np.ndarray:
    q = _hf(sd, "query_tokens")
    return q.reshape(-1, q.shape[-1])


def convert_blip2_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``Blip2ForImageTextRetrieval`` -> the flax tree of
    ``models/blip2.py Blip2ITM``."""
    return {
        "vision_model": _blip2_vision(sd),
        "query_tokens": _query_tokens(sd),
        "word_embeddings": {
            "embedding": _hf(sd, "embeddings.word_embeddings.weight")},
        "position_embeddings": {
            "embedding": _hf(sd, "embeddings.position_embeddings.weight")},
        "qformer": dict(_qformer_layers(sd),
                        input_ln=_flax_ln(sd, "qformer.layernorm")),
        "vision_projection": _flax_linear(sd, "vision_projection"),
        "text_projection": _flax_linear(sd, "text_projection"),
        "itm_head": _flax_linear(sd, "itm_head"),
    }


def convert_instructblip_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``InstructBlipForConditionalGeneration`` (FlanT5 LM) -> the flax
    tree of ``models/instructblip.py InstructBlipT5``."""
    return {
        "vision_model": _blip2_vision(sd),
        "query_tokens": _query_tokens(sd),
        "word_embeddings": {"embedding": _hf(
            sd, "qformer.embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": _hf(
            sd, "qformer.embeddings.position_embeddings.weight")},
        "qformer": dict(_qformer_layers(sd),
                        input_ln=_flax_ln(sd, "qformer.embeddings.layernorm")),
        "language_projection": _flax_linear(sd, "language_projection"),
        "t5": convert_t5_state_dict(sd, prefix="language_model."),
    }


def convert_hf_clip_vision_state_dict(sd: Mapping[str, Any],
                                      prefix: str = "vision_model."
                                      ) -> Dict[str, Any]:
    """HF ``CLIPVisionModel`` -> the flax tree of a ``VisionTransformer``:
    q/k/v packed into ``in_proj`` (q, k, v stacked), ``pre_layrnorm``
    (sic) as ``ln_pre``; a zero ``proj``, which the hidden tap never
    reads."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    conv = _hf(sd, "embeddings.patch_embedding.weight")
    width, cin, p, _ = conv.shape
    blocks: Dict[str, Any] = {}
    for i in range(_count(sd, "encoder.layers.{}.layer_norm1.weight")):
        pre = f"encoder.layers.{i}.self_attn"
        blocks[f"resblocks_{i}"] = {
            "ln_1": _flax_ln(sd, f"encoder.layers.{i}.layer_norm1"),
            "attn": {
                "in_proj": {
                    "kernel": np.concatenate([_hf(
                        sd, f"{pre}.{x}_proj.weight") for x in "qkv"]).T,
                    "bias": np.concatenate([_hf(
                        sd, f"{pre}.{x}_proj.bias") for x in "qkv"]),
                },
                "out_proj": _flax_linear(sd, f"{pre}.out_proj"),
            },
            "ln_2": _flax_ln(sd, f"encoder.layers.{i}.layer_norm2"),
            "mlp": {
                "c_fc": _flax_linear(sd, f"encoder.layers.{i}.mlp.fc1"),
                "c_proj": _flax_linear(sd, f"encoder.layers.{i}.mlp.fc2"),
            },
        }
    return {
        "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(
            p * p * cin, width)},
        "class_embedding": _hf(sd, "embeddings.class_embedding"),
        "positional_embedding": _hf(sd, "embeddings.position_embedding.weight"),
        "ln_pre": _flax_ln(sd, "pre_layrnorm"),
        "transformer": blocks,
        "ln_post": _flax_ln(sd, "post_layernorm"),
        "proj": np.zeros((width, width), np.float32),
    }


def convert_clip_t5_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``CLIPT5ForConditionalGeneration`` (the clip-flant5-* checkpoints)
    -> the flax tree of ``models/clip_t5.py CLIPT5``: plain T5 keys at the
    top level, ``vision_tower.vision_tower.*`` (an HF CLIPVisionModel) and
    ``mm_projector.{0,2}`` (the mlp2x_gelu Sequential)."""
    vision = convert_hf_clip_vision_state_dict(
        sd, prefix="vision_tower.vision_tower.vision_model.")
    t5_sd = {k: v for k, v in sd.items()
             if not k.startswith(("vision_tower.", "mm_projector.",
                                  "embed_tokens."))}
    return {
        "vision_tower": vision,
        "multi_modal_projector": {
            "linear_1": _flax_linear(sd, "mm_projector.0"),
            "linear_2": _flax_linear(sd, "mm_projector.2"),
        },
        "t5": convert_t5_state_dict(t5_sd),
    }


def convert_blip_vision_state_dict(sd: Mapping[str, Any],
                                   prefix: str = "blip.visual_encoder."
                                   ) -> Dict[str, Any]:
    """Original-BLIP / timm ViT layout -> the flax tree of
    ``models/blip.py BlipVisionTower``."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    conv = _hf(sd, "patch_embed.proj.weight")
    width, cin, p, _ = conv.shape
    blocks: Dict[str, Any] = {}
    for i in range(_count(sd, "blocks.{}.norm1.weight")):
        pre = f"blocks.{i}"
        blocks[f"resblocks_{i}"] = {
            "ln_1": _flax_ln(sd, f"{pre}.norm1"),
            "attn": {"in_proj": _flax_linear(sd, f"{pre}.attn.qkv"),
                     "out_proj": _flax_linear(sd, f"{pre}.attn.proj")},
            "ln_2": _flax_ln(sd, f"{pre}.norm2"),
            "mlp": {"c_fc": _flax_linear(sd, f"{pre}.mlp.fc1"),
                    "c_proj": _flax_linear(sd, f"{pre}.mlp.fc2")},
        }
    return {
        "patch_embed": {
            "kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * cin, width),
            "bias": _hf(sd, "patch_embed.proj.bias"),
        },
        "cls_token": _hf(sd, "cls_token").reshape(-1),
        "pos_embed": _hf(sd, "pos_embed").reshape(-1, width),
        "blocks": blocks,
        "norm": _flax_ln(sd, "norm"),
    }


def convert_med_text_state_dict(sd: Mapping[str, Any],
                                prefix: str = "blip.text_encoder."
                                ) -> Dict[str, Any]:
    """med BertModel layout (``attention.self.query``, ...) -> the flax
    tree of ``models/blip.py BlipTextEncoder``."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items()
              if k.startswith("bert.")}

    def med_attn(pre: str) -> Dict[str, Any]:
        return {
            "query": _flax_linear(sd, f"{pre}.self.query"),
            "key": _flax_linear(sd, f"{pre}.self.key"),
            "value": _flax_linear(sd, f"{pre}.self.value"),
            "out_dense": _flax_linear(sd, f"{pre}.output.dense"),
            "out_ln": _flax_ln(sd, f"{pre}.output.LayerNorm"),
        }

    params: Dict[str, Any] = {
        "word_embeddings": {
            "embedding": _hf(sd, "embeddings.word_embeddings.weight")},
        "position_embeddings": {
            "embedding": _hf(sd, "embeddings.position_embeddings.weight")},
        "embeddings_ln": _flax_ln(sd, "embeddings.LayerNorm"),
    }
    for i in range(_count(sd, "encoder.layer.{}.attention.self.query.weight")):
        pre = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": med_attn(f"{pre}.attention"),
            "crossattention": med_attn(f"{pre}.crossattention"),
            "ffn": {
                "intermediate": _flax_linear(sd, f"{pre}.intermediate.dense"),
                "output": _flax_linear(sd, f"{pre}.output.dense"),
                "ln": _flax_ln(sd, f"{pre}.output.LayerNorm"),
            },
        }
    return params


def convert_image_reward_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """THUDM ImageReward checkpoint -> the flax tree of ``models/blip.py
    ImageReward``. The MLP's linear layers are ``mlp.layers.{0,2,4,6,7}``
    (the dropouts at 1, 3, 5 have no parameters)."""
    params: Dict[str, Any] = {
        "visual_encoder": convert_blip_vision_state_dict(sd),
        "text_encoder": convert_med_text_state_dict(sd),
    }
    for i, idx in enumerate((0, 2, 4, 6, 7)):
        params[f"mlp_{i}"] = _flax_linear(sd, f"mlp.layers.{idx}")
    return params


# -- VLM2Vec's backbones: LLaVA-NeXT, Phi-3-V, Qwen2-VL, Qwen2.5-VL -----------
#
# The HF converters are copies of the JAX package's (``core/
# torch_convert.py``, ``models/phi3_v.py``) and return the same flax trees;
# :func:`vlm_state_dict_from_jax_params` carries such a tree (or one the JAX
# package initialised) into the port's model, and
# :func:`jax_params_from_module` carries the port's model back.


def convert_llama_state_dict(sd: Mapping[str, Any], prefix: str = ""
                             ) -> Dict[str, Any]:
    """HF ``LlamaForCausalLM`` (or Qwen2, with q/k/v biases) -> the flax
    tree of the JAX ``LlamaForCausalLM``."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    layers: Dict[str, Any] = {}
    for i in range(_count(sd, "model.layers.{}.input_layernorm.weight")):
        p = f"model.layers.{i}"
        layers[f"layers_{i}"] = {
            "input_layernorm": {"weight": _hf(sd, p + ".input_layernorm"
                                                  ".weight")},
            "post_attention_layernorm": {
                "weight": _hf(sd, p + ".post_attention_layernorm.weight")},
            "self_attn": {name: _flax_linear(sd, f"{p}.self_attn.{name}")
                          for name in ("q_proj", "k_proj", "v_proj",
                                       "o_proj")},
            "mlp": {name: _flax_dense_nb(sd, f"{p}.mlp.{name}")
                    for name in ("gate_proj", "up_proj", "down_proj")},
        }
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": _hf(sd, "model.embed_tokens.weight")},
        "model": dict(layers, norm={"weight": _hf(sd, "model.norm.weight")}),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = _flax_dense_nb(sd, "lm_head")
    return params


def convert_llava_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``LlavaForConditionalGeneration`` (either key spelling) -> the
    flax tree of the JAX ``Llava``."""
    sd = _normalize_llava_keys(sd)
    return {
        "vision_tower": convert_hf_clip_vision_state_dict(
            sd, prefix="vision_tower.vision_model."),
        "multi_modal_projector": {
            "linear_1": _flax_linear(sd, "multi_modal_projector.linear_1"),
            "linear_2": _flax_linear(sd, "multi_modal_projector.linear_2"),
        },
        "language_model": convert_llama_state_dict(sd,
                                                   prefix="language_model."),
    }


def convert_llava_next_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``LlavaNextForConditionalGeneration`` -> the flax tree of the JAX
    ``LlavaNext``: the LLaVA layout and the learned ``image_newline``."""
    sd = dict(sd)
    key = "image_newline" if "image_newline" in sd else "model.image_newline"
    newline = _hf(sd, key)
    del sd[key]
    params = convert_llava_state_dict(sd)
    params["image_newline"] = newline
    return params


def convert_phi3v_image_embedding_state_dict(sd: Mapping[str, Any],
                                             prefix: str = ""
                                             ) -> Dict[str, Any]:
    """The reference's ``Phi3ImageEmbedding`` -> the flax tree of the JAX
    ``Phi3VImageEmbedding``: ``img_processor.vision_model.*`` (an HF
    CLIPVisionModel), ``glb_GN``, ``sub_GN`` and
    ``img_projection.{0,2}`` (projection_cls 'mlp')."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return {
        "img_processor": convert_hf_clip_vision_state_dict(
            sd, prefix="img_processor.vision_model."),
        "glb_GN": _hf(sd, "glb_GN").reshape(-1),
        "sub_GN": _hf(sd, "sub_GN").reshape(-1),
        "proj_1": _flax_linear(sd, "img_projection.0"),
        "proj_2": _flax_linear(sd, "img_projection.2"),
    }


def convert_phi3_v_state_dict(sd: Mapping[str, Any], cfg=None
                              ) -> Dict[str, Any]:
    """A whole HF Phi-3-V checkpoint -> the flax tree of the JAX ``Phi3V``:
    the trunk through the packed qkv / gate_up split (``models/phi3.py``)
    and the vision embedding (``model.vision_embed_tokens.*``)."""
    from ..models.phi3 import convert_phi3_state_dict
    from ..models.phi3_v import Phi3VConfig

    cfg = cfg or Phi3VConfig()
    lm = convert_phi3_state_dict(
        {k: v for k, v in sd.items()
         if not k.startswith("model.vision_embed_tokens.")}, cfg.text)
    vision = convert_phi3v_image_embedding_state_dict(
        sd, prefix="model.vision_embed_tokens.")
    return {"language_model": lm, "vision_embed": vision}


def _qwen_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The newer HF Qwen-VL layout (``model.visual.*``,
    ``model.language_model.*``) renamed to the older (``visual.*``,
    ``model.*``)."""
    sd = dict(sd)
    if not any(k.startswith("model.visual.") for k in sd):
        return sd
    out = {}
    for k, v in sd.items():
        if k.startswith("model.visual."):
            k = "visual." + k[len("model.visual."):]
        elif k.startswith("model.language_model."):
            k = "model." + k[len("model.language_model."):]
        out[k] = v
    return out


def _qwen_visual(sd: Mapping[str, Any], block, norm) -> Dict[str, Any]:
    conv = _hf(sd, "visual.patch_embed.proj.weight")  # [D, C, tp, p, p]
    blocks = {f"blocks_{i}": block(f"visual.blocks.{i}")
              for i in range(_count(sd, "visual.blocks.{}.norm1.weight"))}
    return dict(
        blocks,
        # conv3d with kernel == stride over the processor's (C, tp, ph, pw)
        patch_embed={"kernel": conv.reshape(conv.shape[0], -1).T},
        ln_q=norm("visual.merger.ln_q"),
        merger_fc1=_flax_linear(sd, "visual.merger.mlp.0"),
        merger_fc2=_flax_linear(sd, "visual.merger.mlp.2"),
    )


def convert_qwen2_vl_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``Qwen2VLForConditionalGeneration`` (either key layout) -> the
    flax tree of the JAX ``Qwen2VL``."""
    sd = _qwen_keys(sd)

    def block(pre):
        return {"norm1": _flax_ln(sd, f"{pre}.norm1"),
                "norm2": _flax_ln(sd, f"{pre}.norm2"),
                "qkv": _flax_linear(sd, f"{pre}.attn.qkv"),
                "proj": _flax_linear(sd, f"{pre}.attn.proj"),
                "fc1": _flax_linear(sd, f"{pre}.mlp.fc1"),
                "fc2": _flax_linear(sd, f"{pre}.mlp.fc2")}

    return {"visual": _qwen_visual(sd, block, lambda p: _flax_ln(sd, p)),
            "language_model": convert_llama_state_dict(
                {k: v for k, v in sd.items() if not k.startswith("visual.")})}


def convert_qwen2_5_vl_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``Qwen2_5_VLForConditionalGeneration`` -> the flax tree of the
    JAX ``Qwen25VL``: Qwen2-VL's layouts with RMSNorms (weight only) and
    the gate / up / down SiLU MLP in the vision blocks, an RMS ``ln_q``."""
    sd = _qwen_keys(sd)

    def rms(prefix):
        return {"weight": _hf(sd, prefix + ".weight")}

    def block(pre):
        return {"norm1": rms(f"{pre}.norm1"), "norm2": rms(f"{pre}.norm2"),
                "qkv": _flax_linear(sd, f"{pre}.attn.qkv"),
                "proj": _flax_linear(sd, f"{pre}.attn.proj"),
                **{name: _flax_linear(sd, f"{pre}.mlp.{name}")
                   for name in ("gate_proj", "up_proj", "down_proj")}}

    return {"visual": _qwen_visual(sd, block, rms),
            "language_model": convert_llama_state_dict(
                {k: v for k, v in sd.items() if not k.startswith("visual.")})}


def vlm_state_dict_from_jax_params(params: Mapping[str, Any], cfg
                                   ) -> Dict[str, torch.Tensor]:
    """The flax tree of one of VLM2Vec's backbones (the JAX ``Llava``,
    ``LlavaNext``, ``Phi3V``, ``Qwen2VL`` or ``Qwen25VL``; numpy arrays,
    e.g. a score bundle's ``params.npz``, int8 trunks included) -> the
    state dict of the port's model of config ``cfg``: fp32 tensors, and
    for a quantised trunk the QuantLinear buffers (``kernel_q`` [in, out]
    -> int8 ``weight_q`` [out, in], ``scale``, ``bias``, ``act_scale``; a
    dynamic layer's ``act_scale`` and every ``act_max`` start at 1 and 0).
    The CLIP tower (``vision_tower`` or ``vision_embed.img_processor``)
    goes through the open_clip layout without ``ln_post``, the output
    projection or the blocks past the tap (a tree converted from HF has
    them); everything else by its flax names (:func:`state_dict_from_flax`).
    """
    tree = {k: dict(v) if isinstance(v, Mapping) else v
            for k, v in params.items()}
    if "vision_tower" in tree:
        tower, clip = "vision_tower", tree.pop("vision_tower")
    elif "vision_embed" in tree:
        tower = "vision_embed.img_processor"
        clip = tree["vision_embed"].pop("img_processor")
    else:
        return state_dict_from_flax(tree)
    sd = state_dict_from_flax(tree)
    sd.update(_vision_tower(clip, tower, head=False))
    return _tapped_blocks(sd, cfg, tower)


# -- CoCa ---------------------------------------------------------------------


def coca_state_dict_from_flax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX CoCa's flax params (numpy) -> the port's (open_clip) state
    dict, the inverse of the JAX ``convert_coca_state_dict``: the blocks,
    norms, embeddings and projections through :func:`state_dict_from_flax`,
    then the three places where flax's names are not open_clip's: the
    patch kernel, rebuilt into ``visual.conv1.weight``; the pooler's
    ``q/k/v_proj`` Dense layers, into ``attn.{q,k,v}_proj_weight`` and one
    packed ``attn.in_proj_bias``; and each ``cross_attn_{i}``, whose
    packed projection and ``out_proj`` sit under ``cross_attn.{i}.attn``."""
    sd = state_dict_from_flax(params)
    kernel = np.asarray(params["visual"]["patch_embed"]["kernel"])
    width = kernel.shape[1]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    del sd["visual.patch_embed.weight"]
    sd["visual.conv1.weight"] = _t(kernel.reshape(p, p, 3, width).transpose(
        3, 2, 0, 1))
    pool = "visual.attn_pool."
    biases = []
    for n in "qkv":
        sd[f"{pool}attn.{n}_proj_weight"] = sd.pop(f"{pool}{n}_proj.weight")
        biases.append(sd.pop(f"{pool}{n}_proj.bias"))
    sd[pool + "attn.in_proj_bias"] = torch.cat(biases)
    for k in (pool + "out_proj.weight", pool + "out_proj.bias"):
        sd[k.replace("out_proj", "attn.out_proj")] = sd.pop(k)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if k.startswith("text_decoder.cross_attn_"):
            i, _, leaf = rest[len("cross_attn_"):].partition(".")
            if leaf.startswith(("in_proj_", "out_proj")):
                leaf = "attn." + leaf
            k = f"text_decoder.cross_attn.{i}.{leaf}"
        out[k] = v
    return out


def convert_pacl_head_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference PACL/SPARC heads' torch weights (``visual_projection``
    LayerNorm -> Dropout -> Patch_Projection, ``text_projection`` LayerNorm
    -> Dropout -> Linear; 'module.' prefixes allowed) -> the flax head tree
    (JAX's ``convert_pacl_head_state_dict``)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    vp = "visual_projection.2."
    return {
        "visual_projection": {
            "ln": _flax_ln(sd, "visual_projection.0"),
            "proj": {
                "linear": _flax_linear(sd, vp + "linear_projection.0"),
                "mlp_in": _flax_linear(sd, vp + "non_linear_projection.0"),
                "mlp_out": _flax_linear(sd, vp + "non_linear_projection.2"),
            },
        },
        "text_projection": {"ln": _flax_ln(sd, "text_projection.0"),
                            "proj": _flax_linear(sd, "text_projection.2")},
    }


def split_pacl_checkpoint(sd: Mapping[str, Any]):
    """A reference PACL/SPARC checkpoint (the whole DataParallel module,
    tower and heads) -> (the tower's open_clip state dict, the heads' flax
    tree), as JAX's ``split_pacl_checkpoint``."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    clip_sd = {k[len("clip_model."):]: v for k, v in sd.items()
               if k.startswith("clip_model.")}
    head_sd = {k: v for k, v in sd.items()
               if k.startswith(("visual_projection.", "text_projection."))}
    return clip_sd, convert_pacl_head_state_dict(head_sd)
