"""Weights across packages: open_clip state dicts in, the JAX package's
flax CLIP params back to an open_clip state dict, and the PACL/SPARC heads'
flax params to and from the port's heads.

:func:`state_dict_from_jax_params` inverts
``clip_embeds_tpu/core/torch_convert.py`` ``convert_clip_state_dict`` for
the plain ViT + text layout: flax Dense kernels are [in, out] and come back
as ``nn.Linear`` [out, in] weights, ``in_proj`` is repacked into
``attn.in_proj_weight``, and the patch kernel, whose rows are ordered
(kh, kw, cin), is rebuilt into ``visual.conv1.weight`` [W, 3, p, p].

:func:`head_state_dict_from_jax_params` and :func:`jax_params_from_head`
carry a head (``models/heads.py``, whose submodule names are flax's) across:
a Dense ``kernel`` [in, out] is ``nn.Linear.weight`` [out, in], a LayerNorm
``scale`` is its ``weight``.

:func:`siglip_state_dict_from_hf` loads HF ``SiglipModel`` weights into the
port's SigLIP (``models/siglip.py``), as the JAX
``convert_siglip_state_dict`` reads them;
:func:`siglip_state_dict_from_jax_params` carries the JAX ``Siglip`` params
across, for the tests.
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
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


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


def state_dict_from_jax_params(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.clip.CLIP`` (ViT tower), as
    numpy arrays -> open_clip CLIP state dict of fp32 tensors."""
    v, t = params["visual"], params["text"]
    kernel = np.asarray(v["patch_embed"]["kernel"])       # [p*p*3, W]
    width = kernel.shape[1]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    conv = kernel.reshape(p, p, 3, width).transpose(3, 2, 0, 1)
    sd: Dict[str, torch.Tensor] = {
        "visual.conv1.weight": _t(conv),
        "visual.class_embedding": _t(v["class_embedding"]),
        "visual.positional_embedding": _t(v["positional_embedding"]),
        "visual.proj": _t(v["proj"]),
    }
    if "ln_pre" in v:
        sd.update(_ln(v["ln_pre"], "visual.ln_pre"))
    sd.update(_transformer(v["transformer"], "visual.transformer"))
    sd.update(_ln(v["ln_post"], "visual.ln_post"))
    sd["token_embedding.weight"] = _t(t["token_embedding"]["embedding"])
    sd["positional_embedding"] = _t(t["positional_embedding"])
    sd.update(_transformer(t["transformer"], "transformer"))
    sd.update(_ln(t["ln_final"], "ln_final"))
    sd["text_projection"] = _t(t["text_projection"])
    sd["logit_scale"] = _t(np.asarray(params["logit_scale"]).reshape(()))
    if "logit_bias" in params:
        sd["logit_bias"] = _t(np.asarray(params["logit_bias"]).reshape(()))
    return sd


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


def siglip_state_dict_from_jax_params(params: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.siglip.Siglip`` (numpy
    arrays) -> the port's :class:`Siglip` state dict of fp32 tensors: Dense
    kernels [in, out] become ``[out, in]`` weights, LayerNorm scales
    weights, ``blocks_{i}`` ``blocks.{i}``, the MAP head's
    ``in_proj_kernel`` [W, 3W] its ``in_proj_weight`` [3W, W]."""
    out: Dict[str, torch.Tensor] = {}

    def walk(p: Mapping[str, Any], prefix: str) -> None:
        for name, value in p.items():
            key = prefix + (name.replace("blocks_", "blocks.")
                            if name.startswith("blocks_") else name)
            if isinstance(value, Mapping):
                walk(value, key + ".")
            elif name == "kernel":
                out[prefix + "weight"] = _t(np.asarray(value).T)
            elif name in ("scale", "embedding"):
                out[prefix + "weight"] = _t(value)
            elif name == "in_proj_kernel":
                out[prefix + "in_proj_weight"] = _t(np.asarray(value).T)
            else:  # bias, in_proj_bias, probe, position_embedding, logits
                out[key] = _t(np.asarray(value))

    walk(params, "")
    return out
