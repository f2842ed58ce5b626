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

:func:`llava_state_dict_from_hf` loads an HF
``LlavaForConditionalGeneration`` state dict (either key layout) into the
port's ``models/llava.py`` :class:`Llava`, as the JAX
``convert_llava_state_dict`` reads it;
:func:`llava_state_dict_from_jax_params` carries the JAX ``Llava`` params
(a score bundle's ``params.npz``, int8 trunks included) across, and
:func:`jax_params_from_llava` carries the port's model back.

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


def state_dict_from_jax_params(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.clip.CLIP`` (ViT tower), as
    numpy arrays -> open_clip CLIP state dict of fp32 tensors."""
    v, t = params["visual"], params["text"]
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


def _tapped_blocks(sd: Dict[str, torch.Tensor], cfg
                   ) -> Dict[str, torch.Tensor]:
    """``sd`` without the vision blocks past the LLaVA tap
    (``cfg.tower_blocks``), which the port's tower does not hold."""
    pre = "vision_tower.transformer.resblocks."
    return {k: v for k, v in sd.items() if not (
        k.startswith(pre)
        and int(k[len(pre):].split(".")[0]) >= cfg.tower_blocks)}


def llava_state_dict_from_hf(sd: Mapping[str, Any], cfg
                             ) -> Dict[str, torch.Tensor]:
    """HF ``LlavaForConditionalGeneration`` state dict (llava-hf layout,
    old or new key spelling) -> the state dict of fp32 tensors of the
    port's :class:`Llava` of config ``cfg`` (``models/llava.py
    LlavaConfig``). The HF CLIP tower's separate q/k/v projections are
    packed into ``attn.in_proj`` (q, k, v stacked), ``pre_layrnorm`` (sic)
    is ``ln_pre``, fc1/fc2 are ``c_fc``/``c_proj``; the projector and the
    Llama trunk keep HF's names, the token embedding moves to
    ``language_model.embed_tokens``. Other keys (``post_layernorm``, which
    the tap never reads, ``position_ids``) are ignored."""
    sd = _normalize_llava_keys(sd)
    out: Dict[str, torch.Tensor] = {}

    def copy(src: str, dst: str) -> None:
        out[dst] = _t(_hf(sd, src))

    vis, dst = "vision_tower.vision_model.", "vision_tower."
    copy(vis + "embeddings.patch_embedding.weight", dst + "conv1.weight")
    copy(vis + "embeddings.class_embedding", dst + "class_embedding")
    copy(vis + "embeddings.position_embedding.weight",
         dst + "positional_embedding")
    for part in ("weight", "bias"):
        copy(f"{vis}pre_layrnorm.{part}", f"{dst}ln_pre.{part}")
    i = 0
    while f"{vis}encoder.layers.{i}.layer_norm1.weight" in sd:
        src, blk = f"{vis}encoder.layers.{i}", f"{dst}transformer.resblocks.{i}"
        for part in ("weight", "bias"):
            out[f"{blk}.attn.in_proj_{part}"] = _t(np.concatenate(
                [_hf(sd, f"{src}.self_attn.{x}_proj.{part}") for x in "qkv"]))
            for a, b in (("self_attn.out_proj", "attn.out_proj"),
                         ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
                copy(f"{src}.{a}.{part}", f"{blk}.{b}.{part}")
        i += 1
    for key in sd:
        if key.startswith("multi_modal_projector."):
            copy(key, key)
        elif key == "language_model.model.embed_tokens.weight":
            copy(key, "language_model.embed_tokens.weight")
        elif key.startswith(("language_model.model.layers.",
                             "language_model.model.norm.",
                             "language_model.lm_head.")):
            copy(key, key)
    return _tapped_blocks(out, cfg)


def llava_state_dict_from_jax_params(params: Mapping[str, Any], cfg
                                     ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.llava.Llava`` (numpy arrays,
    e.g. a score bundle's ``params.npz``) -> the state dict of the port's
    :class:`Llava` of config ``cfg``: fp32 tensors, and for a quantised trunk the QuantLinear
    buffers (``kernel_q`` [in, out] -> int8 ``weight_q`` [out, in],
    ``scale``, ``bias``, ``act_scale``; a dynamic layer's ``act_scale``
    and every ``act_max`` start at 1 and 0). The vision tower's
    ``ln_post``, output projection and blocks past the tap, where the
    tree has them (a tree converted from HF), are not carried: the LLaVA
    tap never reads them."""
    sd = _vision_tower(params["vision_tower"], "vision_tower", head=False)
    for name, lin in params["multi_modal_projector"].items():
        sd.update(_linear(lin, f"multi_modal_projector.{name}"))
    sd.update(llama_state_dict_from_jax_params(params["language_model"],
                                               "language_model."))
    return _tapped_blocks(sd, cfg)


def llama_state_dict_from_jax_params(params: Mapping[str, Any],
                                     prefix: str = ""
                                     ) -> Dict[str, torch.Tensor]:
    """flax params of ``clip_embeds_tpu.models.llama.LlamaForCausalLM``
    (numpy arrays) -> the port's ``models/llama.py`` state dict under
    ``prefix``: Dense kernels transposed to ``[out, in]`` weights,
    ``layers_{i}`` as ``layers.{i}``, the embedding table as
    ``embed_tokens.weight``, and each QuantDense as QuantLinear buffers
    (see :func:`llava_state_dict_from_jax_params`)."""
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
            key = name.replace("layers_", "layers.")
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            elif name == "kernel":
                sd[prefix + "weight"] = _t(np.asarray(value).T)
            elif name == "embedding":
                sd[prefix + "weight"] = _t(value)
            else:  # RMSNorm weight, bias
                sd[prefix + key] = _t(value)

    walk(params, prefix)
    return sd


def jax_params_from_llava(model: torch.nn.Module) -> Dict[str, Any]:
    """The port's :class:`Llava` -> flax ``Llava`` params (nested dicts of
    numpy arrays: float32, int8 ``kernel_q`` for a quantised trunk, with
    ``act_scale`` where a layer is static), the layout of a score
    bundle's ``params.npz``. The vision tower has no ``ln_post`` and no
    output projection, as a flax ``Llava.init`` makes none."""
    from ..models.layers import LayerNorm, MultiHeadAttention
    from ..models.llama import RMSNorm
    from ..models.quant import QuantLinear

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.numpy() if t.dtype == torch.int8
                else t.float().numpy())

    tree: Dict[str, Any] = {}

    def put(path: str, leaf: Dict[str, np.ndarray]) -> None:
        node = tree
        for part in path.split(".")[:-1]:
            node = node.setdefault(part, {})
        node.setdefault(path.split(".")[-1], {}).update(
            {k: np.ascontiguousarray(v) for k, v in leaf.items()})

    def flax_path(name: str) -> str:
        parts = name.split(".")
        out = []
        for part in parts:
            if part.isdigit():
                out[-1] = f"{out[-1]}_{part}"
            else:
                out.append(part)
        return ".".join(out)

    for name, m in model.named_modules():
        path = flax_path(name)
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
        elif isinstance(m, RMSNorm):
            put(path, {"weight": arr(m.weight)})
        elif isinstance(m, LayerNorm):
            put(path, {"scale": arr(m.weight), "bias": arr(m.bias)})
        elif isinstance(m, MultiHeadAttention) and not hasattr(m, "in_proj"):
            put(path + ".in_proj", {"kernel": arr(m.in_proj_weight).T,
                                    "bias": arr(m.in_proj_bias)})
    v = model.vision_tower
    conv = arr(v.conv1.weight)  # [W, 3, p, p]
    width, cin, p, _ = conv.shape
    tree["vision_tower"].update({
        "patch_embed": {"kernel": np.ascontiguousarray(
            conv.transpose(2, 3, 1, 0).reshape(p * p * cin, width))},
        "class_embedding": arr(v.class_embedding),
        "positional_embedding": arr(v.positional_embedding),
    })
    return tree
