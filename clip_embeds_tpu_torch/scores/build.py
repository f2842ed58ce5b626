"""Live Score models from score bundles (a copy of the LLaVA and GPT-4V
parts of ``clip_embeds_tpu/scores/build.py``).

A score bundle is a directory

    <bundle>/config.json   {"family": ..., "conversation": ...,
                            "model": {<family config dataclass as dict>}}
    <bundle>/params.npz    the flax parameter tree, flattened ("a/b/kernel")
    <bundle>/tokenizer/    optional HF tokenizer dir (loaded offline)

in the JAX package's layout, so a bundle written by either package loads in
the other. ``build_score_model`` (the backend of
``registry.get_score_model``) restores the config, carries the parameters
into the port's model (``core/convert.py llava_state_dict_from_jax_params``)
on ``device`` (default the card; without one it raises), and wires the
scorer:

    LLaVA family (llava-v1.5-*, sharegpt4v-*, llava-phi-3, llava-llama-3,
                  llava-v1.6-13b)   -> scores.score.VQAScore
    gpt-4*                         -> GPT4VScorer (needs ``complete``)

``quant=True`` serves the LLaVA trunk in W8A8 (dynamic QuantLinear, the
int8 codes and scales quantised from the bundle's fp32 weights in any
serving dtype, as ``quantize_llava_trunk`` does). ``scan=`` is accepted and does nothing: the scanned
trunk is an XLA compile-time device. The other families raise, naming
their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.llama import LlamaConfig
from ..models.llava import LlavaConfig

_NOT_PORTED = "is not ported yet: ROADMAP.md queue 1 item 13"


# -- config (de)serialization -------------------------------------------------


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _resolve_dataclass(tp):
    """Unwrap Optional[...] and return tp if it is a dataclass, else None."""
    if dataclasses.is_dataclass(tp):
        return tp
    if typing.get_origin(tp) is typing.Union:
        for arg in typing.get_args(tp):
            if dataclasses.is_dataclass(arg):
                return arg
    return None


def config_from_dict(cls, d: Dict[str, Any]):
    """Rebuild a (possibly nested) frozen config dataclass from plain JSON."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _resolve_dataclass(hints.get(f.name))
        if sub is not None and isinstance(v, dict):
            v = config_from_dict(sub, v)
        elif isinstance(v, list):
            v = tuple(
                tuple(e) if isinstance(e, list) else e for e in v
            )
        kwargs[f.name] = v
    return cls(**kwargs)


# -- bundle io ----------------------------------------------------------------


def save_score_bundle(
    path: str,
    family: str,
    model_cfg,
    params: Dict[str, Any],
    conversation: Optional[str] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a score bundle directory (config.json + params.npz); ``params``
    is a flax-layout tree of numpy arrays (``core/convert.py
    jax_params_from_llava`` gives it for the port's LLaVA)."""
    from ..core.factory import flatten_params

    os.makedirs(path, exist_ok=True)
    meta: Dict[str, Any] = {"family": family,
                            "model": config_to_dict(model_cfg)}
    if conversation is not None:
        meta["conversation"] = conversation
    if extra:
        meta.update(extra)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, indent=1)
    np.savez(os.path.join(path, "params.npz"), **flatten_params(params))


def load_score_bundle(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta dict, params tree) from a bundle dir, or params-only from .npz."""
    from ..core.factory import unflatten_params

    if os.path.isdir(path):
        with open(os.path.join(path, "config.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "params.npz")) as data:
            flat = {k: data[k] for k in data.files}
        return meta, unflatten_params(flat)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {}, unflatten_params({k: data[k] for k in data.files})
    raise ValueError(f"not a score bundle: {path!r}")


def _bundle_hf_tokenizer(path: str, subdir: str = "tokenizer"):
    """The bundle's HF tokenizer, if it has a ``tokenizer/`` directory;
    ``transformers`` is imported only then (and must be installed)."""
    tok_dir = os.path.join(path, subdir) if os.path.isdir(path) else None
    if tok_dir and os.path.isdir(tok_dir):
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(tok_dir)
    return None


# -- per-name default configs -------------------------------------------------


def llama_13b_config() -> LlamaConfig:
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_layers=40, num_heads=40)


def llama3_8b_config() -> LlamaConfig:
    """Meta-Llama-3-8B-Instruct shape (llava-llama-3 backbone)."""
    return LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0,
    )


def phi3_mini_config() -> LlamaConfig:
    """microsoft/Phi-3-mini (the llava-phi-3 text trunk) shape (a copy of
    ``clip_embeds_tpu/models/phi3.py phi3_mini_config``)."""
    return LlamaConfig(
        vocab_size=32064,
        hidden_size=3072,
        intermediate_size=8192,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        max_position_embeddings=4096,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
    )


def _llava_cfg(name: str) -> LlavaConfig:
    # llava-v1.6-13b scores with image_aspect_ratio='pad' in the reference:
    # one square 336px image through the plain splice path, the LLaVA-1.5
    # backbone with the vicuna-13b trunk
    if name in ("llava-v1.5-13b", "sharegpt4v-13b", "llava-v1.6-13b"):
        return LlavaConfig(llama=llama_13b_config())
    if name == "llava-phi-3":
        return LlavaConfig(llama=phi3_mini_config())
    if name == "llava-llama-3":
        return LlavaConfig(llama=llama3_8b_config())
    return LlavaConfig()  # 7B default (llava-v1.5-7b, sharegpt4v-7b)


def default_model_config(name: str):
    """Registered score-model name -> default (full-size) config dataclass
    (the LLaVA family; the others raise, naming their ROADMAP.md item)."""
    from .registry import (
        BLIP2_ITC_MODELS,
        BLIP2_ITM_MODELS,
        CLIP_T5_MODELS,
        IMAGE_REWARD_MODELS,
        INSTRUCTBLIP_MODELS,
        LLAVA16_MODELS,
        LLAVA_LLAMA_MODELS,
        LLAVA_MODELS,
    )

    if name in LLAVA_MODELS + LLAVA_LLAMA_MODELS + LLAVA16_MODELS:
        return _llava_cfg(name)
    if name in (CLIP_T5_MODELS + INSTRUCTBLIP_MODELS + BLIP2_ITM_MODELS
                + BLIP2_ITC_MODELS + IMAGE_REWARD_MODELS):
        raise NotImplementedError(f"the {name!r} model {_NOT_PORTED}")
    raise KeyError(f"no default config for {name!r}")


VQA_CONVERSATIONS = {
    "llava-v1.5-13b": "chat", "llava-v1.5-7b": "chat",
    "sharegpt4v-7b": "chat", "sharegpt4v-13b": "chat",
    "llava-phi-3": "phi3_instruct", "llava-llama-3": "llama3",
    "llava-v1.6-13b": "chat",
    "clip-flant5-xxl": "t5_chat", "clip-flant5-xl": "t5_chat",
    "clip-flant5-xxl-no-system": "t5_chat_no_system",
    "clip-flant5-xxl-no-system-no-user": "t5_chat_no_system_no_user",
}


# -- live construction --------------------------------------------------------


def build_score_model(
    name: str,
    checkpoint: str,
    dtype: Optional[torch.dtype] = None,
    tokenize: Optional[Callable] = None,
    complete: Optional[Callable] = None,
    device: str = "cuda",
    **kw,
):
    """Build a live Score for a registered VQA name from a bundle.

    ``tokenize`` overrides the bundle's own ``tokenizer/`` dir; one of the
    two must exist. ``dtype`` defaults to bf16 on the card and fp32 on the
    CPU."""
    from .registry import (
        BLIP2_ITC_MODELS,
        BLIP2_ITM_MODELS,
        CLIP_T5_MODELS,
        GPT4V_MODELS,
        IMAGE_REWARD_MODELS,
        INSTRUCTBLIP_MODELS,
        LLAVA16_MODELS,
        LLAVA_LLAMA_MODELS,
        LLAVA_MODELS,
    )

    if name in GPT4V_MODELS:
        from .score import Score
        from .vqa_score import GPT4VScorer

        if complete is None:
            raise NotImplementedError(
                "GPT-4V scoring needs the API transport passed in: "
                "complete=lambda question, image: [(token, logprob), ...] "
                "(see vqa_score.GPT4VScorer)"
            )
        return Score(GPT4VScorer(complete, **kw).forward)

    if name in (CLIP_T5_MODELS + INSTRUCTBLIP_MODELS + BLIP2_ITM_MODELS
                + BLIP2_ITC_MODELS + IMAGE_REWARD_MODELS):
        raise NotImplementedError(f"scoring with {name!r} {_NOT_PORTED}")
    if name not in LLAVA_MODELS + LLAVA_LLAMA_MODELS + LLAVA16_MODELS:
        raise KeyError(f"unknown score model {name!r}")

    from ..core.convert import llava_state_dict_from_jax_params
    from ..models.llava import Llava
    from ..models.quant import llava_trunk_pairs, quantize_linears
    from .score import VQAScore

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device is available; pass "
                           "device='cpu' to score on the CPU")
    dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                      else torch.float32)
    meta, params = load_score_bundle(checkpoint)
    conversation = meta.get("conversation") or VQA_CONVERSATIONS.get(name)
    cfg = (config_from_dict(LlavaConfig, meta["model"]) if "model" in meta
           else default_model_config(name))
    quant = kw.pop("quant", None)
    kw.pop("scan", None)  # an XLA compile-time layout; nothing to do here
    fp = llava_state_dict_from_jax_params(params, cfg)
    del params
    sd = {}
    if quant:
        # W8A8 trunk: int8 codes and fp32 scales quantised on the device
        # from the bundle's fp32 weights, one projection at a time, as the
        # JAX package quantises its fp32 params; the tower, projector,
        # embeddings, norms and lm_head stay floating point
        for key, path in llava_trunk_pairs(fp):
            sd.update(quantize_linears({key: fp.pop(key).to(device)},
                                       [(key, path)]))
    sd.update({k: (v.to(device, dtype) if v.is_floating_point()
                   else v.to(device)) for k, v in fp.items()})
    del fp
    with torch.device("meta"):
        model = Llava(cfg, quant_llm="dynamic" if quant else "")
    model.load_state_dict(sd, assign=True)
    del sd
    if tokenize is None:
        hf = _bundle_hf_tokenizer(checkpoint)
        if hf is None:
            raise ValueError(
                f"{name!r} needs a tokenizer: pass tokenize= or put an HF "
                f"tokenizer dir at <bundle>/tokenizer"
            )
        tokenize = lambda text: hf(text).input_ids  # noqa: E731
        kw.setdefault("bos_token_id", hf.bos_token_id)
        kw.setdefault("pad_token_id", hf.pad_token_id or 0)
    return VQAScore(model, tokenize,
                    conversation_style=conversation or "chat",
                    device=device, **kw)
