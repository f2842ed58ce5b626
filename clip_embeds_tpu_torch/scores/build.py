"""Live Score models from score bundles (counterpart of
``clip_embeds_tpu/scores/build.py``).

A score bundle is a directory

    <bundle>/config.json   {"family": ..., "conversation": ...,
                            "model": {<family config dataclass as dict>}}
    <bundle>/params.npz    the flax parameter tree, flattened ("a/b/kernel")
    <bundle>/tokenizer/    optional HF tokenizer dir (loaded offline)

in the JAX package's layout, so a bundle written by either package loads in
the other. ``build_score_model`` (the backend of
``registry.get_score_model``) restores the config, carries the parameters
into the port's model (``core/convert.py``) on ``device`` (default the
card; without one it raises), and wires the scorer:

    LLaVA family (llava-v1.5-*, sharegpt4v-*, llava-phi-3, llava-llama-3,
                  llava-v1.6-13b)   -> scores.score.VQAScore
    clip-flant5-*                  -> scores.score.T5VQAScore
    instructblip-flant5-*          -> scores.score.InstructBlipVQAScore
    blip2-itm*                     -> scores.score.ITMScore
    blip2-itc*                     -> the Q-Former ITC cosine score
    image-reward-v1                -> scores.score.ImageRewardScore
    gpt-4*                         -> GPT4VScorer (needs ``complete``)

``quant=True`` serves the LLaVA trunk, or the T5 trunk of CLIP-FlanT5 and
InstructBLIP, in W8A8 (dynamic QuantLinear): the int8 codes and scales
are quantised on the device from the bundle's fp32 weights one projection
at a time, in any serving dtype, as ``quantize_llava_trunk`` /
``quantize_clip_t5_trunk`` quantise fp32 params. ``scan=`` is accepted and
does nothing: the scanned trunk is an XLA compile-time device. The
tokenizers are passed in (``tokenize=``, and ``qformer_tokenize=`` for
InstructBLIP's BERT tokenizer) or read from the bundle's HF tokenizer
directories.
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
    jax_params_from_module`` gives it for the port's models)."""
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


def _flant5_cfg(size: str):
    from ..models.t5 import T5Config

    if size == "xxl":
        return T5Config(d_model=4096, d_ff=10240, num_layers=24,
                        num_heads=64)
    if size == "xl":
        return T5Config(d_model=2048, d_ff=5120, num_layers=24,
                        num_heads=32)
    raise KeyError(size)


def default_model_config(name: str):
    """Registered score-model name -> default (full-size) config
    dataclass."""
    from ..core.config import VisionConfig
    from ..models.blip import BlipConfig
    from ..models.blip2 import Blip2Config, QFormerConfig
    from ..models.clip_t5 import CLIPT5Config
    from ..models.instructblip import InstructBlipConfig
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
    if name in CLIP_T5_MODELS:
        size = "xl" if name == "clip-flant5-xl" else "xxl"
        return CLIPT5Config(t5=_flant5_cfg(size))
    if name in INSTRUCTBLIP_MODELS:
        return InstructBlipConfig(t5=_flant5_cfg(name.rsplit("-", 1)[-1]))
    if name in BLIP2_ITM_MODELS + BLIP2_ITC_MODELS:
        if name.endswith("-vitL"):
            return Blip2Config(
                vision=VisionConfig(image_size=224, patch_size=14,
                                    width=1024, layers=24, head_width=64),
                qformer=QFormerConfig(encoder_hidden_size=1024),
            )
        if name.endswith("-coco"):
            return Blip2Config(
                vision=VisionConfig(image_size=364, patch_size=14,
                                    width=1408, layers=39, head_width=88,
                                    mlp_ratio=6144 / 1408),
            )
        return Blip2Config()
    if name in IMAGE_REWARD_MODELS:
        return BlipConfig()
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


def llava_from_params(params: Dict[str, Any], cfg: LlavaConfig,
                      device, dtype: torch.dtype, quant: bool = False,
                      **llava_kw):
    """The port's Llava of config ``cfg`` from flax-layout ``params`` (a
    bundle's tree) on ``device`` in ``dtype``, frozen, in eval mode. With
    ``quant`` the Llama trunk is W8A8 (dynamic QuantLinear), its int8
    codes and fp32 scales quantised on the device from the fp32 weights,
    one projection at a time, as the JAX package quantises its fp32
    params; the tower, projector, embeddings, norms and lm_head stay
    floating point. ``llava_kw`` (``lora_rank``, ``lora_alpha``,
    ``remat``) go to the model."""
    from ..core.convert import vlm_state_dict_from_jax_params
    from ..models.llava import Llava
    from ..models.quant import llava_trunk_pairs

    fp = vlm_state_dict_from_jax_params(params, cfg)
    return _load_on(Llava, cfg, fp, device, dtype,
                    llava_trunk_pairs(fp) if quant else None,
                    quant_llm="dynamic" if quant else "", **llava_kw)


def _load_on(model_cls, cfg, sd: Dict[str, torch.Tensor], device,
             dtype: torch.dtype, quant_pairs=None, optional=(),
             **model_kw):
    """``model_cls(cfg, **model_kw)`` built on the meta device and loaded
    from the fp32 state dict ``sd`` onto ``device``: the ``quant_pairs``
    (fp weight key, QuantLinear path) quantised there one at a time, the
    rest cast to ``dtype``; frozen, in eval mode. Parameters under an
    ``optional`` prefix that ``sd`` lacks (a JAX init that never reached
    them) are zeros; any other missing key raises."""
    from ..models.quant import quantize_linears

    fp = dict(sd)
    out: Dict[str, torch.Tensor] = {}
    for key, path in quant_pairs or ():
        out.update(quantize_linears({key: fp.pop(key).to(device)},
                                    [(key, path)]))
    out.update({k: (v.to(device, dtype) if v.is_floating_point()
                    else v.to(device)) for k, v in fp.items()})
    del fp
    with torch.device("meta"):
        model = model_cls(cfg, **model_kw)
    for key, t in model.state_dict().items():
        if key not in out and key.startswith(tuple(optional)):
            out[key] = torch.zeros(t.shape, dtype=dtype, device=device)
    model.load_state_dict(out, assign=True)
    return model.requires_grad_(False).eval()


def t5_family_from_params(params: Dict[str, Any], cfg, device,
                          dtype: torch.dtype, quant: bool = False):
    """The port's CLIP-FlanT5 (a ``CLIPT5Config``) or InstructBLIP-FlanT5
    (an ``InstructBlipConfig``) from flax-layout ``params`` on ``device``
    in ``dtype``; with ``quant`` the T5 trunk is W8A8 (dynamic
    QuantLinear) quantised on the device from the fp32 weights."""
    from ..core.convert import (
        clip_t5_state_dict_from_jax_params,
        state_dict_from_flax,
    )
    from ..models.clip_t5 import CLIPT5, CLIPT5Config
    from ..models.instructblip import InstructBlipT5
    from ..models.quant import t5_trunk_pairs

    if isinstance(cfg, CLIPT5Config):
        cls, sd = CLIPT5, clip_t5_state_dict_from_jax_params(params, cfg)
    else:
        cls, sd = InstructBlipT5, state_dict_from_flax(params)
    return _load_on(cls, cfg, sd, device, dtype,
                    t5_trunk_pairs(sd) if quant else None,
                    quant_t5="dynamic" if quant else "")


def build_score_model(
    name: str,
    checkpoint: str,
    dtype: Optional[torch.dtype] = None,
    tokenize: Optional[Callable] = None,
    qformer_tokenize: Optional[Callable] = None,
    complete: Optional[Callable] = None,
    device: str = "cuda",
    **kw,
):
    """Build a live Score for a registered VQA / ITM / ITC name from a
    bundle.

    ``tokenize`` (and ``qformer_tokenize`` for InstructBLIP) override the
    bundle's own ``tokenizer/`` (``qformer_tokenizer/``) directory; one of
    the two must exist. ``dtype`` defaults to bf16 on the card and fp32 on
    the CPU."""
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

    llava = LLAVA_MODELS + LLAVA_LLAMA_MODELS + LLAVA16_MODELS
    blip2 = BLIP2_ITM_MODELS + BLIP2_ITC_MODELS
    if name not in (llava + CLIP_T5_MODELS + INSTRUCTBLIP_MODELS + blip2
                    + IMAGE_REWARD_MODELS):
        raise KeyError(f"unknown score model {name!r}")

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device is available; pass "
                           "device='cpu' to score on the CPU")
    dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                      else torch.float32)
    meta, params = load_score_bundle(checkpoint)
    conversation = meta.get("conversation") or VQA_CONVERSATIONS.get(name)
    default = default_model_config(name)
    cfg = (config_from_dict(type(default), meta["model"]) if "model" in meta
           else default)
    quant = bool(kw.pop("quant", None))
    kw.pop("scan", None)  # an XLA compile-time layout; nothing to do here

    def need_tokenize(fn, what="tokenize", subdir="tokenizer"):
        if fn is not None:
            return fn, None
        hf = _bundle_hf_tokenizer(checkpoint, subdir)
        if hf is None:
            raise ValueError(
                f"{name!r} needs a tokenizer: pass {what}= or put an HF "
                f"tokenizer dir at <bundle>/{subdir}")
        return (lambda text: hf(text).input_ids), hf

    if name in llava:
        from .score import VQAScore

        model = llava_from_params(params, cfg, device, dtype, quant=quant)
        del params
        tok, hf = need_tokenize(tokenize)
        if hf is not None:
            kw.setdefault("bos_token_id", hf.bos_token_id)
            kw.setdefault("pad_token_id", hf.pad_token_id or 0)
        return VQAScore(model, tok,
                        conversation_style=conversation or "chat",
                        device=device, **kw)

    if name in CLIP_T5_MODELS + INSTRUCTBLIP_MODELS:
        model = t5_family_from_params(params, cfg, device, dtype, quant)
        del params
        t5_tok, _ = need_tokenize(tokenize, "tokenize (T5)")
        if name in CLIP_T5_MODELS:
            from .score import T5VQAScore

            return T5VQAScore(model, t5_tok,
                              conversation_style=conversation or "t5_chat",
                              device=device, **kw)
        from .score import InstructBlipVQAScore

        q_tok, _ = need_tokenize(qformer_tokenize,
                                 "qformer_tokenize (BERT)",
                                 "qformer_tokenizer")
        return InstructBlipVQAScore(model, q_tok, t5_tok, device=device,
                                    **kw)

    from ..core.convert import state_dict_from_flax

    tok, _ = need_tokenize(tokenize)
    kw.setdefault("image_size", cfg.vision.image_size)
    if name in IMAGE_REWARD_MODELS:
        from ..models.blip import ImageReward
        from .score import ImageRewardScore

        model = _load_on(ImageReward, cfg, state_dict_from_flax(params),
                         device, dtype)
        return ImageRewardScore(model, tok, device=device, **kw)

    from ..models.blip2 import Blip2ITM

    # a JAX bundle initialised through one head may lack the other's, which
    # this name never reads; a missing head that it reads raises
    itm = name in BLIP2_ITM_MODELS
    model = _load_on(Blip2ITM, cfg, state_dict_from_flax(params), device,
                     dtype, optional=(("vision_projection.", "text_projection.")
                                      if itm else ("itm_head.",)))
    if itm:
        from .score import ITMScore

        return ITMScore(model, tok, device=device, **kw)
    return _blip2_itc_score(model, tok, device=device, **kw)


def _blip2_itc_score(model, tokenize, image_size: int = 224,
                     max_length: int = 35, batch_size: int = 8,
                     device="cuda"):
    """BLIP2-ITC cosine score: the max over the Q-Former's query
    embeddings of cosine(image query, text CLS), per pair."""
    from .score import Score
    from .vqa_score import PairBatches

    def fn(pixels, ids, mask):
        img, txt = model.itc_embeds(pixels, ids, mask)
        return torch.einsum("bqe,be->bq", img, txt).amax(dim=-1)

    return Score(PairBatches(model, fn, tokenize, image_size, max_length,
                             batch_size, device, "blip2-itc"))
