"""Phi-3 decoder, the VLM2Vec Phi-3-V text trunk (counterpart of
``clip_embeds_tpu/models/phi3.py``).

Phi-3 is the Llama trunk (``models/llama.py``) with packed projections:
``qkv_proj`` [q; k; v] and ``gate_up_proj`` [gate; up]. The converter
splits them into the Llama layout, so one model serves both families.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .llama import LlamaConfig, LlamaForCausalLM


def _np(t) -> np.ndarray:
    """A numpy array or a torch tensor -> fp32 numpy (the JAX package's
    ``core/torch_convert.py _np``)."""
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()


def phi3_mini_config() -> LlamaConfig:
    """microsoft/Phi-3-mini (the Phi-3.5-V text trunk) shape."""
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


def Phi3ForCausalLM(cfg: LlamaConfig, **kw) -> LlamaForCausalLM:
    """Phi-3 is architecturally Llama once projections are unpacked."""
    return LlamaForCausalLM(cfg, **kw)


def convert_phi3_state_dict(sd: Mapping[str, Any], cfg: LlamaConfig,
                            prefix: str = "") -> Dict[str, Any]:
    """HF ``Phi3ForCausalLM`` state dict -> the flax tree of the JAX
    ``LlamaForCausalLM`` (what the JAX converter returns; load it into the
    port with ``core/convert.py state_dict_from_flax``). ``qkv_proj``
    [q_dim + 2 kv_dim, hidden] and ``gate_up_proj`` [2 intermediate,
    hidden] are split into the separate projections."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.kv_heads * cfg.head_dim
    n = 0
    while f"model.layers.{n}.input_layernorm.weight" in sd:
        n += 1
    layers: Dict[str, Any] = {}
    for i in range(n):
        p = f"model.layers.{i}"
        qkv = _np(sd[f"{p}.self_attn.qkv_proj.weight"])
        qw, kw_, vw = (qkv[:q_dim], qkv[q_dim:q_dim + kv_dim],
                       qkv[q_dim + kv_dim:])
        gate_up = _np(sd[f"{p}.mlp.gate_up_proj.weight"])
        gw = gate_up[:cfg.intermediate_size]
        uw = gate_up[cfg.intermediate_size:]
        layers[f"layers_{i}"] = {
            "input_layernorm": {
                "weight": _np(sd[f"{p}.input_layernorm.weight"])},
            "post_attention_layernorm": {
                "weight": _np(sd[f"{p}.post_attention_layernorm.weight"])},
            "self_attn": {
                "q_proj": {"kernel": qw.T},
                "k_proj": {"kernel": kw_.T},
                "v_proj": {"kernel": vw.T},
                "o_proj": {"kernel": _np(
                    sd[f"{p}.self_attn.o_proj.weight"]).T},
            },
            "mlp": {
                "gate_proj": {"kernel": gw.T},
                "up_proj": {"kernel": uw.T},
                "down_proj": {"kernel": _np(
                    sd[f"{p}.mlp.down_proj.weight"]).T},
            },
        }
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": _np(sd["model.embed_tokens.weight"])},
        "model": dict(layers, norm={"weight": _np(sd["model.norm.weight"])}),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _np(sd["lm_head.weight"]).T}
    return params
