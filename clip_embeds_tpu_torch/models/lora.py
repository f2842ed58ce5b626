"""LoRA adapters over the port's LLaVA / Llama (counterpart of
``clip_embeds_tpu/models/lora.py``).

Reference usage (VLM2Vec/src/model.py:97-144): peft LoRA over the
q/k/v/o/gate/up/down projections, the vision tower excluded, adapters
merged into the base weights for eval (``merge_and_unload``).

An adapter tree keeps the JAX package's layout, so an adapter ``.npz``
saved by either package loads in the other: flat keys, the flax path of
each adapted Dense kernel (``language_model/model/layers_0/self_attn/
q_proj/kernel``, also over an int8 base), each holding ``{"a": [in, r],
"b": [r, out]}`` fp32. ``core/convert.py lora_targets_by_key`` maps the
keys to the port's layers.

Two ways to apply a tree, as in JAX:

* :func:`materialize` / :func:`merge_lora`: the base weights plus
  ``alpha / r * (a @ b)`` (r the adapter's own rank), a second set of the
  targeted weights; a train step runs the model on them through
  ``torch.func.functional_call`` (``train/vlm2vec.py``);
* :func:`attach_lora`: the unmaterialized side-path of a model built with
  ``lora_rank`` > 0 (``models/quant.py``), over an fp or int8 base, which
  is never rewritten; the collection of :func:`to_collection` plays JAX's
  ``lora`` variable collection.

Where JAX would apply a tree silently in a way that differs from the
other mode, :func:`attach_lora` raises instead: an adapter key that
matches no layer (JAX serves it as a zero delta), an adapter whose rank
is not the model's ``lora_rank`` (JAX scales it by the model's rank while
``materialize`` uses the adapter's), and adapters on a model built without
the side-path. Not ported: JAX's ``from_collection``, which nothing there
calls.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.convert import lora_targets_by_key

DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)

Lora = Dict[str, Dict[str, Any]]


def _is_target(key: str, targets: Sequence[str],
               exclude: Sequence[str]) -> bool:
    names = key.split("/")
    if any(e in names for e in exclude):
        return False
    return any(t in names for t in targets)


def _weight(m: nn.Module) -> torch.Tensor:
    """A linear layer's [out, in] weight: int8 codes for a QuantLinear."""
    return m.weight_q if hasattr(m, "weight_q") else m.weight


@torch.no_grad()
def init_lora(model: nn.Module, rank: int = 8,
              generator: Optional[torch.Generator] = None,
              targets: Sequence[str] = DEFAULT_TARGETS,
              exclude: Sequence[str] = ("vision_tower",)) -> Lora:
    """The adapter tree of ``model``'s targeted linear layers (fp or
    int8): for each, ``{"a": N(0, 1) / rank [in, r], "b": zeros [r,
    out]}`` (peft's init), fp32 on the layer's device, drawn in key order
    from ``generator`` (default: seed 0 on that device). The values differ
    from ``jax.random``'s; the layout and the law are JAX's."""
    lora: Lora = {}
    for key, m in sorted(lora_targets_by_key(model).items()):
        if not _is_target(key, targets, exclude):
            continue
        d_out, d_in = _weight(m).shape
        dev = _weight(m).device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn(d_in, rank, generator=generator,
                        device=generator.device, dtype=torch.float32)
        lora[key] = {"a": (a * (1.0 / rank)).to(dev),
                     "b": torch.zeros(rank, d_out, device=dev)}
    return lora


def lora_tensors(lora: Lora) -> Iterator[torch.Tensor]:
    """The adapter tensors of a canonical tree, in key order (a, then b)."""
    for key in sorted(lora):
        yield lora[key]["a"]
        yield lora[key]["b"]


def to_collection(lora: Lora) -> Dict[str, Any]:
    """Flat canonical tree -> the nested collection the side-path reads
    (JAX's flax ``lora`` collection): the trailing '/kernel' stripped so
    each {'a', 'b'} pair sits at its layer's scope. The tensors are kept
    (numpy arrays become tensors), so gradients reach them."""
    lora = normalize_lora(lora)
    out: Dict[str, Any] = {}
    for key, ab in lora.items():
        parts = key.split("/")
        if parts[-1] in ("kernel", "kernel_q"):
            parts = parts[:-1]
        node = out
        for p in parts:
            node = node.setdefault(p, {})
        node["a"], node["b"] = _as_tensor(ab["a"]), _as_tensor(ab["b"])
    return out


def normalize_lora(lora: Dict[str, Any]) -> Lora:
    """Canonicalise an adapter tree to the flat layout of
    :func:`init_lora`, ``{"path/to/kernel": {"a": [in, r], "b": [r,
    out]}}``, from any of: that layout; the npz-flat one of the trainers
    (``.../kernel/a`` -> array); a fully nested tree."""
    if not lora:
        return {}
    if all(isinstance(v, dict) and set(v) >= {"a", "b"}
           and not isinstance(v["a"], dict) for v in lora.values()):
        return lora

    def flatten(node, prefix, out):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                flatten(v, key, out)
            else:
                out[key] = v

    flat: Dict[str, Any] = {}
    flatten(lora, "", flat)
    grouped: Dict[str, Dict[str, Any]] = {}
    for key, arr in flat.items():
        kernel_path, leaf = key.rsplit("/", 1)
        if leaf not in ("a", "b"):
            raise ValueError(
                f"LoRA adapter key {key!r} does not end in /a or /b — "
                "not a LoRA tree saved by init_lora/train_vlm2vec")
        grouped.setdefault(kernel_path, {})[leaf] = arr
    for kernel_path, ab in grouped.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(
                f"LoRA adapter for {kernel_path!r} is missing "
                f"{sorted({'a', 'b'} - set(ab))}")
    return grouped


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is (gradients reach it), an array as fp32."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x, np.float32))


def materialize(model: nn.Module, lora: Dict[str, Any], alpha: float = 16.0,
                rank: Optional[int] = None, train: bool = True
                ) -> Dict[str, torch.Tensor]:
    """``model``'s state (parameter and buffer name -> tensor) with each
    adapted weight replaced by ``W + alpha / rank * (a @ b)^T``, summed in
    fp32 and cast to W's dtype (JAX adds the delta to its fp32 kernel;
    Dense casts it to the compute dtype). ``rank`` defaults to the
    adapter's own. With ``train`` the base enters detached (JAX's
    ``stop_gradient``): only the adapters get gradients.

    Every adapter key must match a floating-point linear layer: a zero
    delta merged silently is an error, as in JAX, and so is an int8
    layer, whose weight cannot absorb a delta (use :func:`attach_lora`)."""
    lora = normalize_lora(lora)
    if rank is None and lora:
        rank = next(iter(lora.values()))["a"].shape[-1]
    scale = alpha / (rank or 1)
    out = dict(model.state_dict(keep_vars=not train))
    by_key = lora_targets_by_key(model)
    names = {m: n for n, m in model.named_modules()}
    unmatched = []
    for key, ab in lora.items():
        m = by_key.get(key)
        if m is None or not isinstance(m, nn.Linear):
            unmatched.append(key)
            continue
        name = names[m] + ".weight"
        w = out[name]
        a, b = (_as_tensor(ab[n]).to(w.device) for n in "ab")
        out[name] = (w.float() + scale * (a @ b).t()).to(w.dtype)
    if unmatched:
        raise ValueError(
            f"{len(unmatched)}/{len(lora)} LoRA adapter keys matched no "
            f"param path (would merge zero deltas); first few: "
            f"{sorted(unmatched)[:3]}. For a quantized (kernel_q) base, "
            "adapters cannot be materialized — use the unmaterialized "
            "path: a model built with lora_rank=r and attach_lora.")
    return out


@torch.no_grad()
def merge_lora(model: nn.Module, lora: Dict[str, Any],
               alpha: float = 16.0) -> nn.Module:
    """A new model of ``model``'s class and config with the adapters folded
    into its weights (peft ``merge_and_unload``), frozen, in eval mode;
    the weights no adapter touches are shared with ``model``, not
    copied."""
    sd = materialize(model, lora, alpha, train=True)
    with torch.device("meta"):
        merged = type(model)(model.cfg)
    merged.load_state_dict(sd, assign=True)
    return merged.requires_grad_(False).eval()


def detach_lora(model: nn.Module) -> nn.Module:
    """Remove every attached adapter (the layers add nothing again)."""
    for m in lora_targets_by_key(model).values():
        if hasattr(m, "lora_rank"):
            m.lora = None
    return model


def attach_lora(model: nn.Module, lora: Dict[str, Any]) -> nn.Module:
    """Serve ``lora`` (any layout :func:`normalize_lora` takes) through the
    side-path of ``model``'s layers, in place: each adapted layer adds
    ``lora_alpha / lora_rank * (x @ a) @ b`` (the model's rank and alpha,
    as in JAX); the others add nothing. Earlier adapters are removed.
    Raises where JAX would serve the tree silently otherwise: a key that
    matches no layer, a layer without the side-path (``lora_rank`` 0), an
    adapter of another rank."""
    detach_lora(model)
    by_key = lora_targets_by_key(model)
    unmatched, pairs = [], []

    def walk(node, path):
        if set(node) == {"a", "b"} and not isinstance(node["a"], dict):
            pairs.append((path, node))
            return
        for k, v in node.items():
            walk(v, f"{path}/{k}" if path else k)

    walk(to_collection(lora), "")
    for path, ab in pairs:
        m = by_key.get(path + "/kernel")
        if m is None:
            unmatched.append(path + "/kernel")
            continue
        if getattr(m, "lora_rank", 0) <= 0:
            raise ValueError(
                f"unmaterialized adapters need a model built with "
                f"lora_rank > 0; {path} has none")
        a, b = ab["a"], ab["b"]
        if a.shape[-1] != m.lora_rank or b.shape[0] != m.lora_rank:
            raise ValueError(
                f"adapter {path} has rank {a.shape[-1]}, the model's "
                f"lora_rank is {m.lora_rank}: JAX would scale it by "
                f"alpha / {m.lora_rank}, materialize by alpha / "
                f"{a.shape[-1]}")
        dev = _weight(m).device
        m.lora = (a.to(dev), b.to(dev))
    if unmatched:
        detach_lora(model)
        raise ValueError(
            f"{len(unmatched)}/{len(pairs)} LoRA adapter keys match no "
            f"layer (JAX would serve them as zero deltas); first few: "
            f"{sorted(unmatched)[:3]}")
    return model
