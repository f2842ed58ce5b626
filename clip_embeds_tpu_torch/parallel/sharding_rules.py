"""Parameter sharding over a (data, model) mesh (counterpart of
``clip_embeds_tpu/parallel/sharding_rules.py``).

* FSDP (``--fsdp``): :func:`fsdp_param_specs` is JAX's rule leaf by leaf
  (a leaf under ``min_size`` elements is replicated, any other is sharded
  on its largest dimension that the world size divides, ties to the first
  in flax's layout); :func:`fsdp_shard_params` applies it with FSDP2
  ``fully_shard``, a unit a residual block and one for the rest, each large
  leaf placed on its dimension by a ``shard_placement_fn``. FSDP2 cannot
  leave one leaf of a unit whole, so the small leaves stay out of it
  (``ignored_params``): each rank keeps them whole, as JAX's replicated
  leaves, and their gradients are averaged by
  :func:`allreduce_grads`.
* Megatron tensor parallelism: :func:`clip_param_specs` is JAX's name
  rule (column-parallel up-projections, row-parallel down-projections);
  :func:`shard_params` applies it through
  ``torch.distributed.tensor.parallel`` over the mesh's model dimension.
  JAX's ``_fits`` carries over, at head granularity: eager torch runs each
  rank's heads on its own, so an attention whose heads (or GQA key/value
  heads) do not divide the axis stays whole, and an up/down pair that does
  not divide stays whole together. The attentions with a packed ``in_proj``
  (CLIP's) or a per-head relative bias (T5's) stay whole; their MLPs are
  sharded. ``lm_head`` is column-parallel with its logits gathered.
* ZeRO-1: :func:`zero1_opt_state_sharding` is
  ``ZeroRedundancyOptimizer`` over AdamW with the CLIP weight-decay split.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import MultiHeadAttention
from ..models.vit import VisionTransformer
from .mesh import DATA_AXIS, MODEL_AXIS

# JAX's name lists (flax paths), in the port's module names
_COLUMN_PARALLEL = (
    "attn.in_proj", "mlp.c_fc",
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "mlp.gate_proj", "mlp.up_proj", "lm_head",
    "self_attn.q", "self_attn.k", "self_attn.v",
    "cross_attn.q", "cross_attn.k", "cross_attn.v",
    "ff.wi_0", "ff.wi_1", "ff.wi",
)
_COLUMN_PARALLEL_BIAS = (
    "attn.in_proj", "mlp.c_fc",
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
)
_ROW_PARALLEL = (
    "attn.out_proj", "mlp.c_proj", "self_attn.o_proj", "mlp.down_proj",
    "self_attn.o", "cross_attn.o", "ff.wo",
)


def _module_and_leaf(name: str) -> Tuple[str, str]:
    """('attn.in_proj', 'weight') for the packed attention's
    'attn.in_proj_weight' as for 'attn.in_proj.weight'."""
    mod, _, leaf = name.rpartition(".")
    for packed in ("in_proj_weight", "in_proj_bias"):
        if leaf == packed:
            return f"{mod}.in_proj" if mod else "in_proj", leaf[8:]
    return mod, leaf


def _ends(module: str, names: Sequence[str]) -> bool:
    return any(module == n or module.endswith("." + n) for n in names)


def clip_param_specs(model: nn.Module) -> Dict[str, Tuple]:
    """Parameter name -> JAX's Megatron spec in the port's layout: one
    entry a dim, ``'model'`` where the dim is sharded over the model axis
    (a column-parallel weight [out, in] is ``('model', None)``, a
    row-parallel one ``(None, 'model')``); ``()`` replicated."""
    specs = {}
    for name, _ in model.named_parameters():
        mod, leaf = _module_and_leaf(name)
        if leaf == "weight" and _ends(mod, _COLUMN_PARALLEL):
            spec = (MODEL_AXIS, None)
        elif leaf == "bias" and _ends(mod, _COLUMN_PARALLEL_BIAS):
            spec = (MODEL_AXIS,)
        elif leaf == "weight" and _ends(mod, _ROW_PARALLEL):
            spec = (None, MODEL_AXIS)
        elif leaf == "weight" and _ends(mod, ("token_embedding",)):
            spec = (None, None)
        else:
            spec = ()
        specs[name] = spec
    return specs


def _divides(n: int, m: int) -> bool:
    return n % m == 0 and n >= m


def _tp_plan(model: nn.Module, m: int) -> Dict[str, object]:
    """Module name -> its ParallelStyle: :func:`clip_param_specs`' column-
    and row-parallel linears, planned by unit (the linears of one module)
    where the whole unit fits the axis: an MLP whose hidden width divides,
    an attention whose heads and key/value heads divide and whose forward
    takes its share of them (the Llama family's). ``lm_head`` gathers its
    logits."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (
        ColwiseParallel, RowwiseParallel)

    specs = clip_param_specs(model)
    plan = {}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        unit = {k: specs.get(f"{prefix}{k}.weight") for k, c in
                mod.named_children() if isinstance(c, nn.Linear)}
        cols = [k for k, v in unit.items() if v == (MODEL_AXIS, None)]
        rows = [k for k, v in unit.items() if v == (None, MODEL_AXIS)]
        if not (cols and rows):
            continue
        kids = dict(mod.named_children())
        cfg = getattr(mod, "cfg", None)
        attention = hasattr(cfg, "kv_heads") and rows == ["o_proj"]
        if any(k in ("o", "o_proj", "out_proj") for k in rows) and not (
                attention and _divides(cfg.num_heads, m)
                and _divides(cfg.kv_heads, m)):
            continue
        if all(_divides(kids[k].in_features, m) for k in rows):
            plan.update({prefix + k: ColwiseParallel() for k in cols})
            plan.update({prefix + k: RowwiseParallel() for k in rows})
    for name, mod in model.named_modules():
        if name.endswith("lm_head") and isinstance(mod, nn.Linear) \
                and _divides(mod.out_features, m):
            plan[name] = ColwiseParallel(output_layouts=Replicate())
    return plan


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Tensor-parallel ``model`` in place over ``mesh``'s model dimension
    (:func:`clip_param_specs`' rule, fitted as the module docstring says);
    the other leaves stay whole on every rank. Returns ``model``."""
    from torch.distributed.tensor.parallel import parallelize_module

    tp = mesh[MODEL_AXIS] if mesh.mesh_dim_names else mesh
    plan = _tp_plan(model, tp.size())
    if plan:
        parallelize_module(model, tp, plan)
    return model


def _flax_dims(module: nn.Module, leaf: str, p: torch.Tensor, world: int,
               patchify: bool) -> List[Tuple[int, Optional[int]]]:
    """(size, the port's dim) of each dim of a parameter's flax leaf, in
    flax's order: a linear kernel is [in, out] there, a conv kernel [kh,
    kw, in, out], and the ViT's patchify kernel [p * p * C, W], whose
    flattened (kh, kw, c) dim splits as the port's kh dim where the ranks
    divide p (else the port cannot hold that split: None)."""
    if patchify:
        w, c, kh, kw = p.shape
        return [(kh * kw * c, 2 if _divides(kh, world) else None), (w, 0)]
    if leaf in ("weight", "in_proj_weight") and p.ndim == 2 and isinstance(
            module, (nn.Linear, MultiHeadAttention)):
        order = (1, 0)
    elif leaf == "weight" and p.ndim == 4 and isinstance(module, nn.Conv2d):
        order = (2, 3, 1, 0)
    else:
        order = tuple(range(p.ndim))
    return [(p.shape[d], d) for d in order]


def fsdp_param_specs(model: nn.Module, world: int,
                     min_size: int = 2 ** 14) -> Dict[str, Optional[int]]:
    """Parameter name -> the port's dim that FSDP shards over ``world``
    ranks, or None (whole): JAX's ``fsdp_param_specs`` on the same leaf.
    (One difference: a patchify kernel whose flattened dim JAX splits
    where the ranks do not divide the patch size stays whole.)"""
    patchify = {id(m.conv1.weight) for m in model.modules()
                if isinstance(m, VisionTransformer)}
    specs = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            spec = None
            if p.ndim and p.numel() >= min_size:
                dims = _flax_dims(module, leaf, p, world,
                                  id(p) in patchify)
                # the largest dim the ranks divide, ties to flax's first
                for size, d in sorted(dims, key=lambda sd: sd[0],
                                      reverse=True):
                    if _divides(size, world):
                        spec = d
                        break
            specs[name] = spec
    return specs


def _blocks(model: nn.Module) -> List[nn.Module]:
    """The residual blocks: the children of every ModuleList that hold
    parameters, innermost first."""
    out = []
    for mod in model.modules():
        if isinstance(mod, nn.ModuleList):
            out += [c for c in mod if any(True for _ in c.parameters())]
    return out[::-1]


def fsdp_shard_params(model: nn.Module, mesh,
                      min_size: int = 2 ** 14) -> List[nn.Parameter]:
    """FSDP2 over ``mesh``'s data dimension, in place: each residual
    block a unit, then the model; the large leaves sharded on
    :func:`fsdp_param_specs`' dims. The forward methods ``encode_image``
    and ``encode_text`` gather their parameters as ``forward`` does.
    Returns the leaves left whole, whose gradients the caller averages
    (:func:`allreduce_grads`)."""
    from torch.distributed.fsdp import fully_shard, \
        register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    dp = mesh[DATA_AXIS] if mesh.ndim > 1 else mesh
    specs = fsdp_param_specs(model, dp.size(), min_size)
    params = dict(model.named_parameters())
    dims = {id(params[n]): d for n, d in specs.items() if d is not None}
    whole = [params[n] for n, d in specs.items() if d is None]
    kw = dict(mesh=dp, ignored_params=set(whole),
              shard_placement_fn=lambda p: Shard(dims[id(p)]))
    for block in _blocks(model):
        fully_shard(block, **kw)
    fully_shard(model, **kw)
    for method in ("encode_image", "encode_text"):
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    return whole


def distribute(model: nn.Module, mesh, fsdp: bool = False,
               min_size: int = 2 ** 14,
               find_unused_parameters: bool = False):
    """(forward, grad_sync) of ``model`` trained data-parallel over
    ``mesh``'s data dimension, every rank starting from rank 0's weights:
    with ``fsdp`` the model itself, sharded in place by
    :func:`fsdp_shard_params`, and the averaging of its whole leaves'
    gradients; else a ``DistributedDataParallel`` wrapper (whose own
    averaging covers every gradient) and None. Build the optimizer after
    this call: FSDP replaces the parameters."""
    from torch.nn.parallel import DistributedDataParallel

    from .mesh import data_group

    broadcast_params(model)
    group = data_group()
    if fsdp:
        whole = fsdp_shard_params(model, mesh, min_size)
        return model, lambda: allreduce_grads(whole, group)
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        process_group=group,
        find_unused_parameters=find_unused_parameters), None


def broadcast_params(model: nn.Module, src: int = 0) -> None:
    """Every rank takes rank ``src``'s parameters and buffers (before
    FSDP or DDP wraps the model)."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src)


def allreduce_grads(params: Sequence[torch.Tensor], group=None) -> None:
    """Average the gradients of ``params`` over ``group``'s ranks, in
    place (a parameter without a gradient on every rank is skipped)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    world = dist.get_world_size(group)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def zero1_opt_state_sharding(model: nn.Module, lr: float = 5e-6,
                             beta1: float = 0.9, beta2: float = 0.98,
                             eps: float = 1e-6, weight_decay: float = 0.2,
                             group=None):
    """AdamW over ``model``'s trainable parameters with the CLIP decay
    split (``train/optim.py adamw``) whose moments are sharded over the
    ranks of ``group`` (ZeRO-1: ``ZeroRedundancyOptimizer``); the
    parameters stay whole."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from ..train.optim import decay_groups

    return ZeroRedundancyOptimizer(
        decay_groups(model, weight_decay), optimizer_class=torch.optim.AdamW,
        process_group=group, lr=lr, betas=(beta1, beta2), eps=eps)
