"""Process groups, the device mesh and the batch split (counterpart of
``clip_embeds_tpu/parallel/mesh.py``).

The JAX package replaced open_clip's torch DDP bootstrap
(``open_clip_train/distributed.py:93-195``) with one ``jax.sharding.Mesh``;
the port goes back to torch's own idiom: one process a card, started by
``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``), NCCL between
cards and gloo where the caller asked for the CPU. :func:`create_mesh`
lays the ranks out as JAX's (data, model) mesh, a
``torch.distributed.device_mesh.DeviceMesh``.

Each rank holds a contiguous slice of every global batch
(:func:`shard_batch`), so concatenating the slices in rank order gives
JAX's global batch back. The global-batch losses gather the features with
gradient (:func:`gather_rows`: open_clip's ``gather_with_grad=True``,
``local_loss=False``, which JAX's pjit computes by construction) and every
rank computes the whole loss. The autograd convention is DDP's: each rank
back-propagates its own loss, the gradients of the parameters are averaged
over the ranks, so the gather's backward sums the ranks' gradients of each
slice; the whole is the gradient of the global-batch loss.

JAX's ``constrain`` has no counterpart: eager torch activations carry no
layout hint for a partitioner to read.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the group the losses gather over (the mesh's data dimension), and the
# directory of a one-rank group's file store
_data_group = None
_store_dir: Optional[str] = None


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def data_group():
    """The process group of the mesh's data dimension (the whole world
    before :func:`create_mesh`), or None without a group."""
    if not distributed():
        return None
    return _data_group if _data_group is not None else dist.group.WORLD


def data_world() -> int:
    """Ranks holding slices of one global batch (1 without a group)."""
    group = data_group()
    return 1 if group is None else dist.get_world_size(group)


def data_rank() -> int:
    group = data_group()
    return 0 if group is None else dist.get_rank(group)


def init_distributed(device="cuda") -> torch.device:
    """Open the default process group, if none is open, and return this
    rank's device: ``cuda:LOCAL_RANK`` with NCCL on the card, the CPU with
    gloo only where ``device`` asks for it. Under ``torchrun`` (its
    ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment) the ranks meet
    there; without it the group has one rank and meets in a ``file://``
    store in a temporary directory: no network and no port."""
    global _store_dir
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {device}: no CUDA device is "
                             "available; pass --device cpu to run on the "
                             "CPU")
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if distributed():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return device
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != 1:
        raise SystemExit(f"WORLD_SIZE={world} without MASTER_ADDR: start "
                         "the ranks with torchrun")
    _store_dir = tempfile.mkdtemp(prefix="cet_dist_")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(_store_dir, 'store')}",
        rank=0, world_size=1)
    return device


def close_distributed() -> None:
    """Destroy the default process group and forget the mesh's groups."""
    global _data_group, _store_dir
    if distributed():
        dist.destroy_process_group()
    _data_group = None
    if _store_dir is not None:
        shutil.rmtree(_store_dir, ignore_errors=True)
        _store_dir = None


def create_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A (data, model) ``DeviceMesh`` over the group's ranks, rank-major as
    JAX's ``create_mesh`` lays out its devices; the losses gather over its
    data dimension from here on."""
    from torch.distributed.device_mesh import init_device_mesh

    global _data_group
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"{n_data}x{n_model} mesh does not tile {world} "
                         "ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    _data_group = mesh.get_group(DATA_AXIS)
    return mesh


def batch_spec() -> Shard:
    """The leading (batch) dim sharded, JAX's ``P('data')``."""
    return Shard(0)


def replicated_spec() -> Replicate:
    return Replicate()


def batch_sharding(mesh) -> Tuple:
    """The placements of a batch on ``mesh``: sharded over the data
    dimension, replicated over the others."""
    return tuple(batch_spec() if name == DATA_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_sharding(mesh) -> Tuple:
    return (replicated_spec(),) * mesh.ndim


def shard_batch(batch: Dict[str, np.ndarray], rank: int, world: int
                ) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s contiguous slice of every global array of
    ``batch``; exits naming ``--batch-size`` where a leading dim does not
    divide by ``world``."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise SystemExit(f"--batch-size: the global batch's {k!r} has "
                             f"{n} rows, which {world} ranks cannot split "
                             "evenly")
        step = n // world
        out[k] = v[rank * step:(rank + 1) * step]
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward sums the ranks' gradients and
    keeps this rank's rows (a reduce-scatter, by all-reduce and slice so
    that gloo and NCCL take the same path)."""

    @staticmethod
    def forward(ctx, x, group):
        world = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), \
            x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``x``'s rows from every rank of the data group, in rank order
    (this rank's ``x`` itself without a group)."""
    group = data_group()
    if group is None:
        return x
    return _GatherRows.apply(x, group)


class _RingShift(torch.autograd.Function):
    """Send ``x`` to the next rank and receive the previous rank's; the
    backward sends the gradient the other way (open_clip
    ``loss.py:280-374``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -1), None


def _exchange(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    peer = lambda r: dist.get_global_rank(group, r % world)  # noqa: E731
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer(rank + shift), group),
        dist.P2POp(dist.irecv, out, peer(rank - shift), group)])
    for req in reqs:
        req.wait()
    return out


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    """The previous rank's ``x`` (ring order over the data group)."""
    return _RingShift.apply(x, data_group())


def ranks_mean(loss: torch.Tensor) -> torch.Tensor:
    """``loss`` with its value replaced by its mean over the data group
    and its gradient kept: the loss every rank reports, while each rank's
    backward stays its own."""
    group = data_group()
    if group is None:
        return loss
    mean = loss.detach().clone()
    dist.all_reduce(mean, group=group)
    mean /= dist.get_world_size(group)
    return loss + (mean - loss.detach())


def global_mean(local_sum: torch.Tensor, local_count: torch.Tensor
                ) -> torch.Tensor:
    """The mean over the global batch of a per-item quantity of which this
    rank holds ``local_sum`` over ``local_count`` items: the value is the
    global mean on every rank; the gradient is ``world`` times this rank's
    share, which DDP's averaging turns into the global mean's gradient."""
    group = data_group()
    if group is None:
        return local_sum / local_count.clamp_min(1)
    count = local_count.detach().to(local_sum.dtype).clone()
    total = local_sum.detach().clone()
    dist.all_reduce(count, group=group)
    dist.all_reduce(total, group=group)
    count = count.clamp_min(1)
    term = local_sum * dist.get_world_size(group) / count
    return term + (total / count - term.detach())
