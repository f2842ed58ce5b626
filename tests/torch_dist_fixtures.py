"""Spawned gloo ranks for the multi-GPU tests (tests/test_torch_parallel*.py).

The rank bodies live here, in a module that imports torch, numpy and the
port only: a spawned rank imports the module of its body, and must not
import JAX. The tests compute JAX's side in their own process and compare
there, from the files each rank writes (``rank<r>.pt`` under the test's
temporary directory). Every rank runs torch on one thread and meets the
others in a ``file://`` store in that directory: no network and no port."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

from clip_embeds_tpu_torch.core.config import get_model_config
from clip_embeds_tpu_torch.models.clip import CLIP
from clip_embeds_tpu_torch.parallel import mesh as pmesh

# the global batch of the loss cases: 16 rows of width 32, H = 16 // 4
LOSS_B, LOSS_D = 16, 32
# test-tiny at 64 px in patches of 8 (64 patch tokens); the train cases'
# global batch
SIZE, PATCH, TRAIN_B = 64, 8, 8


def _entry(rank: int, body: Callable, world: int, tmp: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world)
    try:
        out = body(rank, world, tmp, *args)
        if out is not None:
            torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        pmesh.close_distributed()


def run_ranks(body: Callable, world: int, tmp, *args) -> List:
    """Run ``body(rank, world, tmp, *args)`` on ``world`` spawned gloo
    ranks; returns what each rank returned, in rank order."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, "store")
    if os.path.exists(store):
        os.remove(store)
    tmp_mp.start_processes(_entry, args=(body, world, tmp, args),
                           nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
        if os.path.exists(path):
            os.remove(path)
    return out


def rows(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


# -- the gathered losses ---------------------------------------------------

def loss_inputs(seed: int = 0):
    """The global batch of the loss cases: unit rows."""
    rng = np.random.default_rng(seed)

    def feats(n):
        a = rng.standard_normal((n, LOSS_D)).astype(np.float32)
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    h = LOSS_B // 4
    labels = rng.integers(1, 11, (LOSS_B, 5))
    labels[rng.random((LOSS_B, 5)) < 0.4] = 0  # pads, unevenly over rows
    return {"img": feats(LOSS_B), "txt": feats(LOSS_B), "hard": feats(h),
            "valid": np.arange(h) % 3 != 1, "t_img": feats(LOSS_B),
            "t_txt": feats(LOSS_B),
            "logits": rng.standard_normal((LOSS_B, 5, 11)).astype(
                np.float32), "labels": labels}


def _loss_cases():
    from clip_embeds_tpu_torch.losses import clip_loss as L
    from clip_embeds_tpu_torch.losses.coca import caption_loss
    from clip_embeds_tpu_torch.losses.siglip import siglip_loss_ring

    s = torch.tensor(14.0)
    return {
        "clip_loss": lambda f: L.clip_loss(f["img"], f["txt"], s),
        "clip_loss_hard_text": lambda f: L.clip_loss_hard_text(
            f["img"], f["txt"], f["hard"], s, hard_valid=f["valid"]),
        "distill_clip_loss": lambda f: L.distill_clip_loss(
            f["img"], f["txt"], s, f["t_img"], f["t_txt"],
            torch.tensor(20.0)),
        "embedding_contrastive_loss": lambda f: L.embedding_contrastive_loss(
            f["img"], f["txt"]),
        "pacl_clip_loss": lambda f: L.pacl_clip_loss(f["img"], f["txt"]),
        "siglip_loss_ring": lambda f: siglip_loss_ring(
            f["img"], f["txt"], torch.tensor(10.0), torch.tensor(-10.0)),
        "clip_metrics": lambda f: L.clip_metrics(f["img"], f["txt"], s),
        "caption_loss": lambda f: caption_loss(f["logits"], f["labels"]),
    }


def losses_rank(rank: int, world: int, tmp: str, inputs):
    """Each loss of this rank's slices: its values and the gradients of
    this rank's feature rows (DDP's convention: the gradient of the sum
    over the ranks' losses)."""
    out = {}
    for name, fn in _loss_cases().items():
        f = {k: torch.from_numpy(rows(v, rank, world).copy())
             for k, v in inputs.items()}
        for k in ("img", "txt", "hard", "logits"):
            f[k].requires_grad_()
        val = fn(f)
        vals = val if isinstance(val, (tuple, dict)) else (val,)
        if isinstance(val, dict):
            vals = tuple(val[k] for k in sorted(val))
        total = sum(v for v in vals if v.requires_grad) \
            if any(v.requires_grad for v in vals) else None
        if total is not None:
            total.backward()
        out[name] = {
            "values": [float(v.detach()) for v in vals],
            "grads": {k: f[k].grad.numpy().copy() for k in
                      ("img", "txt", "hard", "logits")
                      if f[k].grad is not None}}
    return out


# -- one train step --------------------------------------------------------

def tiny_config(drop: float = 0.0):
    cfg = get_model_config("test-tiny")
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_size=SIZE, patch_size=PATCH, patch_dropout=drop))


def random_state_dict(cfg, seed: int = 0, std: float = 0.05):
    """A state dict with every entry random (LayerNorm gains near 1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in CLIP(cfg).state_dict().items():
        a = std * rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith("weight") and ".ln" in "." + k and v.ndim == 1:
            a += 1.0
        sd[k] = torch.from_numpy(np.asarray(a, np.float32))
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if v.dtype == np.int32 else torch.from_numpy(
                np.ascontiguousarray(v)) for k, v in batch.items()}


# the train cases: (block route, FSDP, grad-cache chunks, hard texts,
# patch dropout)
TRAIN_MODES = {
    "ddp": ("composable", False, 0, False, 0.0),
    "fsdp_fused_train_res": ("fused-train-res", True, 0, False, 0.0),
    "grad_cache": ("composable", False, 2, False, 0.0),
    "hardtext": ("composable", False, 0, True, 0.0),
    "patch_dropout": ("composable", False, 0, False, 0.5),
}
# FSDP's min_size in the train cases: test-tiny's leaves are small, so
# that most of them are sharded
FSDP_MIN_SIZE = 256


def sgd_step(model, forward, grad_sync, step_kw, batch, steps=1,
             optimizer=None):
    """``steps`` train steps; returns the whole state dicts before and
    after (SGD at lr 1 by default: the difference is the gradient)."""
    from clip_embeds_tpu_torch.core.checkpoint import full_state_dict
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState, make_clip_train_step)

    before = {k: v.clone() for k, v in full_state_dict(model).items()}
    opt = optimizer(model) if optimizer else torch.optim.SGD(
        model.parameters(), 1.0)
    lr = opt.param_groups[0]["lr"]
    state = TrainState(model, opt, const_lr(lr), grad_sync=grad_sync)
    step = make_clip_train_step(forward, **step_kw)
    losses = [float(step(state, batch)["loss"]) for _ in range(steps)]
    after = {k: v.clone() for k, v in full_state_dict(model).items()}
    return before, after, losses


def train_rank(rank: int, world: int, tmp: str, cases):
    """Each case ``label -> dict(mode=, batch=, sd=[, keep=, steps=,
    adamw=])``: the :data:`TRAIN_MODES` mode on this rank's rows of the
    global ``batch`` from the state dict ``sd``, ``steps`` steps of SGD at
    lr 1 (or AdamW at lr 1e-3, weight decay 0.1), ``keep`` JAX's patch
    indices over the global batch. Returns, a case, the losses, the
    sharded parameters' count and (rank 0) the whole state dicts before
    and after."""
    from torch.distributed.tensor import DTensor

    from clip_embeds_tpu_torch.parallel.sharding_rules import distribute
    from clip_embeds_tpu_torch.train import steps as steps_mod
    from clip_embeds_tpu_torch.train.optim import adamw as make_adamw

    mesh = pmesh.create_mesh()
    real_keep = steps_mod.global_keep_idx
    out = {}
    for label, case in cases.items():
        block_impl, fsdp, chunks, hard, drop = TRAIN_MODES[case["mode"]]
        model = CLIP(tiny_config(drop), block_impl=block_impl).train()
        model.load_state_dict(case["sd"])
        forward, grad_sync = distribute(model, mesh, fsdp=fsdp,
                                        min_size=FSDP_MIN_SIZE,
                                        find_unused_parameters=chunks > 1)
        keep = case.get("keep")
        steps_mod.global_keep_idx = real_keep if keep is None else (
            lambda cfg, n, g, d, keep=keep: torch.from_numpy(
                rows(keep, rank, world).copy()).long())
        local = to_torch(pmesh.shard_batch(case["batch"], rank, world))
        opt = (lambda m: make_adamw(m, 1e-3, weight_decay=0.1)) \
            if case.get("adamw") else None
        before, after, losses = sgd_step(
            model, forward, grad_sync,
            dict(use_hard_text=hard, grad_cache_chunks=chunks, seed=9),
            local, case.get("steps", 1), opt)
        out[label] = {"losses": losses, "sharded": sum(
            isinstance(p, DTensor) for p in model.parameters())}
        if rank == 0:
            out[label].update(before=before, after=after)
    steps_mod.global_keep_idx = real_keep
    return out


# -- tensor parallelism ----------------------------------------------------

def tp_llama(rank: int, world: int, cfg, sd, ids):
    """The Llama forward with the trunk tensor-parallel over a (1, world)
    mesh's model dimension; returns the logits and the sharded
    parameters' names."""
    from torch.distributed.tensor import DTensor

    from clip_embeds_tpu_torch.models.llama import LlamaForCausalLM
    from clip_embeds_tpu_torch.parallel.sharding_rules import shard_params

    model = LlamaForCausalLM(cfg).eval()
    model.load_state_dict(sd)
    mesh = pmesh.create_mesh(1, world)
    shard_params(model, mesh)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long())
    sharded = sorted(n for n, p in model.named_parameters()
                     if isinstance(p, DTensor))
    return {"logits": logits.numpy(), "sharded": sharded,
            "placements": (pmesh.batch_sharding(mesh),
                           pmesh.replicated_sharding(mesh))}


def zero1_adamw(rank: int, world: int, seed: int = 0, steps: int = 2):
    """``steps`` AdamW steps of a small MLP on this rank's rows, the
    moments sharded (ZeRO-1) and the gradients averaged by DDP; returns
    the parameters after and the moments this rank holds."""
    from torch.nn.parallel import DistributedDataParallel

    from clip_embeds_tpu_torch.parallel.sharding_rules import (
        zero1_opt_state_sharding)

    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                                torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn(8, 8, generator=gen)
    ddp = DistributedDataParallel(model)
    opt = zero1_opt_state_sharding(model, lr=1e-2, weight_decay=0.1)
    for _ in range(steps):
        ddp(torch.from_numpy(rows(x.numpy(), rank, world).copy())
            ).square().mean().backward()
        opt.step()
        opt.zero_grad()
    held = sum(len(s) > 0 for s in opt.optim.state.values())
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, \
        held, x


def parallel_rank(rank: int, world: int, tmp: str, inputs, llama=None):
    """The gathered losses; at 2 ranks also the tensor-parallel Llama
    (``llama``: its config, state dict and ids) and ZeRO-1."""
    out = {"losses": losses_rank(rank, world, tmp, inputs)}
    if llama is not None:
        out["tp_llama"] = tp_llama(rank, world, *llama)
        out["zero1"] = zero1_adamw(rank, world)
    return out


# -- the CLIs --------------------------------------------------------------

def train_cli_rank(rank: int, world: int, tmp: str, argv):
    """``cli/train.py main(argv)`` on this rank; returns the losses it
    logged (rank 0 alone logs) and (rank 0) the whole state dict it ended
    with."""
    import logging

    from clip_embeds_tpu_torch.cli.train import main
    from clip_embeds_tpu_torch.core.checkpoint import full_state_dict

    losses = []

    class Log(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if " loss " in msg and "step" in msg:
                losses.append(float(msg.split(" loss ")[1].split()[0]))

    log = Log()
    logging.getLogger().addHandler(log)
    logging.getLogger().setLevel(logging.INFO)  # main quiets rank > 0
    try:
        state = main(argv)
    finally:
        logging.getLogger().removeHandler(log)
    full = full_state_dict(state.model)
    return {"losses": losses, "state_dict": full if rank == 0 else None,
            "step": state.step}


def vlm2vec_cli_rank(rank: int, world: int, tmp: str, argv):
    """``cli/train_vlm2vec.py main(argv)`` on this rank; returns its
    report and the adapters it ended with."""
    from clip_embeds_tpu_torch.cli.train_vlm2vec import main

    state, report = main(argv)
    adapters = {k: {n: t.detach().clone() for n, t in ab.items()}
                for k, ab in state.params.items()}
    return {"report": report, "adapters": adapters}


def cli_runs_rank(rank: int, world: int, tmp: str, runs):
    """Each ``(kind, argv)`` of ``runs`` in turn on this rank, ``kind``
    'train' or 'vlm2vec'; returns their results."""
    body = {"train": train_cli_rank, "vlm2vec": vlm2vec_cli_rank}
    return [body[kind](rank, world, tmp, argv) for kind, argv in runs]

