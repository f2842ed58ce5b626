"""The train steps (counterpart of ``clip_embeds_tpu/train/steps.py``):
``make_clip_train_step``, the CLIP contrastive step (open_clip's
``train_one_epoch``: forward both towers, InfoNCE, SigLIP or hard-text loss,
backward, AdamW update, optionally after global-norm clipping, then the
logit scale clamped to ln(100)); ``make_distill_train_step``, the same step
with open_clip's knowledge distillation from a frozen teacher; and
``make_frozen_tower_train_step``, the PACL/SPARC step that trains a head on a frozen tower's features. Where the
config has FLIP patch dropout, the CLIP step draws it from a generator
seeded from (seed, step), as the JAX step folds the step into
``PRNGKey(seed)``: the same seed gives the same run, not JAX's draw.
``make_coca_train_step`` is CoCa's: the weighted contrastive loss plus the
teacher-forced caption loss, then the same update and clamp.

PyTorch updates the parameters in place, so the state is a small mutable
object: the model, its optimizer, the update count and the learning-rate
schedule.

Under a process group (``parallel/``) each rank runs the step on its slice
of the global batch: the steps take the ``DistributedDataParallel`` wrapper
as ``model`` (or the FSDP2 model itself), the losses gather the features,
and the state's ``grad_sync`` averages the gradients that no wrapper
reduces (FSDP's whole leaves) before the update. The gradient of every
parameter is then JAX's gradient of the global batch. Patch dropout draws
the global batch's noise on every rank and keeps its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import tracing
from ..losses.clip_loss import (
    clip_loss, clip_loss_hard_text, clip_metrics, distill_clip_loss)
from ..losses.siglip import siglip_loss, siglip_loss_ring
from ..parallel.mesh import data_rank, data_world
from .grad_cache import cache_grad_step
from .optim import clip_by_global_norm
from .schedules import Schedule

LOGIT_SCALE_MAX = 4.6052  # ln(100)

Batch = Dict[str, torch.Tensor]
Features = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    max_grad_norm: Optional[float] = None
    step: int = 0  # updates applied; the schedule reads it before each
    # averages the gradients no wrapper reduces (FSDP's whole leaves)
    grad_sync: Optional[Callable[[], None]] = None

    def apply_gradients(self) -> None:
        """Average what ``grad_sync`` averages, clip (optax
        ``clip_by_global_norm`` over the trainable parameters), set the
        scheduled learning rate, update, clear the gradients and count the
        update (the span ``train.update``)."""
        with tracing.span("train.update"):
            if self.grad_sync is not None:
                self.grad_sync()
            params = [p for g in self.optimizer.param_groups
                      for p in g["params"]]
            if self.max_grad_norm is not None:
                clip_by_global_norm(params, self.max_grad_norm)
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.step += 1


def patch_dropout_generator(seed: int, step: int,
                            device: torch.device) -> torch.Generator:
    """The generator of step ``step``'s patch dropout on ``device``."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def unwrap(model: nn.Module) -> nn.Module:
    """The model inside a ``DistributedDataParallel`` wrapper, else
    ``model``."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def global_keep_idx(cfg, rows: int, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """This rank's rows of the patches the global batch keeps: the image
    tower's draw (noise [B, n_patches], its top-k) over the global batch
    of ``rows`` x ranks, sliced as the batch is."""
    from ..models.vit import patches_kept

    world, rank = data_world(), data_rank()
    n = cfg.vision.num_patches
    noise = torch.rand(rows * world, n, generator=generator, device=device)
    keep = noise.topk(patches_kept(n, cfg.vision.patch_dropout),
                      dim=1).indices
    return keep[rank * rows:(rank + 1) * rows]


def clip_train_loss(model: nn.Module, batch: Batch,
                    use_hard_text: bool = False, use_siglip: bool = False,
                    generator: Optional[torch.Generator] = None,
                    keep_idx: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch: 'images' [B, S, S, 3], 'texts'
    [B, ctx]; with ``use_hard_text`` also 'hard_texts' [H, ctx] and
    optionally 'hard_valid' [H] bool. ``use_siglip`` takes the sigmoid
    loss with the model's logit bias (None for the CLIP configs); the
    hard-text loss comes first where both are asked, as in JAX. With
    ``generator`` (or ``keep_idx``) the image tower drops patches where its
    config says so (the hard texts go through the text tower alone, as in
    JAX). Under a process group the sigmoid loss is the ring form."""
    drop = generator is not None or keep_idx is not None
    kw = {"keep_idx": keep_idx} if keep_idx is not None else {}
    out = model(batch["images"], batch["texts"], deterministic=not drop,
                generator=generator, **kw)
    img, txt, scale = (out["image_features"], out["text_features"],
                       out["logit_scale"])
    if use_hard_text:
        hard = unwrap(model).encode_text(batch["hard_texts"], normalize=True)
        loss = clip_loss_hard_text(img, txt, hard, scale,
                                   hard_valid=batch.get("hard_valid"))
    elif use_siglip:
        ring = data_world() > 1
        loss = (siglip_loss_ring if ring else siglip_loss)(
            img, txt, scale, out.get("logit_bias"))
    else:
        loss = clip_loss(img, txt, scale, out.get("logit_bias"))
    metrics = clip_metrics(img, txt, scale)
    metrics["logit_scale"] = scale.detach()
    return loss, metrics


def make_clip_train_step(model: nn.Module, use_hard_text: bool = False,
                         grad_cache_chunks: int = 0, use_siglip: bool = False,
                         seed: int = 0
                         ) -> Callable[[TrainState, Batch], Dict]:
    """A train step ``step(state, batch) -> metrics`` (metrics hold 0-d
    tensors; reading them syncs the device).

    With ``grad_cache_chunks`` > 1 the gradients come from
    :func:`~.grad_cache.cache_grad_step` over that many chunks, InfoNCE
    only; as in JAX, the logit scale is then a constant of the loss and
    gets no gradient, and the cached encode runs without patch dropout.
    Elsewhere a config with patch dropout draws it from
    :func:`patch_dropout_generator` (``seed``, the update count); under a
    process group, over the global batch (:func:`global_keep_idx`).
    ``model`` may be a ``DistributedDataParallel`` wrapper, whose
    ``no_sync`` then keeps all but the last GradCache chunk's gradients
    local. Under a torch profiler the step records the spans
    ``train.step`` > ``train.forward``, ``train.backward``,
    ``train.update`` (``core/tracing.py``); a GradCache step's chunks
    interleave forward and backward, so only its update is split out."""
    core = unwrap(model)
    use_patch_dropout = core.cfg.vision.patch_dropout > 0.0
    if grad_cache_chunks > 1 and (use_hard_text or use_siglip):
        raise ValueError("grad-cache supports the InfoNCE objective only")

    def encode(chunk: Batch) -> Dict[str, torch.Tensor]:
        out = model(chunk["images"], chunk["texts"])
        return {"img": out["image_features"], "txt": out["text_features"]}

    def train_step(state: TrainState, batch: Batch) -> Dict:
        with tracing.span("train.step", seq=state.step, mallocs=True):
            if grad_cache_chunks > 1:
                scale = core.logit_scale.detach().exp()
                loss = cache_grad_step(
                    encode, lambda reps: clip_loss(reps["img"], reps["txt"],
                                                   scale),
                    batch, grad_cache_chunks,
                    no_sync=getattr(model, "no_sync", None))
                metrics = {"logit_scale": scale}
            else:
                generator = keep_idx = None
                if use_patch_dropout:
                    generator = patch_dropout_generator(
                        seed, state.step, batch["images"].device)
                    if data_world() > 1:
                        keep_idx = global_keep_idx(
                            core.cfg, batch["images"].shape[0], generator,
                            batch["images"].device)
                        generator = None
                with tracing.span("train.forward"):
                    loss, metrics = clip_train_loss(
                        model, batch, use_hard_text, use_siglip, generator,
                        keep_idx)
                with tracing.span("train.backward"):
                    loss.backward()
                loss = loss.detach()
            state.apply_gradients()
            with torch.no_grad():
                core.logit_scale.clamp_(max=LOGIT_SCALE_MAX)
        return dict(metrics, loss=loss)

    return train_step


def distill_train_loss(model: nn.Module, teacher: nn.Module, batch: Batch
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one distillation batch: the teacher forwards the
    same 'images' and 'texts' under ``torch.no_grad()``, so no gradient
    reaches it; the loss is the student's InfoNCE plus the KD
    cross-entropy against the teacher's logits (open_clip
    ``DistillClipLoss``; JAX ``make_distill_train_step``), both in the
    metrics beside the in-batch accuracies. The teacher is whole on every
    rank, outside any wrapper."""
    out = model(batch["images"], batch["texts"])
    with torch.no_grad():
        t_out = teacher(batch["images"], batch["texts"])
    img, txt, scale = (out["image_features"], out["text_features"],
                       out["logit_scale"])
    contrastive, distill = distill_clip_loss(
        img, txt, scale, t_out["image_features"], t_out["text_features"],
        t_out["logit_scale"].float())
    metrics = clip_metrics(img, txt, scale)
    metrics.update(contrastive_loss=contrastive.detach(),
                   distill_loss=distill.detach(),
                   logit_scale=scale.detach())
    return contrastive + distill, metrics


def make_distill_train_step(model: nn.Module, teacher: nn.Module
                            ) -> Callable[[TrainState, Batch], Dict]:
    """``step(state, batch) -> metrics`` with :func:`distill_train_loss`
    (open_clip ``--distill``). ``teacher`` stays outside the state: give it
    ``requires_grad_(False)``; the optimizer never sees it. As in JAX the
    towers run without patch dropout, and the logit scale is clamped as in
    the plain step."""

    def train_step(state: TrainState, batch: Batch) -> Dict:
        loss, metrics = distill_train_loss(model, teacher, batch)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            unwrap(model).logit_scale.clamp_(max=LOGIT_SCALE_MAX)
        return dict(metrics, loss=loss.detach())

    return train_step


def make_coca_train_step(model: nn.Module, caption_loss_weight: float = 2.0,
                         clip_loss_weight: float = 1.0
                         ) -> Callable[[TrainState, Batch], Dict]:
    """``step(state, batch) -> metrics`` for a ``models/coca.py CoCa``
    (JAX ``make_coca_train_step``; open_clip ``--coca-caption-loss-weight``
    / ``--coca-contrastive-loss-weight``): the weighted InfoNCE plus the
    caption cross-entropy over the non-pad labels, AdamW, and the logit
    scale clamped as in the CLIP step. 'images' [B, S, S, 3], 'texts'
    [B, L]; the metrics hold both weighted losses beside their sum."""
    from ..losses.coca import coca_loss

    core = unwrap(model)

    def train_step(state: TrainState, batch: Batch) -> Dict:
        out = model(batch["images"], batch["texts"])
        losses = coca_loss(out, caption_loss_weight, clip_loss_weight,
                           pad_id=core.cfg.pad_id)
        losses["loss"].backward()
        state.apply_gradients()
        with torch.no_grad():
            core.logit_scale.clamp_(max=LOGIT_SCALE_MAX)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["logit_scale"] = out["logit_scale"].detach()
        return metrics

    return train_step


def make_frozen_tower_train_step(
    loss_of_head: Callable[[nn.Module, Features, Batch],
                           Tuple[torch.Tensor, Dict]],
) -> Callable[[TrainState, Features, Batch], Dict]:
    """A step ``step(state, feats, batch) -> metrics`` where only the head
    (``state.model``) trains: the PACL/SPARC pattern (reference
    train_pacl.py / pacl.py:97). ``feats`` are the frozen tower's outputs,
    computed by the caller under ``torch.no_grad()`` from a model whose
    parameters do not require grad, so none of the tower's activations is
    kept for the backward (JAX's ``stop_gradient``).

    loss_of_head(head, feats, batch) -> (loss, metrics)
    """

    def train_step(state: TrainState, feats: Features, batch: Batch) -> Dict:
        loss, metrics = loss_of_head(state.model, feats, batch)
        loss.backward()
        state.apply_gradients()
        return dict(metrics, loss=loss.detach())

    return train_step
