"""The train steps (counterpart of ``clip_embeds_tpu/train/steps.py``):
``make_clip_train_step``, the CLIP contrastive step (open_clip's
``train_one_epoch``: forward both towers, InfoNCE, SigLIP or hard-text loss,
backward, AdamW update, optionally after global-norm clipping, then the
logit scale clamped to ln(100)); and ``make_frozen_tower_train_step``, the
PACL/SPARC step that trains a head on a frozen tower's features. Where the
config has FLIP patch dropout, the CLIP step draws it from a generator
seeded from (seed, step), as the JAX step folds the step into
``PRNGKey(seed)``: the same seed gives the same run, not JAX's draw.

PyTorch updates the parameters in place, so the state is a small mutable
object: the model, its optimizer, the update count and the learning-rate
schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..losses.clip_loss import clip_loss, clip_loss_hard_text, clip_metrics
from ..losses.siglip import siglip_loss
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

    def apply_gradients(self) -> None:
        """Clip (optax ``clip_by_global_norm`` over the trainable
        parameters), set the scheduled learning rate, update, clear the
        gradients and count the update."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
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


def clip_train_loss(model: nn.Module, batch: Batch,
                    use_hard_text: bool = False, use_siglip: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch: 'images' [B, S, S, 3], 'texts'
    [B, ctx]; with ``use_hard_text`` also 'hard_texts' [H, ctx] and
    optionally 'hard_valid' [H] bool. ``use_siglip`` takes the sigmoid
    loss with the model's logit bias (None for the CLIP configs); the
    hard-text loss comes first where both are asked, as in JAX. With
    ``generator`` the image tower drops patches where its config says so
    (the hard texts go through the text tower alone, as in JAX)."""
    out = model(batch["images"], batch["texts"],
                deterministic=generator is None, generator=generator)
    img, txt, scale = (out["image_features"], out["text_features"],
                       out["logit_scale"])
    if use_hard_text:
        hard = model.encode_text(batch["hard_texts"], normalize=True)
        loss = clip_loss_hard_text(img, txt, hard, scale,
                                   hard_valid=batch.get("hard_valid"))
    elif use_siglip:
        loss = siglip_loss(img, txt, scale, out.get("logit_bias"))
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
    :func:`patch_dropout_generator` (``seed``, the update count)."""
    use_patch_dropout = model.cfg.vision.patch_dropout > 0.0
    if grad_cache_chunks > 1 and (use_hard_text or use_siglip):
        raise ValueError("grad-cache supports the InfoNCE objective only")

    def encode(chunk: Batch) -> Dict[str, torch.Tensor]:
        out = model(chunk["images"], chunk["texts"])
        return {"img": out["image_features"], "txt": out["text_features"]}

    def train_step(state: TrainState, batch: Batch) -> Dict:
        if grad_cache_chunks > 1:
            scale = model.logit_scale.detach().exp()
            loss = cache_grad_step(
                encode, lambda reps: clip_loss(reps["img"], reps["txt"],
                                               scale),
                batch, grad_cache_chunks)
            metrics = {"logit_scale": scale}
        else:
            generator = (patch_dropout_generator(
                seed, state.step, batch["images"].device)
                if use_patch_dropout else None)
            loss, metrics = clip_train_loss(model, batch, use_hard_text,
                                            use_siglip, generator)
            loss.backward()
            loss = loss.detach()
        state.apply_gradients()
        with torch.no_grad():
            model.logit_scale.clamp_(max=LOGIT_SCALE_MAX)
        return dict(metrics, loss=loss)

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
