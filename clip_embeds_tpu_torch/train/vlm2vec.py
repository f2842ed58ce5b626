"""VLM2Vec embedding training: LoRA + contrastive loss + GradCache
(counterpart of ``clip_embeds_tpu/train/vlm2vec.py``).

Reference: VLM2Vec/train.py + src/trainer.py (GradCacheTrainer) +
src/loss.py (T = 0.02); recipe scripts/llava_1.5/run_train.sh: batch 64 a
GPU, lr 2e-5 linear, 1000 steps. A step encodes the query and target sides
(last-token pooling), takes the in-batch contrastive loss (both directions
averaged when ``bidirectional``), accumulates the gradients, directly or
through ``train/grad_cache.py cache_grad_step``, and applies the update.

Three trainable modes, as in JAX:

* materialized adapters over a frozen base (``model.lora_rank == 0``,
  ``state.params`` an adapter tree): the step runs the model on
  ``models/lora.py materialize``'s weights (the base detached) through
  ``torch.func.functional_call``, made once a step and kept in place
  through each backward (remat's recompute too); after each backward the
  merged weights' gradients go on through the merge to the adapters, where
  the GradCache chunks' gradients add up in fp32 (JAX merges at each
  encode; the gradient is the same);
* the unmaterialized side-path (``model.lora_rank > 0``, fp or int8 base):
  the tree is attached to the model's layers (``attach_lora``) and the base
  is never rewritten. The model's ``lora_alpha`` scales it: a step asked
  for another alpha raises (JAX ignores the step's);
* full fine-tuning (``base=False``, mixed step only): ``state.params`` is
  the model, every parameter trains.

In the adapter modes the step runs on the base's tensors detached, so
the base gets no gradient and its vision tower builds no graph: the
flash kernel runs forward only there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch import nn

from ..losses.clip_loss import embedding_contrastive_loss
from ..models.lora import attach_lora, materialize
from .grad_cache import cache_grad_step
from .steps import TrainState

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Vlm2VecState(TrainState):
    """:class:`~.steps.TrainState` (``model`` the LLaVA) plus ``params``:
    the trainable adapter tree, or the model itself when fine-tuning it
    all."""

    params: Any = None


class _Run(nn.Module):
    """Runs ``fn()`` as its forward, so that ``functional_call`` keeps
    ``model``'s substituted weights (names prefixed 'model.') in place for
    the whole of it: the forward passes, the backward and any recompute."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self):
        return self.fn()


def adapter_runner(model: nn.Module, lora_alpha: float, base: bool):
    """run(trainable, step_fn) -> step_fn(call, flush): ``call(method,
    *args)`` runs the model in the step's mode; step_fn does the forward
    passes and the backwards, and calls ``flush()`` after each backward;
    the gradients reach the trainable tensors."""
    unmaterialized = getattr(model, "lora_rank", 0) > 0
    if unmaterialized:
        if not base:
            raise ValueError("model.lora_rank > 0 requires base_params")
        if float(lora_alpha) != float(model.lora_alpha):
            raise ValueError(
                f"the unmaterialized side-path scales by the model's "
                f"lora_alpha {model.lora_alpha}, not the step's "
                f"{lora_alpha} (JAX ignores the step's)")

    def call(method, *args):
        return getattr(model, method)(*args)

    def run(trainable, step_fn):
        if not base:
            return step_fn(call, lambda: None)
        # the step runs on the base's tensors detached (JAX's
        # stop_gradient), so no gradient reaches the base whatever its
        # requires_grad; materialized adapters replace the adapted weights
        # by merged leaves, in place for the whole step; after each
        # backward the leaves' gradients go on through the merge to the
        # adapters (fp32), so no full-size gradient is kept across
        # GradCache chunks
        if unmaterialized:
            attach_lora(model, trainable)
            weights = model.state_dict()
        else:
            weights = materialize(model, trainable, lora_alpha)
        merged = {k: w for k, w in weights.items() if w.requires_grad}
        leaves = {k: w.detach().requires_grad_() for k, w in merged.items()}

        def flush():
            keys = [k for k, v in leaves.items() if v.grad is not None]
            if keys:
                torch.autograd.backward([merged[k] for k in keys],
                                        [leaves[k].grad for k in keys],
                                        retain_graph=True)
            for k in keys:
                leaves[k].grad = None

        return torch.func.functional_call(
            _Run(model, lambda: step_fn(call, flush)),
            {"model." + k: leaves.get(k, w) for k, w in weights.items()},
            ())

    return run


def make_vlm2vec_train_step(
    model: nn.Module,
    lora_alpha: float = 16.0,
    temperature: float = 0.02,
    grad_cache_chunks: int = 0,
    bidirectional: bool = False,
) -> Callable[[Vlm2VecState, Batch], Dict]:
    """Train step over a LoRA adapter tree on image-query pairs: batch keys
    qry_ids / qry_mask / qry_pixels (image queries) and tgt_ids / tgt_mask
    (text targets), as ``data/mmeb.py pair_batches`` yields them."""

    def encode(call, batch):
        return {"qry": call("embed_last_token", batch["qry_ids"],
                            batch["qry_pixels"], batch["qry_mask"]),
                "tgt": call("embed_last_token", batch["tgt_ids"], None,
                            batch["tgt_mask"])}

    return _make_step(adapter_runner(model, lora_alpha, True), encode, temperature,
                      bidirectional, grad_cache_chunks)


def make_vlm2vec_mixed_train_step(
    model: nn.Module,
    base: bool = True,
    lora_alpha: float = 16.0,
    temperature: float = 0.02,
    grad_cache_chunks: int = 0,
    bidirectional: bool = False,
) -> Callable[[Vlm2VecState, Batch], Dict]:
    """Train step over MMEB mixed image/text batches: any row on either
    side may carry an image (``data/mmeb.py mixed_pair_batches``); each side
    pools through ``Llava.embed_mixed``. Batch keys per side:
    {qry,tgt}_ids / _mask / _pixels / _image_valid. ``base`` True:
    ``state.params`` is an adapter tree over the frozen model (JAX's
    ``base_params`` given); False: full fine-tuning (JAX's
    ``base_params=None``)."""

    def encode(call, batch):
        def side(p):
            return call("embed_mixed", batch[f"{p}_ids"],
                        batch[f"{p}_pixels"], batch[f"{p}_image_valid"],
                        batch[f"{p}_mask"])

        return {"qry": side("qry"), "tgt": side("tgt")}

    return _make_step(adapter_runner(model, lora_alpha, base), encode, temperature,
                      bidirectional, grad_cache_chunks)


def _make_step(run, encode, temperature, bidirectional, grad_cache_chunks):
    def rep_loss(reps):
        loss = embedding_contrastive_loss(reps["qry"], reps["tgt"],
                                          temperature)
        if bidirectional:
            loss = (loss + embedding_contrastive_loss(
                reps["tgt"], reps["qry"], temperature)) / 2
        return loss

    def train_step(state: Vlm2VecState, batch: Batch) -> Dict:
        def step_fn(call, flush):
            if grad_cache_chunks > 1:
                return cache_grad_step(lambda chunk: encode(call, chunk),
                                       rep_loss, batch, grad_cache_chunks,
                                       after_backward=flush)
            loss = rep_loss(encode(call, batch))
            loss.backward()
            flush()
            return loss.detach()

        loss = run(state.params, step_fn)
        state.apply_gradients()
        return {"loss": loss}

    return train_step
