"""GradCache: exact big-batch contrastive gradients with one chunk's
activations live at a time (counterpart of
``clip_embeds_tpu/train/grad_cache.py``, VLM2Vec's ``grad_cache``):

  1. chunked ``no_grad`` encode -> full-batch representations;
  2. the full-batch loss and its gradient with respect to the
     representations (the cache);
  3. chunked re-forward, ``backward(cached cotangent)`` per chunk,
     accumulating the parameter gradients into ``.grad``.

The encoders here are deterministic (no dropout, no patch dropout), so the
re-forward needs no RNG replay.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

Reps = Dict[str, torch.Tensor]


def _chunks(batch: Dict[str, torch.Tensor], n_chunks: int
            ) -> List[Dict[str, torch.Tensor]]:
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n_chunks:
        raise ValueError(f"grad-cache needs one batch size divisible by "
                         f"{n_chunks} chunks, got {sorted(sizes)}")
    split = {k: v.chunk(n_chunks) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n_chunks)]


def cache_grad_step(encode_fn: Callable[[Dict[str, torch.Tensor]], Reps],
                    loss_fn: Callable[[Reps], torch.Tensor],
                    batch: Dict[str, torch.Tensor],
                    n_chunks: int,
                    after_backward: Optional[Callable[[], None]] = None
                    ) -> torch.Tensor:
    """Loss of ``loss_fn(encode_fn(batch))``; the gradients of every
    parameter ``encode_fn`` reaches are accumulated into ``.grad``.

    encode_fn(chunk) -> reps with leading axis the chunk size;
    loss_fn(full_reps) -> scalar over the full batch (global negatives);
    after_backward(), if given, runs after each chunk's backward.
    """
    chunks = _chunks(batch, n_chunks)
    with torch.no_grad():
        encoded = [encode_fn(c) for c in chunks]
    reps = {k: torch.cat([e[k] for e in encoded]).requires_grad_()
            for k in encoded[0]}
    with torch.enable_grad():
        loss = loss_fn(reps)
        rep_grads = torch.autograd.grad(loss, list(reps.values()))
    cotangents = {k: g.chunk(n_chunks) for k, g in zip(reps, rep_grads)}
    for i, chunk in enumerate(chunks):
        out = encode_fn(chunk)
        torch.autograd.backward([out[k] for k in reps],
                                [cotangents[k][i] for k in reps])
        if after_backward is not None:
            after_backward()
    return loss.detach()
