"""Faults planted under the timed path, for the check's own tests and for
reading a fault's numbers on the card: each a context manager that patches
the port while it is open. Never used by a run of the benchmark."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged():
    """The train step returns its state unchanged: the update is skipped
    (the gradients are cleared and the update counted, as after a step)."""
    from clip_embeds_tpu_torch.train import steps

    def apply_gradients(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    with _patched(steps.TrainState, "apply_gradients", apply_gradients):
        yield


@contextlib.contextmanager
def half_batch():
    """Half of the batch left out: the loss is the mean over the first half
    of the rows (and of the hard negatives)."""
    from clip_embeds_tpu_torch.train import steps

    loss_fn = steps.clip_train_loss

    def clip_train_loss(model, batch, *args, **kw):
        half = {k: v[: max(1, len(v) // 2)] for k, v in batch.items()}
        return loss_fn(model, half, *args, **kw)

    with _patched(steps, "clip_train_loss", clip_train_loss):
        yield


@contextlib.contextmanager
def _encode_altered(alter):
    """Every batch the entry point encodes goes through ``alter(encode)``
    in place of ``encode``."""
    from clip_embeds_tpu_torch.cli import embed

    run = embed._run

    def altered(encode, state, batches, batch_size, devices):
        return run(alter(encode), state, batches, batch_size, devices)

    with _patched(embed, "_run", altered):
        yield


def answer_altered():
    """An answer altered where it is produced: the last embedding of every
    batch comes back negated."""
    def alter(encode):
        def enc(st, x):
            out = encode(st, x).clone()
            out[-1] = -out[-1]
            return out
        return enc

    return _encode_altered(alter)


def rows_permuted():
    """Every batch's embeddings come back in another order: rolled by one
    row, so each row is another input's."""
    import torch

    def alter(encode):
        return lambda st, x: torch.roll(encode(st, x), 1, dims=0)

    return _encode_altered(alter)


def stale_batch():
    """Every batch after the first comes back with the embeddings of the
    batch before it."""
    def alter(encode):
        prev = []

        def enc(st, x):
            out = encode(st, x)
            old = prev[0] if prev else out
            prev[:] = [out]
            return old
        return enc

    return _encode_altered(alter)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "rows_permuted": rows_permuted,
          "stale_batch": stale_batch}
