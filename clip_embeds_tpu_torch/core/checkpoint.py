"""Checkpoints with latest-election and atomic writes (counterpart of
``clip_embeds_tpu/core/checkpoint.py``; open_clip ``main.py``'s per-epoch
files, ``--resume latest`` and atomic replace).

A checkpoint is one ``torch.save`` file, ``<dir>/epoch_<step>.pt``, holding
``{"state_dict": <open_clip-layout state dict>, "step": <int>}``: the
parameters and the step, what the JAX CLI saves (no optimizer state). The
port's ``--pretrained`` loads the file as it is. A save writes a temporary
file in the same directory and ``os.replace``-s it into place, so a reader
sees the old file or the new one, never half of one.

Under a process group rank 0 alone writes, from :func:`full_state_dict`,
which every rank calls (an FSDP-sharded model gathers its shards there), so
a checkpoint of any number of ranks loads into one process and the
reverse.

``save(..., blocking=False)`` (``--async-checkpoints``; JAX's orbax
``AsyncCheckpointer``) copies the state to the host, returns, and writes
the file on a thread. Saves stay in order: any save first waits until the
previous asynchronous one has committed, so a caller that prunes the
previous file after ``save`` returns never prunes one still being written.
An error of the writer is raised by the next ``save`` or by
:func:`wait_for_saves`.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
from typing import Any, Dict, Optional

import torch

CKPT_PREFIX = "epoch_"
# a file being written; core/remote_sync.py skips these names
TMP_PREFIX = ".tmp_"
_CKPT_RE = re.compile(rf"{CKPT_PREFIX}(\d+)\.pt$")

# the asynchronous save in flight, and the error its writer raised
_writer: Optional[threading.Thread] = None
_writer_error: Optional[BaseException] = None


def save(directory: str, state: Dict[str, Any], step: int,
         keep: Optional[int] = None, blocking: bool = True) -> str:
    """Write ``state`` to ``directory/epoch_<step>.pt`` atomically; with
    ``keep`` prune all but the newest ``keep``. Returns the path.

    Tensors on the card are written as host tensors. Waits first for the
    previous asynchronous save. ``blocking=False`` returns once every
    tensor of ``state`` is copied to the host (a copy even of host
    tensors, so an in-place update after the return does not reach the
    file) and writes on a thread; read the path only after
    :func:`wait_for_saves`."""
    global _writer
    wait_for_saves()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{CKPT_PREFIX}{step}.pt")
    if blocking:
        _write(directory, path, _to_host(state, copy=False), keep)
        return path
    snapshot = _to_host(state, copy=True)

    def run():
        global _writer_error
        try:
            _write(directory, path, snapshot, keep)
        except BaseException as exc:  # raised by the next save or wait
            _writer_error = exc

    _writer = threading.Thread(target=run, name="checkpoint-writer")
    _writer.start()
    return path


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s whole state dict on the host: an FSDP-sharded model's
    gathered (``get_model_state_dict(full_state_dict=True,
    cpu_offload=True)``: a collective, which every rank calls; rank 0
    gets the tensors, the others an empty dict), else ``state_dict()``."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(p, DTensor) for p in model.parameters()):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_model_state_dict)

        return get_model_state_dict(model, options=StateDictOptions(
            full_state_dict=True, cpu_offload=True))
    return model.state_dict()


def wait_for_saves() -> None:
    """Block until the asynchronous save in flight has committed; raise
    the error its writer met, if any."""
    global _writer, _writer_error
    if _writer is not None:
        _writer.join()
        _writer = None
    if _writer_error is not None:
        exc, _writer_error = _writer_error, None
        raise exc


def _to_host(obj: Any, copy: bool) -> Any:
    """``obj`` with every tensor detached on the host: copied there, and
    copied also where it is there already if ``copy``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=copy)
    if isinstance(obj, dict):
        return {k: _to_host(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, copy) for v in obj)
    return obj


def _write(directory: str, path: str, state: Dict[str, Any],
           keep: Optional[int]) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=TMP_PREFIX, suffix=".pt")
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(state, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if keep:
        _prune(directory, keep)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest checkpoint by step number, or None."""
    if not os.path.isdir(directory):
        return None
    best_step, best_path = -1, None
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best_path = os.path.join(directory, name)
    return best_path


def load(path: str) -> Dict[str, Any]:
    """A checkpoint written by :func:`save` (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def resume(directory: str) -> Optional[Dict[str, Any]]:
    """'latest' resume: the newest checkpoint in ``directory``, or None."""
    path = latest_checkpoint(directory)
    return None if path is None else load(path)


def step_of(path: str) -> int:
    m = re.search(rf"{CKPT_PREFIX}(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def _prune(directory: str, keep: int) -> None:
    entries = sorted((int(m.group(1)), name) for name in os.listdir(directory)
                     for m in [_CKPT_RE.match(name)] if m)
    for _, name in entries[:-keep]:
        os.remove(os.path.join(directory, name))
