"""Checkpoints with latest-election and atomic writes (counterpart of
``clip_embeds_tpu/core/checkpoint.py``; open_clip ``main.py``'s per-epoch
files, ``--resume latest`` and atomic replace).

A checkpoint is one ``torch.save`` file, ``<dir>/epoch_<step>.pt``, holding
``{"state_dict": <open_clip-layout state dict>, "step": <int>}``: the
parameters and the step, what the JAX CLI saves (no optimizer state). The
port's ``--pretrained`` loads the file as it is. A save writes a temporary
file in the same directory and ``os.replace``-s it into place, so a reader
sees the old file or the new one, never half of one.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import torch

CKPT_PREFIX = "epoch_"
_CKPT_RE = re.compile(rf"{CKPT_PREFIX}(\d+)\.pt$")


def save(directory: str, state: Dict[str, Any], step: int,
         keep: Optional[int] = None) -> str:
    """Write ``state`` to ``directory/epoch_<step>.pt`` atomically; with
    ``keep`` prune all but the newest ``keep``. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{CKPT_PREFIX}{step}.pt")
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_", suffix=".pt")
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
    return path


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
