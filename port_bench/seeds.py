"""Every random stream of a run, derived from ``--seed`` and a purpose."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose``, from any whole ``seed`` (negative or
    beyond 64 bits too)."""
    words = [int(w) for w in divmod(abs(int(seed)), 2 ** 32)]
    words += [int(seed < 0), zlib.crc32(purpose.encode())]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def torch_generator(seed: int, purpose: str,
                    device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def numpy_rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, purpose))
