"""The one generator of the benchmark's inputs, driven by a traffic file's
parameters: preprocessed image batches, caption batches, hard-negative
batches. Everything comes from the seed; the sizes do not: every seed
draws the same batch shapes and the same multiset of caption lengths, in
another order, so that it changes the values and never the work.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .seeds import numpy_rng, torch_generator


@torch.no_grad()
def image_batches(config: Dict, n_batches: int, batch: int, seed: int,
                  purpose: str, device: torch.device) -> List[torch.Tensor]:
    """``n_batches`` float32 [batch, S, S, 3] batches on ``device``, as
    ``image/preprocess.py`` emits them: 8-bit pixels / 255, normalised by
    the configuration's mean and std. Drawn on ``device`` in one call."""
    v = config["vision"]
    s = v["image_size"]
    g = torch_generator(seed, purpose, device)
    px = torch.randint(0, 256, (n_batches, batch, s, s, 3), generator=g,
                       device=device, dtype=torch.uint8)
    mean = torch.tensor(v["mean"], device=device)
    std = torch.tensor(v["std"], device=device)
    x = (px.float() / 255.0 - mean) / std
    return list(x.unbind(0))


def caption_lengths(batch: int, lo: int, hi: int) -> np.ndarray:
    """The fixed multiset of ``batch`` token counts (SOT and EOT included)
    spread evenly over [lo, hi]."""
    return np.round(np.linspace(lo, hi, batch)).astype(np.int64)


def token_batches(config: Dict, n_batches: int, batch: int, lo: int, hi: int,
                  seed: int, purpose: str) -> List[np.ndarray]:
    """``n_batches`` int64 [batch, ctx] host batches of tokenised captions:
    SOT, random ids below SOT, EOT (the highest id), zeros after; each
    batch the lengths of :func:`caption_lengths` in a seeded order."""
    t = config["text"]
    ctx, sot, eot = t["context_length"], t["sot_id"], t["eot_id"]
    rng = numpy_rng(seed, purpose)
    lengths = caption_lengths(batch, lo, hi)
    out = []
    for _ in range(n_batches):
        ids = rng.integers(1, sot, size=(batch, ctx), dtype=np.int64)
        n = rng.permutation(lengths)
        col = np.arange(ctx)[None, :]
        ids = np.where(col < n[:, None] - 1, ids, 0)
        ids[:, 0] = sot
        ids[np.arange(batch), n - 1] = eot
        out.append(ids)
    return out


def train_batches(config: Dict, traffic: Dict, seed: int,
                  device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """The pool of training batches on ``device``: 'images', 'texts' and,
    with hard negatives, 'hard_texts' and 'hard_valid', every row distinct
    (the pool's batches hold different draws)."""
    n, b = traffic["pool_batches"], traffic["batch"]
    h = traffic.get("hard_texts", 0)
    lo, hi = traffic["len_min"], traffic["len_max"]
    images = image_batches(config, n, b, seed, "train_images", device)
    texts = token_batches(config, n, b, lo, hi, seed, "train_texts")
    hard = (token_batches(config, n, h, lo, hi, seed, "hard_texts") if h
            else None)
    pool = []
    for i in range(n):
        batch = {"images": images[i],
                 "texts": torch.from_numpy(texts[i]).to(device)}
        if hard is not None:
            batch["hard_texts"] = torch.from_numpy(hard[i]).to(device)
            batch["hard_valid"] = torch.ones(h, dtype=torch.bool,
                                             device=device)
        pool.append(batch)
    return pool
