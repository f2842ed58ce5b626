"""Synthetic training batches: the port's own copy of
``clip_embeds_tpu/data/synthetic.py`` (``synthetic_batches``,
``_random_texts``; open_clip's ``SyntheticDataset``). It stays numpy, so one
seed gives the JAX CLI's batches bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_batches(
    batch_size: int,
    image_size: int = 224,
    context_length: int = 77,
    num_batches: Optional[int] = None,
    vocab_size: int = 49408,
    seed: int = 0,
    hard_negatives: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield {'images', 'texts'[, 'hard_texts', 'hard_valid']} batches:
    images are random fields (not constant, so contrastive losses have
    signal), texts random ids framed by SOT / EOT."""
    rng = np.random.default_rng(seed)
    i = 0
    while num_batches is None or i < num_batches:
        images = rng.normal(0.0, 0.5, (batch_size, image_size, image_size, 3))
        texts = _random_texts(rng, batch_size, context_length, vocab_size)
        batch = {"images": images.astype(np.float32), "texts": texts}
        if hard_negatives:
            batch["hard_texts"] = _random_texts(
                rng, hard_negatives, context_length, vocab_size)
            batch["hard_valid"] = np.ones((hard_negatives,), bool)
        yield batch
        i += 1


def _random_texts(rng, n, context_length, vocab_size) -> np.ndarray:
    texts = np.zeros((n, context_length), np.int32)
    lengths = rng.integers(3, context_length, n)
    texts[:, 0] = vocab_size - 2  # SOT
    for row, length in enumerate(lengths):
        texts[row, 1:length - 1] = rng.integers(1, vocab_size - 2, length - 2)
        texts[row, length - 1] = vocab_size - 1  # EOT
    return texts
