"""CSV/TSV image-caption dataset: the port's own copy of
``clip_embeds_tpu/data/csv_dataset.py`` (the reference's ``CsvDataset``).

stdlib csv parsing, a deterministic per-epoch shuffle, and batch decode
through ``image/preprocess.py preprocess_batch`` (the native C++ pipeline
where it is built, PIL per slot where not), or per sample through a train
transform on a thread pool.
"""

from __future__ import annotations

import csv
import logging
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..image.preprocess import preprocess_batch
from ..image.transform import sample_rng


class CsvPairDataset:
    """(image path, caption) pairs from a delimited file.

    Mirrors the reference's ``img_key``/``caption_key``/``sep`` contract
    (open_clip_train/params.py --csv-img-key/--csv-caption-key/--csv-separator
    defaults: filepath/title/tab).
    """

    def __init__(
        self,
        input_filename: str,
        img_key: str = "filepath",
        caption_key: str = "title",
        sep: str = "\t",
    ) -> None:
        self.images: List[str] = []
        self.captions: List[str] = []
        with open(input_filename, newline="") as fh:
            reader = csv.DictReader(fh, delimiter=sep)
            if reader.fieldnames is None or img_key not in reader.fieldnames \
                    or caption_key not in reader.fieldnames:
                raise ValueError(
                    f"csv {input_filename!r} lacks columns "
                    f"{img_key!r}/{caption_key!r}; has {reader.fieldnames}"
                )
            for row in reader:
                self.images.append(str(row[img_key]))
                self.captions.append(str(row[caption_key]))
        logging.info("csv dataset: %d pairs from %s",
                     len(self.images), input_filename)

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, idx: int) -> Tuple[str, str]:
        return self.images[idx], self.captions[idx]


def csv_batches(
    dataset: CsvPairDataset,
    batch_size: int,
    image_size: int,
    tokenizer,
    preprocess_variant: str = "clip",
    epoch: int = 0,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    train_transform=None,
    num_workers: int = 8,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic epoch-shuffled fixed-size numpy batches.

    Images decode+preprocess per batch on the C++ fast path (PIL fallback
    per slot); an image file that fails to decode raises, matching the
    reference DataLoader's behavior for csv data (no log_and_continue there).

    ``train_transform`` (image.transform ``(image, rng) -> [S,S,3]``)
    switches the image path to the randomized train pipeline
    (RandomResizedCrop + aug_cfg, reference transform.py:276-345) with
    per-(seed, epoch, sample) Philox streams, threaded.
    """
    order = list(range(len(dataset)))
    if shuffle:
        random.Random((seed, epoch).__hash__()).shuffle(order)
    pool = None
    if train_transform is not None:
        pool = ThreadPoolExecutor(num_workers)

        def fetch(i: int) -> np.ndarray:
            return train_transform(dataset.images[i],
                                   sample_rng(seed, epoch, i))

    try:
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size and drop_last:
                return
            caps = [dataset.captions[i] for i in idx]
            if pool is not None:
                images = np.stack(list(pool.map(fetch, idx)))
            else:
                paths = [dataset.images[i] for i in idx]
                images = preprocess_batch(paths, image_size,
                                          preprocess_variant)
            yield {"images": images, "texts": tokenizer(caps)}
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
