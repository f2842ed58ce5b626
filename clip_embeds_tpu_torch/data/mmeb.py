"""VLM2Vec-style (query, target) pair data for embedding training (a copy
of ``clip_embeds_tpu/data/mmeb.py`` over the port's ``preprocess_llava``
and ``tokenizer_image_token``; it yields numpy batches).

Reference: VLM2Vec/src/dataset.py:75-146 CombinedDataset — LLaVA 558K
pretraining pairs (first turn) + 665K instruct pairs (random turn), query =
instruction(+image), target = answer text; template
"<|image_1|> Represent the given image with the following question: {}"
(:90-91). Collation follows src/collator.py:12-85: pad input ids, stack pixel
values, track which rows carry an image (image_mask) — here queries and
targets are kept as separate static-shape sub-batches (queries all have
images, targets are text-only), the static-shape equivalent.
"""

from __future__ import annotations

import json
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..image.preprocess import preprocess_llava
from ..models.llava import IMAGE_TOKEN_INDEX
from ..scores.vqa_score import tokenizer_image_token

IMAGE_TOKEN = "<image>"
QUERY_TEMPLATE = "<|image_1|> Represent the given image with the following question: {}"
TEXT_QUERY_TEMPLATE = "Find the text that can answer the given query: {}"

TokenizeFn = Callable[[str], List[int]]


class CombinedPairDataset:
    """(query_text, query_image_path | None, target_text) triples."""

    def __init__(
        self,
        pretrain_annotations: str,
        instruct_annotations: Optional[str],
        pretrain_image_root: str,
        instruct_image_root: Optional[str] = None,
        seed: int = 0,
    ):
        with open(pretrain_annotations) as fh:
            self.samples = json.load(fh)
        self.num_pretrain = len(self.samples)
        if instruct_annotations:
            with open(instruct_annotations) as fh:
                self.samples.extend(json.load(fh))
        self.pretrain_image_root = pretrain_image_root
        self.instruct_image_root = instruct_image_root or pretrain_image_root
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, idx: int):
        sample = self.samples[idx]
        if idx < self.num_pretrain:
            root = self.pretrain_image_root
            qry_text = sample["conversations"][0]["value"]
            pos_text = sample["conversations"][1]["value"]
        else:
            root = self.instruct_image_root
            i = self.rng.randint(0, len(sample["conversations"]) // 2 - 1)
            qry_text = sample["conversations"][i * 2]["value"]
            pos_text = sample["conversations"][i * 2 + 1]["value"]
        has_image = "image" in sample
        image_path = os.path.join(root, sample["image"]) if has_image else None
        if IMAGE_TOKEN not in qry_text:
            tpl = QUERY_TEMPLATE if has_image else TEXT_QUERY_TEMPLATE
            qry_text = tpl.format(qry_text)
        # normalize the VLM2Vec-style "<|image_1|>" marker to <image>
        qry_text = qry_text.replace("<|image_1|>", IMAGE_TOKEN)
        return qry_text, image_path, pos_text


def _encode_with_image(
    text: str, tokenize: TokenizeFn, bos_token_id: Optional[int]
) -> List[int]:
    return tokenizer_image_token(text, tokenize, bos_token_id)


PHI_IMAGE_TOKEN = "<|image_1|>"
QWEN_IMAGE_TOKEN = "<|image_pad|>"


class MMEBTrainDataset:
    """MMEB 20-subset training data (VLM2Vec/src/dataset.py:15-73
    TrainDataset): subsets concatenate with a per-subset sample cap; items are
    (qry_text, qry_image, pos_text, pos_image) with the '<|image_1|>' marker
    rewritten per backbone and backbone-specific image resolutions
    (llava_next 'high' 1344, llava_1.5/qwen 'low' 336).

    ``subsets`` maps subset name -> sequence of dicts with keys qry /
    qry_image_path / pos_text / pos_image_path (an HF dataset split works
    verbatim; with zero egress, pass local json/parquet loads).
    """

    def __init__(
        self,
        subsets: Dict[str, Sequence[Dict]],
        image_dir: str = "",
        num_sample_per_subset: Optional[int] = None,
        model_backbone: str = "llava_1.5",
    ):
        self.rows: List[Dict] = []
        for name in subsets:
            data = subsets[name]
            n = len(data)
            if num_sample_per_subset is not None:
                n = min(n, num_sample_per_subset)
            for i in range(n):
                self.rows.append(data[i])
        self.image_dir = image_dir
        self.backbone = model_backbone

    def __len__(self) -> int:
        return len(self.rows)

    def _rewrite(self, text: str) -> str:
        if self.backbone in ("llava_next", "llava-1.5", "llava_1.5",
                             "llava-hf/llava-1.5-7b-hf"):
            return text.replace(PHI_IMAGE_TOKEN, IMAGE_TOKEN)
        if self.backbone == "qwen":
            return text.replace(PHI_IMAGE_TOKEN, QWEN_IMAGE_TOKEN)
        return text

    def _resolution(self) -> Optional[int]:
        if self.backbone == "llava_next":
            return 1344
        if self.backbone in ("qwen", "llava_1.5", "llava-1.5"):
            return 336
        return None

    def get(self, idx: int):
        """-> (qry_text, qry_image_path|None, pos_text, pos_image_path|None)."""
        row = self.rows[idx]
        qry_img = row.get("qry_image_path") or None
        pos_img = row.get("pos_image_path") or None
        join = lambda p: os.path.join(self.image_dir, p) if p else None
        return (
            self._rewrite(row["qry"]), join(qry_img),
            self._rewrite(row["pos_text"]), join(pos_img),
        )


def _place_sentinel(
    ids: List[int], has_image: bool, max_len: int
) -> List[int]:
    """Every row needs exactly one sentinel for the static splice; imageless
    rows carry it appended after their text (masked out downstream)."""
    ids = ids[: max_len - 1]
    if has_image != (IMAGE_TOKEN_INDEX in ids):
        raise ValueError("an image row must contain one <image>, a text "
                         "row none")
    return ids if has_image else ids + [IMAGE_TOKEN_INDEX]


def mixed_pair_batches(
    dataset: MMEBTrainDataset,
    tokenize: TokenizeFn,
    batch_size: int,
    bos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    max_len: int = 1024,
    image_size: int = 336,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 8,
) -> Iterator[Dict[str, np.ndarray]]:
    """MMEB batches where any row (query or target) may or may not carry an
    image — the static-shape replacement for the reference's image_mask
    collator (src/collator.py:12-85). Yields per side: ids [B, L],
    mask [B, L], pixels [B, S, S, 3] (zeros when absent), image_valid [B]."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)

    def encode_side(text: str, image_path: Optional[str]):
        has_image = image_path is not None
        if has_image and IMAGE_TOKEN not in text:
            text = IMAGE_TOKEN + "\n" + text
        ids = _encode_with_image(text, tokenize, bos_token_id)
        ids = _place_sentinel(ids, has_image, max_len)
        pixels = (
            preprocess_llava(image_path, image_size)
            if has_image
            else np.zeros((image_size, image_size, 3), np.float32)
        )
        return ids, has_image, pixels

    def prepare(idx: int):
        qry_text, qry_img, pos_text, pos_img = dataset.get(int(idx))
        return encode_side(qry_text, qry_img), encode_side(pos_text, pos_img)

    def pack_side(rows):
        longest = max(len(r[0]) for r in rows)
        longest = ((longest + 63) // 64) * 64
        ids = np.full((len(rows), longest), pad_token_id, np.int32)
        mask = np.zeros((len(rows), longest), bool)
        for i, (row, has_image, _) in enumerate(rows):
            ids[i, : len(row)] = row
            n_real = len(row) - (0 if has_image else 1)
            mask[i, :n_real] = True
            if not has_image:
                # keep the appended sentinel out of the REAL-token mask but
                # present in ids for the static splice
                mask[i, len(row) - 1] = False
        return {
            "ids": ids,
            "mask": mask,
            "pixels": np.stack([r[2] for r in rows]),
            "image_valid": np.asarray([r[1] for r in rows], bool),
        }

    with ThreadPoolExecutor(num_workers) as pool:
        pending: List = []
        for qry, tgt in pool.map(prepare, order):
            pending.append((qry, tgt))
            if len(pending) == batch_size:
                q = pack_side([p[0] for p in pending])
                t = pack_side([p[1] for p in pending])
                yield {
                    "qry_ids": q["ids"], "qry_mask": q["mask"],
                    "qry_pixels": q["pixels"],
                    "qry_image_valid": q["image_valid"],
                    "tgt_ids": t["ids"], "tgt_mask": t["mask"],
                    "tgt_pixels": t["pixels"],
                    "tgt_image_valid": t["image_valid"],
                }
                pending = []


def pair_batches(
    dataset: CombinedPairDataset,
    tokenize: TokenizeFn,
    batch_size: int,
    bos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    max_len: int = 1024,
    image_size: int = 336,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 8,
    image_only: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches:
    qry_ids [B, L], qry_mask [B, L], qry_pixels [B, S, S, 3],
    tgt_ids [B, L], tgt_mask [B, L].

    ``image_only`` keeps only samples with a query image so every batch is
    shape-homogeneous (mixed batches need the reference's image_mask split —
    kept out of the static path here).
    """
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)

    def prepare(idx: int):
        qry_text, image_path, pos_text = dataset.get(int(idx))
        if image_only and image_path is None:
            return None
        qry_ids = _encode_with_image(qry_text, tokenize, bos_token_id)
        tgt_ids = tokenize(pos_text)
        pixels = preprocess_llava(image_path, image_size) if image_path else None
        return qry_ids[:max_len], tgt_ids[:max_len], pixels

    def pad_rows(rows: List[List[int]]):
        longest = max(len(r) for r in rows)
        longest = ((longest + 63) // 64) * 64
        ids = np.full((len(rows), longest), pad_token_id, np.int32)
        mask = np.zeros((len(rows), longest), bool)
        for i, row in enumerate(rows):
            ids[i, : len(row)] = row
            mask[i, : len(row)] = True
        return ids, mask

    with ThreadPoolExecutor(num_workers) as pool:
        pending: List = []
        for item in pool.map(prepare, order):
            if item is None:
                continue
            pending.append(item)
            if len(pending) == batch_size:
                qry_rows = [p[0] for p in pending]
                tgt_rows = [p[1] for p in pending]
                qry_ids, qry_mask = pad_rows(qry_rows)
                tgt_ids, tgt_mask = pad_rows(tgt_rows)
                yield {
                    "qry_ids": qry_ids,
                    "qry_mask": qry_mask,
                    "qry_pixels": np.stack([p[2] for p in pending]),
                    "tgt_ids": tgt_ids,
                    "tgt_mask": tgt_mask,
                }
                pending = []
