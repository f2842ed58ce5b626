"""MMEB embedding-retrieval evaluation protocol (a copy of
``clip_embeds_tpu/evals/mmeb.py``, which imports no framework).

Reference: VLM2Vec/eval.py:30-180 — per subset, encode the deduplicated query
and target sides, cache the embeddings, then for each row score the query
against its candidate targets; prediction 0 (the first candidate) is the gold
answer; report accuracy. Dedup follows EvalDataset.get_paired_data
(src/dataset.py:197-215): unique (text, img_path) pairs keep one embedding.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Pair = Tuple[str, str]  # (text, img_path); img_path == "" for text-only


def dedup_pairs(pairs: Sequence[Pair]) -> List[Pair]:
    seen = {}
    for p in pairs:
        seen.setdefault(p, None)
    return list(seen)


def evaluate_subset(
    rows: Sequence[dict],
    encode_queries: Callable[[Sequence[Pair]], np.ndarray],
    encode_targets: Callable[[Sequence[Pair]], np.ndarray],
    normalize: bool = True,
    cache_dir: Optional[str] = None,
    subset: str = "subset",
) -> Dict[str, float]:
    """rows: {'qry_text', 'qry_img_path', 'tgt_text': [..], 'tgt_img_path': [..]}
    with the gold target first (reference convention: pred == 0 is correct)."""
    qry_pairs = dedup_pairs(
        [(r["qry_text"], r["qry_img_path"]) for r in rows]
    )
    tgt_pairs = dedup_pairs([
        pair
        for r in rows
        for pair in zip(r["tgt_text"], r["tgt_img_path"])
    ])

    qry_reps = _cached_encode(
        encode_queries, qry_pairs, cache_dir, f"{subset}_qry"
    )
    tgt_reps = _cached_encode(
        encode_targets, tgt_pairs, cache_dir, f"{subset}_tgt"
    )
    qry_dict = dict(zip(qry_pairs, qry_reps))
    tgt_dict = dict(zip(tgt_pairs, tgt_reps))

    n_correct = 0
    predictions: List[Pair] = []
    for r in rows:
        q = qry_dict[(r["qry_text"], r["qry_img_path"])]
        candidates = list(zip(r["tgt_text"], r["tgt_img_path"]))
        t = np.stack([tgt_dict[c] for c in candidates])
        if normalize:
            q = q / np.linalg.norm(q)
            t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        pred = int(np.argmax(t @ q))
        if pred == 0:
            n_correct += 1
        predictions.append(candidates[pred])

    result = {
        "acc": n_correct / len(rows),
        "num_correct": n_correct,
        "num_pred": len(rows),
    }
    if cache_dir:
        with open(os.path.join(cache_dir, f"{subset}_score.json"), "w") as f:
            json.dump(result, f, indent=4)
        with open(os.path.join(cache_dir, f"{subset}_pred.txt"), "w") as f:
            for item in predictions:
                f.write(f"{item}\n")
    return result


def _cached_encode(encode, pairs, cache_dir, name) -> np.ndarray:
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                reps, cached_pairs = pickle.load(f)
            if list(cached_pairs) == list(pairs):
                return reps
    reps = encode(pairs)
    if cache_dir:
        with open(os.path.join(cache_dir, name), "wb") as f:
            pickle.dump((reps, list(pairs)), f)
    return reps


def _encode_split(
    pairs: Sequence[Pair], encode_with_image, encode_text_only
) -> np.ndarray:
    """Route image-bearing pairs through the image encoder and text-only
    pairs through the text encoder, preserving order. Each side of an MMEB
    subset may mix both (e.g. VQA queries with images vs. text answers)."""
    img_idx = [i for i, (_, im) in enumerate(pairs) if im]
    txt_idx = [i for i, (_, im) in enumerate(pairs) if not im]
    reps: list = [None] * len(pairs)
    if img_idx:
        out = encode_with_image(
            [pairs[i][1] for i in img_idx], [pairs[i][0] for i in img_idx]
        )
        for j, i in enumerate(img_idx):
            reps[i] = out[j]
    if txt_idx:
        out = encode_text_only([pairs[i][0] for i in txt_idx])
        for j, i in enumerate(txt_idx):
            reps[i] = out[j]
    return np.stack(reps)


def make_embedding_encoders(scorer):
    """Adapt scores.embedding_scorer.EmbeddingScorer to (qry, tgt) encoders.

    Queries with images go through the instruction template
    (embed_queries); image-bearing *targets* (t2i retrieval subsets) are
    encoded with their images via embed_image_texts — never silently
    embedded as text only (VLM2Vec/eval.py encodes both sides with images
    when present)."""

    def encode_queries(pairs: Sequence[Pair]) -> np.ndarray:
        return _encode_split(
            pairs, scorer.embed_queries, scorer.embed_texts
        )

    def encode_targets(pairs: Sequence[Pair]) -> np.ndarray:
        return _encode_split(
            pairs, scorer.embed_image_texts, scorer.embed_texts
        )

    return encode_queries, encode_targets
