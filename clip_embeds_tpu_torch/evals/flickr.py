"""Flickr30k-style image-text retrieval (the port's own copy of
``clip_embeds_tpu/evals/flickr.py``, numpy and the standard library only).

VLM2Vec's ``eval_flickr.py``: encode the test images and their 5 captions
each, report recall@{1,5,10} both ways. A caption's ground truth is its
source image; for an image any of its captions counts.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Sequence

import numpy as np


def load_flickr_annotations(root_dir: str) -> List[dict]:
    """root/annotations.json: [{'image': 'x.jpg', 'captions': [5 strings]}]."""
    with open(os.path.join(root_dir, "annotations.json")) as fh:
        return json.load(fh)


def evaluate_retrieval(
    encode_images: Callable[[Sequence[str]], np.ndarray],
    encode_texts: Callable[[Sequence[str]], np.ndarray],
    annotations: List[dict],
    image_root: str = "",
    topk: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """Recall@k both ways and their mean; ``encode_*`` take every image
    path and every caption in one call."""
    image_paths = [os.path.join(image_root, a["image"]) for a in annotations]
    captions: List[str] = []
    caption_to_image: List[int] = []
    for i, a in enumerate(annotations):
        for c in a["captions"]:
            captions.append(c)
            caption_to_image.append(i)

    img = encode_images(image_paths)
    txt = encode_texts(captions)
    img = img / np.linalg.norm(img, axis=-1, keepdims=True)
    txt = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
    sims = txt @ img.T  # [n_captions, n_images]
    gt = np.asarray(caption_to_image)

    out: Dict[str, float] = {}
    # text -> image: the rank of each caption's image
    ranking = np.argsort(-sims, axis=1)
    pred_rank = np.where(ranking == gt[:, None])[1]
    for k in topk:
        out[f"text_to_image_R@{k}"] = float((pred_rank < k).mean())

    # image -> text: the best rank among the image's captions
    ranking_it = np.argsort(-sims.T, axis=1)
    n_images = len(annotations)
    best_rank = np.full(n_images, len(captions), np.int64)
    for i in range(n_images):
        own = np.where(gt == i)[0]
        best_rank[i] = np.where(np.isin(ranking_it[i], own))[0].min()
    for k in topk:
        out[f"image_to_text_R@{k}"] = float((best_rank < k).mean())
    out["mean_recall"] = float(np.mean(list(out.values())))
    return out
