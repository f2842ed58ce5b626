"""MMVP / MMVP-VLM eval driver (text-to-image, paired statements): the port's
own copy of ``clip_embeds_tpu/evals/mmvp.py`` (numpy and the standard library
only).

Reference: Patch-Aligned-Contrastive-Learning/eval_clip.py:249-365. Rows of
Questions.csv come in pairs (two statements, two images); for each statement
the model softmaxes over the two images (t2i); ground truth derives from the
odd/even question id (qid % 2 == 1 -> img1). A pair counts only if both
predictions are right. MMVP-VLM buckets 9 categories x 15 pairs
(eval_clip.py:254-260, 339-341).
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

MMVP_VLM_CATEGORIES = [
    "Orientation and Direction", "Presence of Specific Features",
    "State and Condition", "Quantity and Count",
    "Positional and Relational Context", "Color and Appearance",
    "Structural Characteristics", "Texts",
    "Viewpoint and Perspective",
]

# (image_paths [2], texts [2]) -> t2i prob matrix [2 texts, 2 images]
PairScoreFn = Callable[[Sequence[str], Sequence[str]], np.ndarray]


def read_question_pairs(csv_file: str) -> List[Tuple[Tuple[int, str, str], Tuple[int, str, str]]]:
    pairs = []
    with open(csv_file) as f:
        reader = csv.reader(f)
        next(reader)
        rows = [row for row in reader if row]
    for i in range(0, len(rows) - 1, 2):
        qid1, qtype1, stmt1 = rows[i]
        qid2, qtype2, stmt2 = rows[i + 1]
        pairs.append(((int(qid1), qtype1, stmt1), (int(qid2), qtype2, stmt2)))
    return pairs


def eval_mmvp(
    pair_score: PairScoreFn,
    root_dir: str,
    dataset_name: str = "mmvpvlm",
    results_file: Optional[str] = None,
    prompt_prefix: str = "a photo of ",
) -> Dict[str, float]:
    if dataset_name == "mmvpvlm":
        image_dir = os.path.join(root_dir, "MLLM_VLM_Images")
        csv_file = os.path.join(root_dir, "Questions.csv")
        categories = MMVP_VLM_CATEGORIES
    else:
        image_dir = os.path.join(root_dir, "MMVP_Images")
        csv_file = os.path.join(root_dir, "Questions-clip.csv")
        categories = ["Unknown"]

    pairs = read_question_pairs(csv_file)

    pair_acc = {c: 0 for c in categories}
    single_acc = {c: 0 for c in categories}
    num_pairs = 0
    rows_out = []

    for (qid1, qtype1, stmt1), (qid2, _qtype2, stmt2) in pairs:
        if dataset_name == "mmvpvlm":
            img1 = os.path.join(image_dir, qtype1, f"{qid1}.jpg")
            img2 = os.path.join(image_dir, qtype1, f"{qid2}.jpg")
        else:
            img1 = os.path.join(image_dir, f"{qid1}.jpg")
            img2 = os.path.join(image_dir, f"{qid2}.jpg")

        texts = [prompt_prefix + stmt1, prompt_prefix + stmt2]
        probs = pair_score([img1, img2], texts)  # [2 texts, 2 images]

        img1_score1 = probs[0][0]
        img1_score2 = probs[1][0]
        pred1 = "img1" if img1_score1 > 0.5 else "img2"
        pred2 = "img1" if img1_score2 > 0.5 else "img2"
        gt1 = "img1" if qid1 % 2 == 1 else "img2"
        gt2 = "img1" if qid2 % 2 == 1 else "img2"
        rows_out.append(
            [qid1, qid2, pred1, pred2, gt1, gt2, img1_score1, img1_score2]
        )

        category = (
            categories[num_pairs // 15]
            if dataset_name == "mmvpvlm" else categories[0]
        )
        if pred1 == gt1 and pred2 == gt2:
            pair_acc[category] += 1
        if pred1 == gt1:
            single_acc[category] += 1
        if pred2 == gt2:
            single_acc[category] += 1
        num_pairs += 1

    results = {
        "pair_accuracy": 100 * sum(pair_acc.values()) / num_pairs,
        "individual_accuracy": 100 * sum(single_acc.values()) / num_pairs / 2,
    }
    per_cat_pairs = num_pairs // len(categories)
    for c in categories:
        results[f"pair_accuracy/{c}"] = pair_acc[c] / max(per_cat_pairs, 1) * 100
        results[f"single_accuracy/{c}"] = (
            single_acc[c] / max(num_pairs * 2 // len(categories), 1) * 100
        )

    if results_file:
        with open(results_file, "a") as f:
            f.write(
                f"Pair: {results['pair_accuracy']}, "
                f"Individual: {results['individual_accuracy']}\n"
            )
    return results
