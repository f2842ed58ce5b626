"""Shared evaluation metrics: the port's own copy of
``clip_embeds_tpu/evals/metrics.py`` (numpy and the standard library only).

Faithful ports of:
* ``get_scores`` 4-way q/i/binary/group VQA scorer
  (Patch-Aligned-Contrastive-Learning/data/utils.py:89-187)
* Winoground text/image/group accuracy (t2v_metrics/dataset.py:192-230)
* retrieval recall@K + mean/median rank (open_clip_train/train.py:360-377)
* zero-shot top-k accuracy (open_clip_train/zero_shot.py:42-87)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

QuadResult = Union[Dict[str, float], Sequence[float]]


def _quad(result: QuadResult) -> tuple:
    """(q0_i0, q0_i1, q1_i0, q1_i1) from dict or list form."""
    if isinstance(result, dict):
        return result["q0_i0"], result["q0_i1"], result["q1_i0"], result["q1_i1"]
    return tuple(result[:4])


def get_scores(scores: Union[Dict, List[QuadResult]]) -> Dict[str, float]:
    """4-way VQA question/image/binary/group scoring (utils.py:89-187)."""
    results = scores.values() if isinstance(scores, dict) else scores
    results = list(results)
    n = len(results)
    question = image = binary = group = 0.0
    for r in results:
        q0i0, q0i1, q1i0, q1i1 = _quad(r)
        q_score = (q0i0 == 1.0 and q0i1 == 0.0) + (q1i1 == 1.0 and q1i0 == 0.0)
        i_score = (q0i0 == 1.0 and q1i0 == 0.0) + (q1i1 == 1.0 and q0i1 == 0.0)
        question += q_score
        image += i_score
        binary += (
            (q0i0 == 1.0) + (q0i1 == 0.0) + (q1i0 == 0.0) + (q1i1 == 1.0)
        )
        group += q_score == 2 and i_score == 2
    return {
        "question_score": question / (n * 2),
        "image_score": image / (n * 2),
        "binary_score": binary / (n * 4),
        "group_score": group / n,
    }


def winoground_scores(scores_i2t: np.ndarray) -> List[Dict[str, float]]:
    """[N, 2 images, 2 captions] score tensor -> per-sample result dicts
    (dataset.py:192-203 index convention: score_i2t[image][caption])."""
    out = []
    for i, s in enumerate(scores_i2t):
        out.append({
            "id": i,
            "c0_i0": s[0][0], "c0_i1": s[1][0],
            "c1_i0": s[0][1], "c1_i1": s[1][1],
        })
    return out


def winoground_accuracy(scores: List[Dict[str, float]]) -> Dict[str, float]:
    """Winoground text/image/group accuracy (dataset.py:205-230)."""
    def text_correct(r):
        return r["c0_i0"] > r["c1_i0"] and r["c1_i1"] > r["c0_i1"]

    def image_correct(r):
        return r["c0_i0"] > r["c0_i1"] and r["c1_i1"] > r["c1_i0"]

    n = len(scores)
    text = sum(text_correct(r) for r in scores)
    image = sum(image_correct(r) for r in scores)
    group = sum(text_correct(r) and image_correct(r) for r in scores)
    return {"text": text / n, "image": image / n, "group": group / n}


def retrieval_metrics(
    image_features: np.ndarray,
    text_features: np.ndarray,
    logit_scale: float = 100.0,
) -> Dict[str, float]:
    """image<->text recall@{1,5,10} + mean/median rank (train.py:348-377)."""
    logits_per_image = logit_scale * image_features @ text_features.T
    logits_per_text = logits_per_image.T
    n = logits_per_image.shape[0]
    gt = np.arange(n)
    out: Dict[str, float] = {}
    for name, logits in (
        ("image_to_text", logits_per_image),
        ("text_to_image", logits_per_text),
    ):
        ranking = np.argsort(-logits, axis=1)
        preds = np.where(ranking == gt[:, None])[1]
        out[f"{name}_mean_rank"] = float(preds.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float((preds < k).mean())
    return out


def zero_shot_accuracy(
    logits: np.ndarray, targets: np.ndarray, topk: Sequence[int] = (1, 5)
) -> Dict[str, float]:
    """top-k accuracy over a classifier logit matrix (zero_shot.py:42-56)."""
    ranking = np.argsort(-logits, axis=1)
    out = {}
    for k in topk:
        correct = (ranking[:, :k] == targets[:, None]).any(axis=1)
        out[f"top{k}"] = float(correct.mean())
    return out
