"""What'sUp / COCO-VG spatial-reasoning eval drivers: the port's own copy of
``clip_embeds_tpu/evals/whatsup.py`` (numpy and the standard library only).

Faithful reimplementation of the reference drivers
(Patch-Aligned-Contrastive-Learning/eval_clip.py:31-246): dataset parsing,
option filtering (gold preposition + its opposite), the ground-truth-first
convention, and the individual / pair / set accuracy aggregation
(eval_clip.py:71-110). The scoring itself is delegated to a scorer object so
CLIP (softmax row compare), PACL (diagonal compare) and embedding models share
one driver — and images/texts are scored in device-sized batches instead of
the reference's per-sample PIL+forward loop (the SURVEY.md §7 throughput fix).

Results are returned as a dict and optionally appended to
evaluation_results.txt in the reference's exact format.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

PREPOSITIONS = ["on", "under", "front", "behind", "left", "right"]
OPPOSITE = {
    "on": "under", "under": "on", "front": "behind",
    "behind": "front", "left": "right", "right": "left",
}

COCO_VG_PREPOSITIONS = [
    "top", "bottom", "above", "below", "left", "right", "front", "behind",
]

# scorer signature: (image_path, option_texts) batched via score_batch
ScoreBatchFn = Callable[[Sequence[Tuple[str, List[str]]]], List[np.ndarray]]


def _object_pair(image_path: str) -> Tuple[str, str]:
    name = image_path.split("/")[-1]
    return name.split("_")[0], name.split("_")[-1][:-5]


def _preposition_key(image_path: str) -> str:
    return image_path.split("/")[-1].split("_")[1]


def eval_whatsup(
    score_batch: ScoreBatchFn,
    dataset: List[dict],
    root_dir: str,
    four_option: bool = False,
    results_file: Optional[str] = None,
) -> Dict[str, float]:
    """What'sUp A/B driver (2-option eval_clip.py:31-110, 4-option :112-189).

    dataset entries: {'image_path': 'data/.../obj1_prep_..._obj2.jpeg',
    'caption_options': [gt, ...]}. GT is always option 0.
    """
    samples = []
    for d in dataset:
        image_name = os.path.join(root_dir, d["image_path"][5:])
        if four_option:
            options = list(d["caption_options"])
        else:
            gold = list(
                set(PREPOSITIONS) & set(d["caption_options"][0].split())
            )
            oppo = OPPOSITE[gold[0]]
            options = [
                s for s in d["caption_options"]
                if gold[0] in s.split() or oppo in s.split()
            ]
        samples.append((image_name, options))

    scores = score_batch(samples)

    eval_dict: Dict[Tuple[str, str], Dict[str, int]] = {
        _object_pair(d["image_path"]): {
            "left": 0, "right": 0, "on": 0, "under": 0,
            "in-front": 0, "behind": 0,
        }
        for d in dataset
    }
    for d, s in zip(dataset, scores):
        if four_option:
            # strict greater-than vs every distractor (eval_clip.py:144)
            correct = int(s[0] > s[1] and s[0] > s[2] and s[0] > s[3])
        else:
            correct = int(s[0] > s[1])
        eval_dict[_object_pair(d["image_path"])][
            _preposition_key(d["image_path"])
        ] = correct

    lr_pair = ou_pair = fb_pair = 0
    lr_ind = ou_ind = fb_ind = 0
    set_correct = 0
    for correct_dict in eval_dict.values():
        if correct_dict["left"] and correct_dict["right"]:
            lr_pair += 1
        lr_ind += correct_dict["left"] + correct_dict["right"]
        if correct_dict["under"] and correct_dict["on"]:
            ou_pair += 1
        ou_ind += correct_dict["under"] + correct_dict["on"]
        if correct_dict["behind"] and correct_dict["in-front"]:
            fb_pair += 1
        fb_ind += correct_dict["behind"] + correct_dict["in-front"]
        if sum(correct_dict.values()) == 4:
            set_correct += 1

    total = len(dataset)
    results = {
        "individual_accuracy": (lr_ind + ou_ind + fb_ind) * 100 / total,
        "left_right_individual_accuracy": lr_ind * 100 / (total / 2),
        "on_under_individual_accuracy": ou_ind * 100 / (total / 2),
        "front_back_individual_accuracy": fb_ind * 100 / (total / 2),
        "left_right_pair_accuracy": lr_pair * 100 / (total / 4),
        "on_under_pair_accuracy": ou_pair * 100 / (total / 4),
        "front_back_pair_accuracy": fb_pair * 100 / (total / 4),
        "pair_accuracy": (lr_pair + ou_pair + fb_pair) * 100 / (total / 2),
        "set_accuracy": set_correct * 100 / (total / 4),
    }
    if results_file:
        _append_whatsup_results(results_file, results)
    return results


def _append_whatsup_results(path: str, r: Dict[str, float]) -> None:
    with open(path, "a") as f:
        f.write("Individual accuracy: {}\n".format(r["individual_accuracy"]))
        f.write("Left Right Individual accuracy: {}\n".format(
            r["left_right_individual_accuracy"]))
        f.write("On Under Individual accuracy: {}\n".format(
            r["on_under_individual_accuracy"]))
        f.write("Front Back Individual accuracy: {}\n".format(
            r["front_back_individual_accuracy"]))
        f.write("Left Right Pair accuracy: {}\n".format(
            r["left_right_pair_accuracy"]))
        f.write("On Under Pair accuracy: {}\n".format(
            r["on_under_pair_accuracy"]))
        f.write("Front Back Pair accuracy: {}\n".format(
            r["front_back_pair_accuracy"]))
        f.write("Pair accuracy: {}\n".format(r["pair_accuracy"]))
        f.write("Set accuracy: {}\n".format(r["set_accuracy"]))


def eval_coco_vg(
    score_batch: ScoreBatchFn,
    dataset: List[list],
    root_dir: str,
    source: str,  # 'coco' or 'vg'
    results_file: Optional[str] = None,
) -> Dict[str, float]:
    """COCO/VG one/two-object driver (eval_clip.py:192-246).

    dataset rows: [image_id, gt_caption, distractor_caption].
    """
    samples = []
    preps = []
    for d in dataset:
        if source == "coco":
            image = os.path.join(
                root_dir, "val2017/{}.jpg".format(str(d[0]).zfill(12))
            )
        else:
            image = os.path.join(root_dir, "vg_images/{}.jpg".format(d[0]))
        gold = list(set(COCO_VG_PREPOSITIONS) & set(d[1].split()))
        preps.append(gold[0])
        samples.append((image, [d[1], d[2]]))

    scores = score_batch(samples)

    eval_dict = {p: 0 for p in COCO_VG_PREPOSITIONS}
    total_dict = {p: 0 for p in COCO_VG_PREPOSITIONS}
    for prep, s in zip(preps, scores):
        eval_dict[prep] += int(s[0] > s[1])
        total_dict[prep] += 1

    total = sum(total_dict.values())
    results = {
        "individual_accuracy": sum(eval_dict.values()) * 100 / total,
    }
    for a, b, key in [
        ("left", "right", "left_right"),
        ("top", "bottom", "top_bottom"),
        ("above", "below", "above_below"),
        ("front", "behind", "front_behind"),
    ]:
        denom = total_dict[a] + total_dict[b]
        if denom > 0:
            results[f"{key}_individual_accuracy"] = (
                (eval_dict[a] + eval_dict[b]) * 100 / denom
            )
    if results_file:
        with open(results_file, "a") as f:
            f.write("Individual accuracy: {}\n".format(
                results["individual_accuracy"]))
    return results


def load_annotation(root_dir: str, dataset: str) -> Tuple[List, str]:
    """Resolve the annotation file for a dataset flag (eval_clip.py:367-390)."""
    files = {
        "a": "controlled_images_dataset.json",
        "a4": "controlled_images_dataset.json",
        "b": "controlled_clevr_dataset.json",
        "b4": "controlled_clevr_dataset.json",
        "cocoone": "coco_qa_one_obj.json",
        "cocotwo": "coco_qa_two_obj.json",
        "vgone": "vg_qa_one_obj.json",
        "vgtwo": "vg_qa_two_obj.json",
    }
    path = os.path.join(root_dir, files[dataset])
    with open(path) as fh:
        return json.load(fh), path
