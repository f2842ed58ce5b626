"""Zero-shot classification: the prompt-ensemble classifier and its top-k
eval (the port's own copy of ``clip_embeds_tpu/evals/zero_shot.py``, numpy
and the standard library only; ``zero_shot_metadata.json`` beside it is a
copy of that package's file).

open_clip's ``build_zero_shot_classifier`` (``zero_shot_classifier.py``):
per class, expand every template, encode, average the normalised
embeddings, renormalise; and ``zero_shot.py``'s top-1 / top-5 loop. Both
run on the host over ``encode_*`` callbacks, which return L2-normalised
float embeddings.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np

# A compact prompt ensemble; the experiment passes the 80 OpenAI templates
# for ImageNet (load_imagenet_metadata)
SIMPLE_TEMPLATES: Sequence[Callable[[str], str]] = (
    lambda c: f"a photo of a {c}.",
    lambda c: f"a bad photo of a {c}.",
    lambda c: f"a photo of many {c}.",
    lambda c: f"a photo of the large {c}.",
    lambda c: f"a photo of the small {c}.",
    lambda c: f"art of the {c}.",
    lambda c: f"a photo of a {c}, a type of object.",
)

Template = Union[str, Callable[[str], str]]


def _apply(template: Template, classname: str) -> str:
    if callable(template):
        return template(classname)
    return template.format(c=classname)


def build_zero_shot_classifier(
    encode_texts: Callable[[Sequence[str]], np.ndarray],
    classnames: Sequence[str],
    templates: Sequence[Template] = SIMPLE_TEMPLATES,
    num_classes_per_batch: Optional[int] = 10,
) -> np.ndarray:
    """[embed_dim, n_classes]: each column the mean of the class's
    normalised template embeddings, renormalised. ``encode_texts`` is
    called once per ``num_classes_per_batch`` classes (all at once for
    None) with every template of those classes, class-major."""
    num_templates = len(templates)
    columns = []
    batch = num_classes_per_batch or len(classnames)
    for start in range(0, len(classnames), batch):
        chunk = classnames[start:start + batch]
        prompts = [_apply(t, c) for c in chunk for t in templates]
        embeds = encode_texts(prompts)
        embeds = embeds.reshape(len(chunk), num_templates, -1).mean(axis=1)
        embeds = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
        columns.append(embeds)
    return np.concatenate(columns, axis=0).T


def zero_shot_eval(
    encode_images: Callable[[Sequence], np.ndarray],
    classifier: np.ndarray,
    samples: Iterable,
    targets: Sequence[int],
    batch_size: int = 64,
    logit_scale: float = 100.0,
) -> Dict[str, float]:
    """Top-1 / top-5 accuracy over (sample, class index) pairs; the samples
    go to ``encode_images`` ``batch_size`` at a time."""
    from .metrics import zero_shot_accuracy

    samples = list(samples)
    logits = []
    for start in range(0, len(samples), batch_size):
        feats = encode_images(samples[start:start + batch_size])
        logits.append(logit_scale * feats @ classifier)
    return zero_shot_accuracy(np.concatenate(logits), np.asarray(targets),
                              topk=(1, 5))


def load_imagenet_metadata() -> Dict[str, Sequence[str]]:
    """The shipped metadata: ``IMAGENET_CLASSNAMES`` (1000),
    ``OPENAI_IMAGENET_TEMPLATES`` (80) and ``SIMPLE_IMAGENET_TEMPLATES``
    (7); the templates are '{c}' format strings."""
    path = os.path.join(os.path.dirname(__file__), "zero_shot_metadata.json")
    with open(path) as fh:
        return json.load(fh)
