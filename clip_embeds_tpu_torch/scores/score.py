"""Public Score API: m x n (images x texts) scoring + dataset batch_forward.
The port's ``Score`` and its factories, ``VQAScore`` (LLaVA),
``T5VQAScore`` (CLIP-FlanT5), ``InstructBlipVQAScore``, ``CLIPScore``,
``ImageRewardScore`` and ``ITMScore`` (BLIP-2) (counterpart of
``clip_embeds_tpu/scores/score.py``). Each model runs on ``device``
(default the card; without one the factory raises unless given
``device='cpu'``).

Reference: t2v_metrics/t2v_metrics/score.py:13-92 — ``Score(images, texts)``
returns an m x n matrix by pairing each image with every text;
``batch_forward`` runs a dataset of {'images': [k], 'texts': [l]} dicts to a
[N, k, l] tensor. Pair models (VQAScore) score (image, text) pairs; embedding
models (CLIPScore/ITMScore-style) factorize through embeddings.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import numpy as np

from ..image.preprocess import ImageLike

ImageTextDict = Dict[str, List]
PairForwardFn = Callable[[Sequence[ImageLike], Sequence[str]], np.ndarray]


class Score:
    """Wraps a pair-scoring function f(images, texts) -> [n] into the m x n API.

    ``image_texts_forward(image, texts, **kw) -> [n]``, when provided, takes
    the m x n broadcast instead of the pair loop — VQA scorers use it to
    encode each image (and the shared prompt prefix) ONCE and replay the
    cached KV across the n candidate texts, instead of the reference's
    full re-forward per (image, text) pair (score.py:43-57).
    """

    def __init__(self, pair_forward: PairForwardFn,
                 image_texts_forward=None, groups_forward=None,
                 group_size: int = 8):
        self.pair_forward = pair_forward
        self.image_texts_forward = image_texts_forward
        # groups_forward(images[k], texts[k][n], **kw) -> [k, n]: one
        # batched prefill + one block-causal concatenated-suffix pass per
        # k-group (two dispatches per k images instead of two per image)
        self.groups_forward = groups_forward
        # k per group: the prefix KV is the device memory that scales with k
        self.group_size = group_size

    def __call__(
        self,
        images: Union[ImageLike, Sequence[ImageLike]],
        texts: Union[str, Sequence[str]],
        **kwargs,
    ) -> np.ndarray:
        if isinstance(images, (str,)) or not isinstance(images, (list, tuple)):
            images = [images]
        if isinstance(texts, str):
            texts = [texts]
        scores = np.zeros((len(images), len(texts)), np.float32)
        if (self.groups_forward is not None and len(texts) > 1
                and len(images) > 1):
            # the m x n broadcast IS a k-group (every image scores the same
            # n texts): one batched prefill + one concatenated-suffix pass
            # per group_size images instead of two dispatches per image
            bs = self.group_size
            for start in range(0, len(images), bs):
                chunk = list(images[start : start + bs])
                scores[start : start + len(chunk)] = self.groups_forward(
                    chunk, [list(texts)] * len(chunk), **kwargs
                )
            return scores
        if self.image_texts_forward is not None and len(texts) > 1:
            for i, image in enumerate(images):
                scores[i] = self.image_texts_forward(image, list(texts),
                                                     **kwargs)
            return scores
        for i, image in enumerate(images):
            scores[i] = self.pair_forward([image] * len(texts), list(texts), **kwargs)
        return scores

    forward = __call__

    def batch_forward(
        self, dataset: List[ImageTextDict], batch_size: int = 16, **kwargs
    ) -> np.ndarray:
        """[N, n_images_per_sample, n_texts_per_sample] (score.py:59-92).

        With a grouped scorer, each (sample, image) row scores its sample's
        n texts against ONE image encode + prefix prefill (Winoground-style
        2x2 datasets re-encode nothing per text)."""
        n = len(dataset)
        n_images = len(dataset[0]["images"])
        n_texts = len(dataset[0]["texts"])
        out = np.zeros((n, n_images, n_texts), np.float32)
        if self.groups_forward is not None and n_texts > 1:
            bs = min(batch_size, self.group_size)
            for ii in range(n_images):
                for start in range(0, n, bs):
                    chunk = dataset[start : start + bs]
                    out[start : start + len(chunk), ii] = self.groups_forward(
                        [s["images"][ii] for s in chunk],
                        [list(s["texts"]) for s in chunk], **kwargs
                    )
            return out
        if self.image_texts_forward is not None and n_texts > 1:
            for si, sample in enumerate(dataset):
                for ii in range(n_images):
                    out[si, ii] = self.image_texts_forward(
                        sample["images"][ii], list(sample["texts"]), **kwargs
                    )
            return out
        for start in range(0, n, batch_size):
            chunk = dataset[start : start + batch_size]
            for ii in range(n_images):
                images = [s["images"][ii] for s in chunk]
                for ti in range(n_texts):
                    texts = [s["texts"][ti] for s in chunk]
                    out[start : start + len(chunk), ii, ti] = self.pair_forward(
                        images, texts, **kwargs
                    )
        return out


def VQAScore(model, tokenize, group_size: int = 8, **kw) -> Score:
    """VQAScore factory over the port's LLaVA (t2v_metrics.VQAScore): the
    pair path, the per-image prefix reuse and the k-group path of
    :class:`~.vqa_score.VQAScorer`."""
    from .vqa_score import VQAScorer

    scorer = VQAScorer(model, tokenize, **kw)
    return Score(scorer.forward, scorer.forward_image_texts,
                 scorer.forward_groups, group_size=group_size)


def CLIPScore(model, **kw) -> Score:
    """Cosine-similarity CLIPScore over the port's CLIP model
    (t2v clipscore_models/clip_model.py:44-58)."""
    from .scorers import CLIPScorer

    scorer = CLIPScorer(model, **kw)

    def pair_forward(images, texts):
        # encode_* return float32 numpy in any model dtype (_batched casts
        # once), as the host-side einsum needs
        img = scorer.encode_images(images)
        txt = scorer.encode_texts(texts)
        return np.einsum("nd,nd->n", img, txt)

    return Score(pair_forward)


def T5VQAScore(model, tokenize, group_size: int = 8, **kw) -> Score:
    """VQAScore over the port's CLIP-FlanT5, t2v_metrics' default
    VQAScore backbone (clip-flant5-xxl): the m x n broadcast encodes each
    image once (:class:`~.vqa_score.T5VQAScorer`)."""
    from .vqa_score import T5VQAScorer

    scorer = T5VQAScorer(model, tokenize, **kw)
    return Score(scorer.forward, scorer.forward_image_texts,
                 scorer.forward_groups, group_size=group_size)


def InstructBlipVQAScore(model, qformer_tokenize, t5_tokenize,
                         **kw) -> Score:
    """VQAScore over the port's InstructBLIP-FlanT5: the m x n broadcast
    caches the EVA-g tower per image (the Q-Former and T5 read the text,
    so they run per pair)."""
    from .vqa_score import InstructBlipVQAScorer

    scorer = InstructBlipVQAScorer(model, qformer_tokenize, t5_tokenize,
                                   **kw)
    return Score(scorer.forward, scorer.forward_image_texts)


def ImageRewardScore(model, tokenize, image_size: int = 224,
                     max_length: int = 35, batch_size: int = 8,
                     device="cuda") -> Score:
    """ImageReward ITMScore: the standardised BLIP reward-head score per
    (image, text) pair, texts cut and padded to 35 tokens as the
    reference's tokenizer does."""
    from .vqa_score import PairBatches

    return Score(PairBatches(model, model, tokenize, image_size,
                             max_length, batch_size, device,
                             "ImageRewardScore"))


def ITMScore(model, tokenize, image_size: int = 224, max_length: int = 35,
             batch_size: int = 8, device="cuda") -> Score:
    """BLIP-2 ITM matching probability, softmax(itm_logits)[:, 1] (the
    softmax in fp32)."""
    from .vqa_score import PairBatches

    def fn(pixels, ids, mask):
        logits = model.itm_logits(pixels, ids, mask).float()
        return logits.softmax(dim=-1)[:, 1]

    return Score(PairBatches(model, fn, tokenize, image_size, max_length,
                             batch_size, device, "ITMScore"))
