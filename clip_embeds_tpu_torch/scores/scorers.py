"""Batched scorers bridging models to the eval drivers: the port's
``CLIPScorer`` (counterpart of ``clip_embeds_tpu/scores/scorers.py``
``_batched`` and ``CLIPScorer``; the PACL, SPARC and SigLIP scorers are not
ported yet).

The reference drivers run one PIL image + a couple of captions per forward
(eval_clip.py:50-65); here images and texts are accumulated and encoded in
device batches of one size (the tail padded, so every launch of a call has
one shape).
CLIP scoring: probs = softmax(100 * img @ txt.T) over options, row compare.

Routing: on the card in bf16, where ``fused_path_available`` holds, both
towers run ``fused_encode_image`` / ``fused_encode_text`` (the fused-block
kernels), as the JAX scorer does on the TPU. Elsewhere the composable
towers run: on the CPU, as JAX off the TPU; and in fp32 on the card, the
route ``cli/embed.py --fp32`` takes (the kernels are bf16; the JAX package's
TPU fused path runs in either dtype).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..image.preprocess import ImageLike, preprocess_batch
from ..models.serving import fused_encode_image, fused_encode_text, fused_route
from ..text.tokenizer import get_tokenizer


def _batched(encode_fn: Callable, items: np.ndarray,
             batch_size: int) -> np.ndarray:
    """Run an encoder over items in batches of one size, the tail padded;
    the outputs stay on the device until one float32 fetch at the end.

    The JAX package pads every call to ``batch_size`` (one compiled shape);
    here a call of fewer items runs at its own size, so an MMVP pair
    encodes 2 images, not ``batch_size``."""
    n = len(items)
    size = min(batch_size, n)
    outs = []
    for start in range(0, n, size):
        chunk = items[start : start + size]
        pad = size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        out = encode_fn(chunk)
        outs.append(out[: len(out) - pad] if pad else out)
    return torch.cat(outs).float().cpu().numpy()


class CLIPScorer:
    """Dual-tower cosine scorer over a CLIP model (the port's
    :class:`~clip_embeds_tpu_torch.models.clip.CLIP`, on its device and in
    its dtype)."""

    def __init__(
        self,
        model,
        batch_size: int = 64,
        preprocess_variant: str = "clip",
    ):
        self.model = model
        self.batch_size = batch_size
        self.image_size = model.cfg.vision.image_size
        self.preprocess_variant = preprocess_variant
        self.tokenizer = get_tokenizer(model.cfg.text.context_length)
        self.device = model.visual.proj.device
        self.dtype = model.visual.proj.dtype
        self.route = ("fused" if fused_route(model, self.dtype)
                      else "composable")

    @torch.inference_mode()
    def _encode_images(self, pixels: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(pixels).to(self.device, self.dtype)
        if self.route == "fused":
            return fused_encode_image(self.model, x, dtype=self.dtype)
        return self.model.encode_image(x, normalize=True)

    @torch.inference_mode()
    def _encode_texts(self, ids: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(ids).long().to(self.device)
        if self.route == "fused":
            return fused_encode_text(self.model, x, dtype=self.dtype)
        return self.model.encode_text(x, normalize=True)

    def encode_images(self, images: Sequence[ImageLike]) -> np.ndarray:
        pixels = preprocess_batch(images, self.image_size, self.preprocess_variant)
        return _batched(self._encode_images, pixels, self.batch_size)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        tokens = self.tokenizer(list(texts))
        return _batched(self._encode_texts, tokens, self.batch_size)

    # -- driver interfaces -------------------------------------------------

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        """Per-sample softmax(100*sim) option scores (eval_clip.py:58-65)."""
        images = [s[0] for s in samples]
        img_feats = self.encode_images(images)
        all_texts: List[str] = []
        offsets = [0]
        for _, options in samples:
            all_texts.extend(options)
            offsets.append(offsets[-1] + len(options))
        txt_feats = self.encode_texts(all_texts)

        out = []
        for i, (_, options) in enumerate(samples):
            tf = txt_feats[offsets[i] : offsets[i + 1]]
            logits = 100.0 * img_feats[i] @ tf.T
            probs = np.exp(logits - logits.max())
            out.append(probs / probs.sum())
        return out

    def pair_score(self, images: Sequence[str], texts: Sequence[str]) -> np.ndarray:
        """t2i softmax over images per text (MMVP, eval_clip.py:296-307)."""
        img = self.encode_images(images)
        txt = self.encode_texts(texts)
        logits = 100.0 * txt @ img.T
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def score_matrix(self, images: Sequence[ImageLike], texts: Sequence[str]) -> np.ndarray:
        """Plain cosine m x n matrix (t2v_metrics CLIPScore semantics)."""
        return self.encode_images(images) @ self.encode_texts(texts).T
