"""Batched scorers bridging models to the evaluations of ``evals/``
(counterpart of ``clip_embeds_tpu/scores/scorers.py``: ``_batched``,
``CLIPScorer``, ``PACLScorer``, ``SPARCScorer`` and ``SiglipScorer``).

The reference drivers run one PIL image + a couple of captions per forward
(eval_clip.py:50-65); here images and texts are accumulated and encoded in
device batches of one size (the tail padded, so every launch of a call has
one shape). Scoring conventions per family (SURVEY.md §2a):

* CLIPScorer  — probs = softmax(100 * img @ txt.T) over options, row compare.
* PACLScorer  — raw 100 * cosine, diagonal compare (eval_pacl.py:52-57): the
                image is tiled once per option and paired row-wise with it.
* SPARCScorer — global (mean-pooled) or local (grouped) scoring
                (pacl.py:438-451), one tower call per sample.

Routing: on the card in bf16, where ``fused_path_available`` holds, the
CLIP scorer runs ``fused_encode_image`` / ``fused_encode_text`` (the
fused-block kernels), as the JAX scorer does on the TPU. Elsewhere the
composable towers run: on the CPU, as JAX off the TPU; and in fp32 on the
card, the route ``cli/embed.py --fp32`` takes (the kernels are bf16; the
JAX package's TPU fused path runs in either dtype). The PACL and SPARC
scorers run the composable towers everywhere, as the JAX ones do: on the
card in bf16 the 577-token vision tower's attention is the flash kernel,
the 77-token text tower's plain attention. Their heads compute in fp32.
The SigLIP scorer, on the card in bf16 where ``siglip_fused_available``
holds, runs its images through ``fused_encode_image_siglip`` (the JAX
scorer's TPU route) and its texts through the composable tower (64 tokens:
plain attention); elsewhere, fp32 on the card included, both composable.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..image.preprocess import ImageLike, preprocess_batch
from ..losses.sparc import sparc_group_patches
from ..models.clip import l2_normalize
from ..models.serving import (
    fused_encode_image,
    fused_encode_image_siglip,
    fused_encode_text,
    fused_route,
    siglip_fused_available,
)
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


class _HeadScorer:
    """What the PACL and SPARC scorers share: a frozen CLIP (the port's
    :class:`~clip_embeds_tpu_torch.models.clip.CLIP`, on its device and in
    its dtype, composable towers) and a head from ``models/heads.py`` (fp32
    parameters, on the same device)."""

    route = "composable"

    def __init__(self, clip_model, head, batch_size: int,
                 preprocess_variant: str):
        self.model = clip_model
        self.head = head.eval()
        self.batch_size = batch_size
        self.image_size = clip_model.cfg.vision.image_size
        self.preprocess_variant = preprocess_variant
        self.tokenizer = get_tokenizer(clip_model.cfg.text.context_length)
        self.device = clip_model.visual.proj.device
        self.dtype = clip_model.visual.proj.dtype

    def _pixels(self, images: Sequence[ImageLike]) -> np.ndarray:
        return preprocess_batch(images, self.image_size,
                                self.preprocess_variant)

    def _to_head(self, a) -> torch.Tensor:
        """Tower outputs into the head: fp32 on the device (flax's fp32
        Dense promotes the bf16 tokens the same way)."""
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        return a.to(self.device, torch.float32)


class PACLScorer(_HeadScorer):
    """Scorer over a frozen CLIP tower + PACL head. ``text_encoder`` (texts
    -> [N, Dt] embeddings, e.g. precomputed LLM2Vec ones) replaces the
    CLIP text tower."""

    def __init__(
        self,
        clip_model,
        head,
        batch_size: int = 32,
        preprocess_variant: str = "pacl",
        text_encoder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
    ):
        super().__init__(clip_model, head, batch_size, preprocess_variant)
        self.text_encoder = text_encoder
        self.per_pair = head.rope == "after" or head.pooling == "weighted"

    @torch.inference_mode()
    def _patches(self, pixels: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(pixels).to(self.device, self.dtype)
        return self.model.encode_image(x, output_tokens=True)[1]

    @torch.inference_mode()
    def _text_cls(self, ids: np.ndarray) -> torch.Tensor:
        return self.model.encode_text(
            torch.from_numpy(ids).long().to(self.device))

    @torch.inference_mode()
    def _head_cosines(self, patches: np.ndarray,
                      text_emb: np.ndarray) -> np.ndarray:
        """cos(v_n, t_n) per row of the head's (image, text) outputs."""
        v, t = self.head(self._to_head(patches), self._to_head(text_emb))
        return torch.einsum("nd,nd->n", v, t).cpu().numpy()

    def _image_patches(self, images: Sequence[ImageLike]) -> np.ndarray:
        return _batched(self._patches, self._pixels(images), self.batch_size)

    def _text_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        if self.text_encoder is not None:
            return np.asarray(self.text_encoder(texts))
        tokens = self.tokenizer(list(texts))
        return _batched(self._text_cls, tokens, self.batch_size)

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        """Diagonal-compare scores: s[j] = 100 * cos(vis_j, txt_j) where the
        image is paired row-wise with each option (eval_pacl.py:52-57)."""
        patches = self._image_patches([s[0] for s in samples])
        out = []
        for i, (_, options) in enumerate(samples):
            t_emb = self._text_embeddings(options)
            tiled = np.repeat(patches[i : i + 1], len(options), axis=0)
            out.append(100.0 * self._head_cosines(tiled, t_emb))
        return out

    def pair_score(self, images: Sequence[str], texts: Sequence[str]) -> np.ndarray:
        """t2i softmax over images per text, every (text, image) through
        the head (MMVP)."""
        patches = self._image_patches(images)
        t_emb = self._text_embeddings(texts)
        rows = [self._head_cosines(
            patches, np.repeat(t_emb[j : j + 1], len(images), axis=0))
            for j in range(len(texts))]
        logits = 100.0 * np.stack(rows)  # [n_txt, n_img]
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class SPARCScorer(_HeadScorer):
    """SPARC scoring (pacl.py:438-451): global or ``local`` variant.

    ``sigma`` defaults to 1/625 whatever the tower's patch count: the
    reference's sparc constructor default (pacl.py:381), which its eval
    (eval_sparc.py:368) never overrides."""

    def __init__(
        self,
        clip_model,
        head,
        batch_size: int = 32,
        local: bool = False,
        sigma: Optional[float] = None,
        preprocess_variant: str = "pacl",
    ):
        super().__init__(clip_model, head, batch_size, preprocess_variant)
        self.local = local
        self.sigma = sigma if sigma is not None else 1.0 / 625

    @torch.inference_mode()
    def head_outputs(self, pixels: np.ndarray, tokens: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both towers' tokens through the head: (v [n, P, D], t [n, T,
        D]), unnormalised."""
        x = torch.from_numpy(pixels).to(self.device, self.dtype)
        ids = torch.from_numpy(tokens).long().to(self.device)
        _, patches = self.model.encode_image(x, output_tokens=True)
        _, text_tokens = self.model.encode_text(ids, output_tokens=True)
        return self.head(self._to_head(patches), self._to_head(text_tokens))

    @torch.inference_mode()
    def _score(self, pixels: np.ndarray, tokens: np.ndarray) -> np.ndarray:
        v, t = self.head_outputs(pixels, tokens)
        # sparc.forward normalizes token/grouped embeddings PER TOKEN before
        # scoring means them (pacl.py:476-478 -> scoring 443-451):
        # normalize(mean(normalize(t))), not normalize(mean(t)). The raw v
        # and t feed the grouping similarity, and v the global image mean.
        global_txt = l2_normalize(l2_normalize(t).mean(dim=1))
        if self.local:
            grouped = sparc_group_patches(v, t, self.sigma)
            img = l2_normalize(l2_normalize(grouped).mean(dim=1))
        else:
            img = l2_normalize(v.mean(dim=1))
        return (img @ global_txt.t()).cpu().numpy()

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        out = []
        for image, options in samples:
            pixels = self._pixels([image] * len(options))
            sim = self._score(pixels, self.tokenizer(list(options)))
            out.append(100.0 * np.diag(sim))
        return out

    def pair_score(self, images: Sequence[str], texts: Sequence[str]) -> np.ndarray:
        n_img = len(images)
        rows = []
        for text in texts:
            sim = self._score(self._pixels(list(images)),
                              self.tokenizer([text] * n_img))
            rows.append(100.0 * np.diag(sim))
        logits = np.stack(rows)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class SiglipScorer:
    """SigLIP dual-encoder scorer (sigmoid-loss scoring semantics) over the
    port's :class:`~clip_embeds_tpu_torch.models.siglip.Siglip`, on its
    device and in its dtype.

    The pairing score is sigmoid(logit_scale * cos + logit_bias).
    ``tokenize`` is any texts -> int [B, 64] ids callable;
    ``text/tokenizer.py SigLipTokenizer`` (pure-Python sentencepiece
    unigram over a local ``.model`` file) is the native choice.
    """

    def __init__(self, model, tokenize: Callable, batch_size: int = 64):
        self.model = model
        self.tokenize = tokenize
        self.batch_size = batch_size
        self.image_size = model.cfg.vision.image_size
        self.device = model.logit_scale.device
        self.dtype = model.vision_model.position_embedding.dtype
        self.route = ("fused" if self.device.type == "cuda"
                      and self.dtype == torch.bfloat16
                      and siglip_fused_available(model.cfg.vision)
                      else "composable")
        self._scale = float(model.logit_scale.detach().float().exp())
        self._bias = float(model.logit_bias.detach().float())

    @torch.inference_mode()
    def _encode_images(self, pixels: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(pixels).to(self.device, self.dtype)
        if self.route == "fused":
            return fused_encode_image_siglip(self.model, x, dtype=self.dtype)
        return self.model.encode_image(x)

    @torch.inference_mode()
    def _encode_texts(self, ids: np.ndarray) -> torch.Tensor:
        return self.model.encode_text(
            torch.from_numpy(ids).long().to(self.device))

    def encode_images(self, images: Sequence[ImageLike]) -> np.ndarray:
        pixels = preprocess_batch(images, self.image_size, "siglip")
        return _batched(self._encode_images, pixels, self.batch_size)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        ids = np.asarray(self.tokenize(list(texts)))
        return _batched(self._encode_texts, ids, self.batch_size)

    def sigmoid_scores(
        self, images: Sequence[ImageLike], texts: Sequence[str]
    ) -> np.ndarray:
        """m x n pairing probabilities sigmoid(scale*cos + bias)."""
        sims = self.encode_images(images) @ self.encode_texts(texts).T
        z = self._scale * sims + self._bias
        return 1.0 / (1.0 + np.exp(-z))

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        """Per-sample softmax over option cosines (score_batch protocol of
        ``evals/whatsup.py``)."""
        images = [s[0] for s in samples]
        img_feats = self.encode_images(images)
        all_texts: List[str] = []
        offsets = [0]
        for _, options in samples:
            all_texts.extend(options)
            offsets.append(offsets[-1] + len(options))
        txt_feats = self.encode_texts(all_texts)
        out = []
        for i in range(len(samples)):
            tf = txt_feats[offsets[i]:offsets[i + 1]]
            logits = self._scale * img_feats[i] @ tf.T + self._bias
            e = np.exp(logits - logits.max())
            out.append(e / e.sum())
        return out

    def pair_score(
        self, images: Sequence[str], texts: Sequence[str]
    ) -> np.ndarray:
        """t2i softmax over images per text (MMVP-VLM protocol)."""
        img = self.encode_images(images)
        txt = self.encode_texts(texts)
        logits = self._scale * txt @ img.T + self._bias
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
