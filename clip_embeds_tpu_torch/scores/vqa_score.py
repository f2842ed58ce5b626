"""VQAScore: P(answer="Yes" | image, question) = exp(-mean CE), over the
port's LLaVA, InstructBLIP-FlanT5 and CLIP-FlanT5 (counterpart of
``clip_embeds_tpu/scores/vqa_score.py``: the templates, the tokenisation,
:class:`VQAScorer`, :class:`InstructBlipVQAScorer`, :class:`T5VQAScorer`
and :class:`GPT4VScorer`), and :class:`PairBatches`, the pair loop of the
ITM-style scores (BLIP-2 ITM / ITC, ImageReward) on the same placement.

Reference: t2v_metrics llava_model.py: question/answer templates, the 'chat'
conversation format with SYSTEM_MSG, <image>-splitting tokenisation
(mm_utils.py tokenizer_image_token), question-prefix label masking with the
trailing-whitespace correction, and per-sample (-CE).exp().

The tokenizer is passed in: any callable text -> List[int] (an HF Llama
tokenizer through :func:`hf_tokenizer_adapter` where ``transformers`` and
the tokenizer files exist, or a toy tokenizer).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..image.preprocess import ImageLike, preprocess_batch
from ..models.llava import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    Llava,
    expand_like_tokens,
)

SYSTEM_MSG = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)
DEFAULT_IMAGE_TOKEN = "<image>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
DEFAULT_QUESTION_TEMPLATE = 'Does this figure show "{}"? Please answer yes or no.'
DEFAULT_ANSWER_TEMPLATE = "Yes"

# MPT-style single-turn prompts (reference conversation.py get_prompt with
# conv_phi3_instruct / conv_llama3): system + sep + role0 + question + sep
# + role1
PHI3_SYSTEM = "<|system|>\nYou are a helpful AI assistant."
LLAMA3_SYSTEM = (
    "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
    + SYSTEM_MSG
)

TokenizeFn = Callable[[str], List[int]]


def _exp_neg_mean_ce(shift_logits: torch.Tensor,
                     shift_labels: torch.Tensor) -> torch.Tensor:
    """exp(-mean CE over non-IGNORE labels) per row, from fp32 logits."""
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    logz = torch.logsumexp(shift_logits, dim=-1)
    picked = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    ce = (logz - picked) * valid
    mean_ce = ce.sum(dim=1) / valid.sum(dim=1).clamp_min(1)
    return torch.exp(-mean_ce)


def format_question(question: str, style: str = "chat") -> str:
    """The conversation formats, with the paper-added phi3_instruct /
    llama3 styles (llava-phi-3, llava-llama-3)."""
    if style == "plain":
        return DEFAULT_IMAGE_TOKEN + question
    if style == "chat":
        return (
            SYSTEM_MSG + " USER: " + DEFAULT_IMAGE_TOKEN + "\n" + question
            + " ASSISTANT: "
        )
    if style in ("phi3_instruct", "llama3"):
        if IMAGE_PLACEHOLDER in question:
            qs = question.replace(IMAGE_PLACEHOLDER, DEFAULT_IMAGE_TOKEN)
        else:
            qs = DEFAULT_IMAGE_TOKEN + "\n" + question
        if style == "phi3_instruct":
            return (
                PHI3_SYSTEM + "<|end|>" + "\n<|user|>\n" + qs + "<|end|>"
                + "\n<|assistant|>\n"
            )
        return (
            LLAMA3_SYSTEM + "<|eot_id|>"
            + "<|start_header_id|>user<|end_header_id|>\n\n" + qs
            + "<|eot_id|>"
            + "<|start_header_id|>assistant<|end_header_id|>\n\n"
        )
    raise NotImplementedError(style)


def format_answer(answer: str, style: str = "chat") -> str:
    """answer + the style's end-of-turn token."""
    if style == "plain":
        return answer + "\n"
    if style == "chat":
        return answer + "</s>"
    if style == "phi3_instruct":
        return answer + "<|end|>"
    if style == "llama3":
        return answer + "<|eot_id|>"
    raise NotImplementedError(style)


def tokenizer_image_token(
    prompt: str,
    tokenize: TokenizeFn,
    bos_token_id: Optional[int] = None,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Split on <image>, tokenize chunks, splice the sentinel id between
    them (mm_utils.py semantics, the BOS offset handling included)."""
    chunks = [tokenize(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and bos_token_id is not None and chunks[0][0] == bos_token_id:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    joined: List[List[int]] = []
    for i, chunk in enumerate(chunks):
        joined.append(chunk)
        if i < len(chunks) - 1:
            joined.append(sep)
    for segment in joined:
        ids.extend(segment[offset:])
    return ids


def hf_tokenizer_adapter(hf_tokenizer) -> tuple:
    """(tokenize_fn, bos_token_id, pad_token_id) from an HF tokenizer."""
    return (
        lambda text: hf_tokenizer(text).input_ids,
        hf_tokenizer.bos_token_id,
        hf_tokenizer.pad_token_id or 0,
    )


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _shared_prefix(prepared) -> Optional[int]:
    """The prefix length the candidates of one image share and that the
    KV reuse may cache: the longest common token prefix, cut so that the
    first answer token's predictor lies in the suffix; None where the
    per-image path does not apply (fewer than 2 texts, a prefix under 8
    tokens, or no image sentinel inside it)."""
    rows = [ids for ids, _ in prepared]
    lcp = len(rows[0])
    for r in rows[1:]:
        m = min(lcp, len(r))
        i = 0
        while i < m and r[i] == rows[0][i]:
            i += 1
        lcp = i
    first_label = min(
        next(i for i, l in enumerate(lab) if l != IGNORE_INDEX)
        for _, lab in prepared
    )
    prefix_len = min(lcp, first_label - 1)
    sentinel = rows[0].index(IMAGE_TOKEN_INDEX) \
        if IMAGE_TOKEN_INDEX in rows[0] else -1
    if len(rows) < 2 or prefix_len < 8 or not (0 <= sentinel < prefix_len):
        return None
    return prefix_len


class _DeviceScorer:
    """The device placement and tensor helpers the scorers share: the
    model on ``device`` (default the card; without one it raises unless
    given ``device='cpu'``), in eval mode, computing in ``dtype``."""

    def _place(self, model, device, dtype: torch.dtype, name: str) -> None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{name}: no CUDA device is available; "
                               "pass device='cpu' to score on the CPU")
        self.model = model.to(device).eval()
        self.device = device
        self.dtype = dtype

    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(a)
        if a.dtype == np.int32:
            t = t.long()
        return t.to(self.device, dtype)


class PairBatches(_DeviceScorer):
    """The pair loop of the ITM-style scores: texts tokenised, cut and
    zero-padded to ``max_length`` (the reference's 35), images through the
    'clip' preprocess, ``batch_size`` pairs a call of ``fn(pixels, ids,
    mask) -> [b]`` on ``device``."""

    def __init__(self, model, fn, tokenize, image_size: int,
                 max_length: int = 35, batch_size: int = 8,
                 device="cuda", name: str = "score"):
        self._place(model, device, next(model.parameters()).dtype, name)
        self.fn, self.tokenize = fn, tokenize
        self.image_size, self.max_length = image_size, max_length
        self.batch_size = batch_size

    def __call__(self, images, texts) -> np.ndarray:
        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), self.batch_size):
            rows = [self.tokenize(t)[: self.max_length]
                    for t in texts[s : s + self.batch_size]]
            ids = np.zeros((len(rows), self.max_length), np.int64)
            mask = np.zeros((len(rows), self.max_length), bool)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                mask[i, : len(r)] = True
            pixels = preprocess_batch(list(images[s : s + self.batch_size]),
                                      self.image_size, "clip")
            with torch.inference_mode():
                got = self.fn(self._tensor(pixels, self.dtype),
                              self._tensor(ids), self._tensor(mask))
            out[s : s + len(rows)] = got.float().cpu().numpy()
        return out


class VQAScorer(_DeviceScorer):
    """Batched VQAScore over the port's LLaVA, on ``device`` (default the
    card; without one it raises unless given ``device='cpu'``) in the
    model's dtype. Three paths: :meth:`forward` (pairs, the full masked
    forward), :meth:`forward_image_texts` (one prefill of an image, then
    its candidates against the cached prefix K/V) and
    :meth:`forward_groups` (one batched prefill of k images, then one
    block-diagonal suffix pass)."""

    def __init__(
        self,
        model: Llava,
        tokenize: TokenizeFn,
        bos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        conversation_style: str = "chat",
        context_len: int = 2048,
        batch_size: int = 8,
        pad_to_multiple: int = 64,
        suffix_pad_to_multiple: int = 16,
        device: Union[str, torch.device] = "cuda",
    ):
        self._place(model, device,
                    model.language_model.embed_tokens.weight.dtype,
                    "VQAScorer")
        self.tokenize = tokenize
        self.bos_token_id = bos_token_id
        self.pad_token_id = pad_token_id
        self.style = conversation_style
        self.context_len = context_len
        self.batch_size = batch_size
        self.pad_to_multiple = pad_to_multiple
        self.suffix_pad_to_multiple = suffix_pad_to_multiple
        self.image_size = model.cfg.vision.image_size

    def _pixels(self, images) -> torch.Tensor:
        return self._tensor(preprocess_batch(list(images), self.image_size,
                                             "llava"), self.dtype)

    def _prepare(self, image: ImageLike, text: str, q_tpl: str, a_tpl: str):
        question = format_question(q_tpl.format(text), self.style)
        answer = format_answer(a_tpl.format(text), self.style)
        ids = tokenizer_image_token(
            question + answer, self.tokenize, self.bos_token_id
        )
        q_len = len(
            tokenizer_image_token(question, self.tokenize, self.bos_token_id)
        )
        if question.endswith(" "):
            q_len -= 1  # the reference's whitespace correction
        labels = [IGNORE_INDEX] * q_len + ids[q_len:]
        return ids[: self.context_len], labels[: self.context_len]

    def forward(
        self,
        images: Sequence[ImageLike],
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """Scores for n (image, text) pairs -> [n] array."""
        assert len(images) == len(texts)
        prepared = [
            self._prepare(img, txt, question_template, answer_template)
            for img, txt in zip(images, texts)
        ]
        out = np.zeros((len(prepared),), np.float32)
        for start in range(0, len(prepared), self.batch_size):
            chunk = prepared[start : start + self.batch_size]
            imgs = images[start : start + self.batch_size]
            out[start : start + len(chunk)] = self._forward_chunk(chunk, imgs)
        return out

    @torch.inference_mode()
    def _prefill(self, prefix_ids: np.ndarray, pixels: torch.Tensor,
                 prefix_valid: np.ndarray):
        return self.model.prefill(self._tensor(prefix_ids), pixels,
                                  self._tensor(prefix_valid))

    def forward_image_texts(
        self,
        image: ImageLike,
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """Score ONE image against n texts with image-KV-prefix reuse: the
        image block plus the common question prefix is prefilled once
        (:meth:`Llava.prefill`), and the n candidate suffixes run batched
        against its per-layer K/V (:meth:`Llava.suffix_logits`) instead of
        a full forward per pair."""
        texts = list(texts)
        n = len(texts)
        prepared = [
            self._prepare(image, t, question_template, answer_template)
            for t in texts
        ]
        prefix_len = _shared_prefix(prepared)
        if prefix_len is None:
            return self.forward([image] * n, texts, question_template,
                                answer_template)

        lp_pad = _pad_to(prefix_len, self.pad_to_multiple)
        prefix_ids = np.full((1, lp_pad), self.pad_token_id, np.int32)
        prefix_ids[0, :prefix_len] = prepared[0][0][:prefix_len]
        # padded slots must not alias the sentinel
        prefix_valid = np.zeros((1, lp_pad), bool)
        prefix_valid[0, :prefix_len] = True
        kv, pmask = self._prefill(prefix_ids, self._pixels([image]),
                                  prefix_valid)
        real_f = prefix_len - 1 + self.model.cfg.n_image_tokens

        out = np.zeros((n,), np.float32)
        for s in range(0, n, self.batch_size):
            chunk = prepared[s : s + self.batch_size]
            b = len(chunk)
            ls = _pad_to(max(len(ids) - prefix_len for ids, _ in chunk),
                         self.suffix_pad_to_multiple)
            suffix_ids = np.full((b, ls), self.pad_token_id, np.int32)
            labels = np.full((b, ls), IGNORE_INDEX, np.int32)
            suffix_mask = np.zeros((b, ls), bool)
            for i, (ids, lab) in enumerate(chunk):
                tail = ids[prefix_len:]
                suffix_ids[i, : len(tail)] = tail
                labels[i, : len(tail)] = lab[prefix_len:]
                suffix_mask[i, : len(tail)] = True
            out[s : s + b] = self._suffix_scores(
                suffix_ids, suffix_mask, labels, kv, pmask, real_f)
        return out

    @torch.inference_mode()
    def _suffix_scores(self, suffix_ids, suffix_mask, labels, kv, pmask,
                       real_f) -> np.ndarray:
        logits = self.model.suffix_logits(
            self._tensor(suffix_ids), kv, pmask, self._tensor(suffix_mask),
            real_f)
        return _exp_neg_mean_ce(logits[:, :-1].float(),
                                self._tensor(labels)[:, 1:]).cpu().numpy()

    def pack_groups(
        self,
        images: Sequence[ImageLike],
        texts_per_image: Sequence[Sequence[str]],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ):
        """The host side of :meth:`forward_groups`: (groups, live, batch).
        ``groups[i]`` is image i's (prepared, prefix_len), or None where it
        takes the per-image path; ``batch`` holds the arrays of the live
        images' one prefill and one suffix pass (None if none is live)."""
        k = len(images)
        assert k == len(texts_per_image)
        n = len(texts_per_image[0])
        assert all(len(t) == n for t in texts_per_image), (
            "forward_groups needs a uniform text count per image")
        groups = []
        for img, texts in zip(images, texts_per_image):
            prepared = [
                self._prepare(img, t, question_template, answer_template)
                for t in texts
            ]
            prefix_len = _shared_prefix(prepared)
            groups.append(None if prefix_len is None
                          else (prepared, prefix_len))
        live = [i for i, g in enumerate(groups) if g is not None]
        if not live:
            return groups, live, None

        lp_pad = _pad_to(max(groups[i][1] for i in live),
                         self.pad_to_multiple)
        ls = _pad_to(max(len(ids) - groups[i][1]
                         for i in live for ids, _ in groups[i][0]),
                     self.suffix_pad_to_multiple)
        kb = len(live)
        batch = {
            "prefix_ids": np.full((kb, lp_pad), self.pad_token_id, np.int32),
            "prefix_valid": np.zeros((kb, lp_pad), bool),
            "suffix_ids": np.full((kb, n * ls), self.pad_token_id, np.int32),
            "suffix_mask": np.zeros((kb, n * ls), bool),
            "labels": np.full((kb, n * ls), IGNORE_INDEX, np.int32),
            "real_f": np.zeros((kb,), np.int32),
            "ls": ls,
            "images": [images[i] for i in live],
        }
        n_image = self.model.cfg.n_image_tokens
        for row, gi in enumerate(live):
            prepared, plen = groups[gi]
            batch["prefix_ids"][row, :plen] = prepared[0][0][:plen]
            batch["prefix_valid"][row, :plen] = True
            batch["real_f"][row] = plen - 1 + n_image
            for t, (ids, lab) in enumerate(prepared):
                tail = ids[plen:]
                cols = slice(t * ls, t * ls + len(tail))
                batch["suffix_ids"][row, cols] = tail
                batch["labels"][row, cols] = lab[plen:]
                batch["suffix_mask"][row, cols] = True
        return groups, live, batch

    def forward_groups(
        self,
        images: Sequence[ImageLike],            # k images
        texts_per_image: Sequence[Sequence[str]],  # k lists of n texts each
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """[k, n] scores from one batched prefill of the k images
        (per-row sentinels and prefix lengths) and one suffix pass where
        each row holds its n candidate suffixes concatenated, attending
        block-diagonally over the row's prefix K/V (no K/V replication).
        An image whose texts share no usable prefix takes
        :meth:`forward_image_texts`."""
        n = len(texts_per_image[0])
        groups, live, batch = self.pack_groups(
            images, texts_per_image, question_template, answer_template)
        out = np.zeros((len(images), n), np.float32)
        for i, g in enumerate(groups):
            if g is None:
                out[i] = self.forward_image_texts(
                    images[i], list(texts_per_image[i]),
                    question_template, answer_template)
        if batch is not None:
            scores = self._group_scores(batch)
            for row, gi in enumerate(live):
                out[gi] = scores[row]
        return out

    @torch.inference_mode()
    def group_logits(self, batch) -> torch.Tensor:
        """The prefill and the block-diagonal suffix pass of a
        :meth:`pack_groups` batch: logits [kb, n * ls, vocab]."""
        kv, pmask = self.model.prefill(
            self._tensor(batch["prefix_ids"]), self._pixels(batch["images"]),
            self._tensor(batch["prefix_valid"]))
        return self.model.suffix_logits(
            self._tensor(batch["suffix_ids"]), kv, pmask,
            self._tensor(batch["suffix_mask"]),
            self._tensor(batch["real_f"]), suffix_block=batch["ls"])

    @torch.inference_mode()
    def _group_scores(self, batch) -> np.ndarray:
        logits = self.group_logits(batch)
        kb, width, vocab = logits.shape
        ls = batch["ls"]
        n = width // ls
        blocks = logits.reshape(kb * n, ls, vocab)
        lab = self._tensor(batch["labels"]).reshape(kb * n, ls)
        scores = _exp_neg_mean_ce(blocks[:, :-1].float(), lab[:, 1:])
        return scores.reshape(kb, n).cpu().numpy()

    @torch.inference_mode()
    def _forward_chunk(self, prepared, images) -> np.ndarray:
        n = len(prepared)
        max_len = _pad_to(max(len(ids) for ids, _ in prepared),
                          self.pad_to_multiple)
        input_ids = np.full((n, max_len), self.pad_token_id, np.int32)
        labels = np.full((n, max_len), IGNORE_INDEX, np.int32)
        mask = np.zeros((n, max_len), bool)
        for i, (ids, lab) in enumerate(prepared):
            input_ids[i, : len(ids)] = ids
            labels[i, : len(lab)] = lab
            mask[i, : len(ids)] = True
        ids_t = self._tensor(input_ids)
        logits = self.model(ids_t, self._pixels(images),
                            self._tensor(mask))
        full_labels = expand_like_tokens(
            self._tensor(labels), ids_t, self.model.cfg.n_image_tokens,
            IGNORE_INDEX)
        return _exp_neg_mean_ce(logits[:, :-1].float(),
                                full_labels[:, 1:]).cpu().numpy()


def _pad_rows(rows, pad_value: int, multiple: int):
    """Right-padded ids [n, width] (width a multiple of ``multiple``) and
    their bool mask."""
    n = len(rows)
    width = _pad_to(max(len(r) for r in rows), multiple)
    ids = np.full((n, width), pad_value, np.int32)
    mask = np.zeros((n, width), bool)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = True
    return ids, mask


def _decoder_inputs(a_ids):
    """(labels with IGNORE_INDEX pads, decoder mask), padded to 8."""
    a, dec_mask = _pad_rows(a_ids, 0, 8)
    return np.where(dec_mask, a, IGNORE_INDEX).astype(np.int32), dec_mask


# -- InstructBLIP (Q-Former + FlanT5) ---------------------------------------

INSTRUCTBLIP_QUESTION_TEMPLATE = (
    'Question: Does this figure show "{}"? Please answer yes or no.'
)
INSTRUCTBLIP_ANSWER_TEMPLATE = "yes"  # instructblip uses lowercase


class InstructBlipVQAScorer(_DeviceScorer):
    """VQAScore over an InstructBLIP-FlanT5 model: the question goes both
    to the Q-Former (a BERT tokenizer) as the instruction and to the T5
    encoder; the decoder teacher-forces the answer; score = exp(-mean
    CE). :meth:`forward_image_texts` runs the EVA-g tower once for the
    image and replays it across the texts."""

    def __init__(
        self,
        model,  # models.instructblip.InstructBlipT5
        qformer_tokenize: TokenizeFn,
        t5_tokenize: TokenizeFn,
        qformer_pad_id: int = 0,
        t5_pad_id: int = 0,
        max_txt_len: int = 128,        # lavis blip2_t5_instruct default
        max_output_txt_len: int = 256,
        batch_size: int = 8,
        pad_to_multiple: int = 32,
        device: Union[str, torch.device] = "cuda",
    ):
        self._place(model, device, model.t5.shared.weight.dtype,
                    "InstructBlipVQAScorer")
        self.qformer_tokenize = qformer_tokenize
        self.t5_tokenize = t5_tokenize
        self.qformer_pad_id = qformer_pad_id
        self.t5_pad_id = t5_pad_id
        self.max_txt_len = max_txt_len
        self.max_output_txt_len = max_output_txt_len
        self.batch_size = batch_size
        self.pad_to_multiple = pad_to_multiple
        self.image_size = model.cfg.vision.image_size

    def _pixels(self, images) -> torch.Tensor:
        # the reference's instructblip preprocess: shortest-edge bicubic
        # resize, centre crop, CLIP statistics
        return self._tensor(preprocess_batch(list(images), self.image_size,
                                             "clip"), self.dtype)

    def _tokenize(self, texts, question_template, answer_template):
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        return ([self.qformer_tokenize(q)[: self.max_txt_len]
                 for q in questions],
                [self.t5_tokenize(q)[: self.max_txt_len] for q in questions],
                [self.t5_tokenize(a)[: self.max_output_txt_len]
                 for a in answers])

    def _inputs(self, q_ids, t_ids, a_ids):
        m = self.pad_to_multiple
        q, q_mask = _pad_rows(q_ids, self.qformer_pad_id, m)
        t, t_mask = _pad_rows(t_ids, self.t5_pad_id, m)
        labels, dec_mask = _decoder_inputs(a_ids)
        return [self._tensor(x) for x in (q, t, labels, q_mask, t_mask,
                                          dec_mask)]

    def forward(
        self,
        images: Sequence[ImageLike],
        texts: Sequence[str],
        question_template: str = INSTRUCTBLIP_QUESTION_TEMPLATE,
        answer_template: str = INSTRUCTBLIP_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        assert len(images) == len(texts)
        q_ids, t_ids, a_ids = self._tokenize(texts, question_template,
                                             answer_template)
        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), self.batch_size):
            e = s + self.batch_size
            out[s:e] = self._chunk(self._pixels(images[s:e]), None,
                                   q_ids[s:e], t_ids[s:e], a_ids[s:e])
        return out

    @torch.inference_mode()
    def _chunk(self, pixels, embeds, q_ids, t_ids, a_ids) -> np.ndarray:
        q, t, labels, q_mask, t_mask, dec_mask = self._inputs(q_ids, t_ids,
                                                              a_ids)
        if embeds is None:
            logits = self.model(pixels, q, t, labels, q_mask, t_mask,
                                dec_mask)
        else:
            logits = self.model.forward_with_vision(
                embeds.expand(len(q_ids), -1, -1), q, t, labels, q_mask,
                t_mask, dec_mask)
        return _exp_neg_mean_ce(logits.float(), labels).cpu().numpy()

    def forward_image_texts(
        self,
        image: ImageLike,
        texts: Sequence[str],
        question_template: str = INSTRUCTBLIP_QUESTION_TEMPLATE,
        answer_template: str = INSTRUCTBLIP_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """One image x n texts with the EVA-g tower run once: the Q-Former
        and T5 read the candidate text, so they run per pair."""
        with torch.inference_mode():
            embeds = self.model.encode_vision(self._pixels([image]))
        q_ids, t_ids, a_ids = self._tokenize(texts, question_template,
                                             answer_template)
        out = np.zeros((len(texts),), np.float32)
        for s in range(0, len(texts), self.batch_size):
            e = s + self.batch_size
            out[s:e] = self._chunk(None, embeds, q_ids[s:e], t_ids[s:e],
                                   a_ids[s:e])
        return out


# -- CLIP-FlanT5 (encoder-decoder) ----------------------------------------


def format_question_t5(question: str, style: str = "t5_chat") -> str:
    """The clip_t5 conversation formats."""
    if style == "t5_plain":
        return DEFAULT_IMAGE_TOKEN + question
    if style == "t5_chat":
        return (
            SYSTEM_MSG + " USER: " + DEFAULT_IMAGE_TOKEN + "\n" + question
            + " ASSISTANT: "
        )
    if style == "t5_chat_no_system":
        return "USER: " + DEFAULT_IMAGE_TOKEN + "\n" + question + " ASSISTANT: "
    if style == "t5_chat_no_system_no_user":
        return DEFAULT_IMAGE_TOKEN + "\n" + question + " : "
    raise NotImplementedError(style)


def t5_tokenizer_image_token(
    prompt: str,
    tokenize: TokenizeFn,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """The no-BOS splice: the chunks around each <image> tokenised, the
    sentinel between them."""
    chunks = [tokenize(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids: List[int] = []
    for i, chunk in enumerate(chunks):
        ids.extend(chunk)
        if i < len(chunks) - 1:
            ids.append(image_token_index)
    return ids


class T5VQAScorer(_DeviceScorer):
    """VQAScore over a CLIP-FlanT5 model: the encoder takes image +
    question, the decoder teacher-forces the answer; score = exp(-mean
    CE). Three paths: :meth:`forward` (pairs, the tower run per chunk of
    pairs), :meth:`forward_image_texts` (one tower pass for the image,
    then the texts batched against its features) and
    :meth:`forward_groups` (one tower pass for k images, then all k x n
    pairs batched). The encoder is bidirectional, so past the image
    features nothing is shared across texts."""

    def __init__(
        self,
        model,  # models.clip_t5.CLIPT5
        tokenize: TokenizeFn,
        pad_token_id: int = 0,
        conversation_style: str = "t5_chat",
        context_len: int = 2048,
        batch_size: int = 8,
        pad_to_multiple: int = 64,
        device: Union[str, torch.device] = "cuda",
    ):
        self._place(model, device, model.t5.shared.weight.dtype,
                    "T5VQAScorer")
        self.tokenize = tokenize
        self.pad_token_id = pad_token_id
        self.style = conversation_style
        self.context_len = context_len
        self.batch_size = batch_size
        self.pad_to_multiple = pad_to_multiple
        self.image_size = model.cfg.vision.image_size

    def _pixels(self, images) -> torch.Tensor:
        return self._tensor(preprocess_batch(list(images), self.image_size,
                                             "llava"), self.dtype)

    def _tokenize_pairs(self, texts, question_template, answer_template):
        questions = [format_question_t5(question_template.format(t),
                                        self.style) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        q_ids = [t5_tokenizer_image_token(q, self.tokenize)[: self.context_len]
                 for q in questions]
        a_ids = [self.tokenize(a)[: self.context_len] for a in answers]
        return q_ids, a_ids

    def batch_inputs(self, q_ids, a_ids):
        """(input_ids, encoder mask, labels, decoder mask) on the device:
        the questions padded to ``pad_to_multiple``, the answers to 8."""
        ids, enc_mask = _pad_rows(q_ids, self.pad_token_id,
                                  self.pad_to_multiple)
        labels, dec_mask = _decoder_inputs(a_ids)
        return [self._tensor(x) for x in (ids, enc_mask, labels, dec_mask)]

    def forward(
        self,
        images: Sequence[ImageLike],
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        assert len(images) == len(texts)
        q_ids, a_ids = self._tokenize_pairs(texts, question_template,
                                            answer_template)
        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), self.batch_size):
            e = s + self.batch_size
            out[s:e] = self._scores(self._pixels(images[s:e]), None,
                                    q_ids[s:e], a_ids[s:e])
        return out

    @torch.inference_mode()
    def _scores(self, pixels, feats, q_ids, a_ids) -> np.ndarray:
        ids, enc_mask, labels, dec_mask = self.batch_inputs(q_ids, a_ids)
        if feats is None:
            logits = self.model(ids, pixels, labels, enc_mask, dec_mask)
        else:
            logits = self.model.forward_with_features(ids, feats, labels,
                                                      enc_mask, dec_mask)
        return _exp_neg_mean_ce(logits.float(), labels).cpu().numpy()

    @torch.inference_mode()
    def encode_image_features(self, images: Sequence[ImageLike]
                              ) -> torch.Tensor:
        """The vision tower and projector, once per image: [k, n_image,
        d_model] on the device."""
        return self.model.encode_images(self._pixels(images))

    def _pairs_with_features(self, feats, img_idx, q_ids, a_ids
                             ) -> np.ndarray:
        """Pairs (q_ids[p], a_ids[p]) against feats[img_idx[p]], batched;
        the features stay on the device across batches."""
        n = len(q_ids)
        idx = torch.as_tensor(np.asarray(img_idx, np.int64),
                              device=self.device)
        out = np.zeros((n,), np.float32)
        for s in range(0, n, self.batch_size):
            e = s + self.batch_size
            out[s:e] = self._scores(None, feats[idx[s:e]], q_ids[s:e],
                                    a_ids[s:e])
        return out

    def forward_image_texts(
        self,
        image: ImageLike,
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """One image x n texts: one tower pass, then n batched T5 passes."""
        feats = self.encode_image_features([image])
        q_ids, a_ids = self._tokenize_pairs(texts, question_template,
                                            answer_template)
        return self._pairs_with_features(feats, [0] * len(texts), q_ids,
                                         a_ids)

    def forward_groups(
        self,
        images: Sequence[ImageLike],
        texts_per_image: Sequence[Sequence[str]],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """k images x n texts each -> [k, n]: one batched tower pass for the
        k images, then T5 over all k * n pairs in batches."""
        k, n = len(images), len(texts_per_image[0])
        assert all(len(t) == n for t in texts_per_image)
        feats = self.encode_image_features(images)
        q_ids, a_ids, img_idx = [], [], []
        for i, texts in enumerate(texts_per_image):
            qi, ai = self._tokenize_pairs(texts, question_template,
                                          answer_template)
            q_ids += qi
            a_ids += ai
            img_idx += [i] * n
        return self._pairs_with_features(feats, img_idx, q_ids,
                                         a_ids).reshape(k, n)


# -- GPT-4V (API-backed) ------------------------------------------------------


class GPT4VScorer:
    """GPT-4V VQAScore: ask the chat model the yes/no question with the
    image attached, read P(answer) from the first generated token's
    top-logprobs; 0.0 when the answer token is absent or the call fails.

    No device work. The transport is passed in:
    ``complete(question_text, image_path) -> [(token, logprob), ...]``, a
    thin wrapper over the provider's chat-completions call."""

    def __init__(
        self,
        complete: Callable[[str, str], List],
        top_logprobs: int = 2,
    ):
        self.complete = complete
        self.top_logprobs = top_logprobs

    def forward(
        self,
        images: Sequence[str],
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        assert len(images) == len(texts)
        out = np.zeros((len(images),), np.float32)
        for i, (image, text) in enumerate(zip(images, texts)):
            question = question_template.format(text)
            answer = answer_template.format(text)
            try:
                top = self.complete(question, image)
            except Exception:
                continue  # the reference returns 0.0 on failure
            for token, logprob in top:
                if token == answer:
                    out[i] = float(np.exp(logprob))
                    break
        return out
