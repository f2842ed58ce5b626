"""Byte-level BPE tokenizer with CLIP semantics, emitting numpy arrays.

The port's own copy of the CLIP tokenizer of
``clip_embeds_tpu/text/tokenizer.py`` (``BPETokenizer``, ``get_tokenizer``):
lower-case whitespace cleanup, byte -> unicode remapping, greedy
lowest-rank BPE merges with an end-of-word marker, <start_of_text> /
<end_of_text> specials, fixed context length with zero padding and
EOT-preserving truncation. The vocabulary ``bpe_simple_vocab_16e6.txt.gz``
(the public OpenAI CLIP merge table) sits beside this file.
``tests/test_torch_convert.py`` holds its ids to the JAX package's. Also a
copy of the same file's offline POS bucketizer, ``simple_pos_tagger``, which
the PACL noun-phrase chunker reads (``tests/test_torch_pacl.py`` holds it to
JAX's), and of its SigLIP sentencepiece tokenizer, ``SigLipTokenizer`` with
``basic_clean`` and ``canonicalize_text`` (``tests/test_torch_siglip.py``
holds its ids to JAX's).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import regex as re

try:  # optional dependency
    import ftfy

    _fix_text = ftfy.fix_text
except ImportError:  # clean ASCII input is unaffected by ftfy
    def _fix_text(text: str) -> str:
        return text

DEFAULT_CONTEXT_LENGTH = 77

_WORD_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)


def default_bpe_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache()
def byte_to_unicode() -> dict:
    """Invertible map from the 256 byte values to printable unicode chars:
    printable bytes map to themselves, the rest are shifted past 0x100."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    # insertion order fixes the vocab ids: printable bytes first, then the
    # shifted remainder in ascending byte order
    ordered = {b: chr(b) for b in printable}
    shifted = 0
    for b in range(256):
        if b not in ordered:
            ordered[b] = chr(256 + shifted)
            shifted += 1
    return ordered


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(_fix_text(text))).strip()


def _clean_lower(text: str) -> str:
    return " ".join(basic_clean(text).split()).strip().lower()


def canonicalize_text(
    text: str,
    *,
    keep_punctuation_exact_string: Optional[str] = None,
) -> str:
    """big_vision prompt canonicalization (reference tokenizer.py:104-131):
    lowercase, strip punctuation, collapse whitespace; '_' becomes space."""
    import string as _string

    trans = str.maketrans("", "", _string.punctuation)
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(trans)
            for part in text.split(keep_punctuation_exact_string)
        )
    else:
        text = text.translate(trans)
    text = text.lower()
    text = " ".join(text.split())
    return text.strip()


class BPETokenizer:
    """CLIP byte-BPE tokenizer (vocab 49408, context 77 by default).

    Vocabulary ids: [0, 256) byte units, [256, 512) byte units + '</w>',
    [512, 49406) merge results in merge-rank order, 49406 / 49407
    <start_of_text> / <end_of_text>.
    """

    def __init__(self, bpe_path: Optional[str] = None,
                 context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH):
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path or default_bpe_path(), "rt",
                       encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        # a header line, then the merges that fill a 49152-sized space less
        # the 256 byte slots and the 2 specials
        merges = [tuple(line.split())
                  for line in lines[1: 49152 - 256 - 2 + 1]]
        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [ch + "</w>" for ch in self.byte_encoder.values()]
        vocab += ["".join(pair) for pair in merges]
        specials = ["<start_of_text>", "<end_of_text>"]
        vocab += specials
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_ranks = {pair: i for i, pair in enumerate(merges)}
        self._cache = {tok: tok for tok in specials}
        self.pattern = re.compile("|".join(specials) + "|" + _WORD_PATTERN,
                                  re.IGNORECASE)
        self.vocab_size = len(vocab)
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]
        self.context_length = context_length

    def _bpe(self, token: str) -> List[str]:
        """Greedy lowest-rank merge loop over one pre-tokenized word."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached.split(" ")
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            best_rank, best_idx = None, -1
            for i in range(len(parts) - 1):
                rank = self.merge_ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best_rank, best_idx = rank, i
            if best_rank is None:
                break
            # merge every occurrence of this pair, left to right
            first, second = parts[best_idx], parts[best_idx + 1]
            out: List[str] = []
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] == first
                        and parts[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        self._cache[token] = " ".join(parts)
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in re.findall(self.pattern, _clean_lower(text)):
            word_bytes = "".join(self.byte_encoder[b]
                                 for b in word.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(word_bytes))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        """Tokenize to a zero-padded int32 array [B, context_length];
        over-long sequences are cut with EOT forced into the last slot."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        if not context_length:
            raise ValueError("context_length must be set")
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot_token_id
            result[row, : len(ids)] = ids
        return result


@functools.lru_cache()
def get_tokenizer(context_length: int = DEFAULT_CONTEXT_LENGTH
                  ) -> BPETokenizer:
    return BPETokenizer(context_length=context_length)


class SigLipTokenizer:
    """SigLIP sentencepiece tokenizer (reference tokenizer.py:464-528; a
    copy of the JAX package's): canonicalize(basic_clean(text)) -> unigram
    sentencepiece encode + </s>, pad to 64 (pad id 1 for the T5
    c4-en/mc4 vocabs, 0 for Gemma).

    Runs the pure-Python unigram engine of ``text/unigram.py`` directly
    over the ``.model`` protobuf, with no native ``sentencepiece``. Pass
    the local path of the vocabulary file: nothing is downloaded.
    """

    def __init__(self, tokenizer_name: str,
                 context_length: Optional[int] = 64):
        from .unigram import UnigramTokenizer

        if not os.path.exists(tokenizer_name):
            raise FileNotFoundError(
                f"SigLipTokenizer needs a local sentencepiece .model file; "
                f"{tokenizer_name!r} does not exist (the reference downloads "
                "c4-en/mc4/gemma vocabs; see tokenizer.py:470-477)"
            )
        self.tokenizer = UnigramTokenizer.from_model_file(tokenizer_name)
        self.is_gemma = "gemma" in tokenizer_name
        self.pad_token_id = 0 if self.is_gemma else 1
        self.eos_token_id = 1
        self.context_length = context_length

    def __call__(self, texts, context_length: Optional[int] = None
                 ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        assert context_length, "set a context length"
        texts = [canonicalize_text(basic_clean(t)) for t in texts]
        out = np.full((len(texts), context_length), self.pad_token_id,
                      np.int32)
        for i, text in enumerate(texts):
            # truncate to leave room for </s> like the HF fast tokenizer
            ids = self.tokenizer.encode(text)[: context_length - 1]
            ids = ids + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out


# A tiny self-contained POS bucketizer so the noun-phrase chunker of
# data/pacl_data.py runs offline (a copy of the JAX package's). Maps a word
# to the reference's priority buckets: NN nouns, JJ adjectives, VB verbs,
# XX everything else. Suffix/lexicon heuristics only.
_FUNCTION_WORDS = frozenset(
    "a an the and or but if of in on at to for with by from as is are was "
    "were be been being am do does did done this that these those it its he "
    "she they them his her their there here not no nor so than then over "
    "under into out up down off about after before between during against "
    "very too also just only".split()
)
_VERB_SUFFIXES = ("ing", "ed", "ify", "ize", "ise")
_ADJ_SUFFIXES = ("ous", "ful", "less", "able", "ible", "ish", "ive", "al",
                 "ic", "y")


def simple_pos_tagger(tokens):
    """[(token, tag)] with coarse NN/JJ/VB/XX tags (offline fallback)."""
    out = []
    for tok in tokens:
        low = tok.lower()
        if not tok[:1].isalpha():
            tag = "XX"
        elif low in _FUNCTION_WORDS:
            tag = "XX"
        elif low.endswith(_VERB_SUFFIXES):
            tag = "VB"
        elif low.endswith(_ADJ_SUFFIXES):
            tag = "JJ"
        else:
            tag = "NN"  # content-word default: captions are noun-heavy
        out.append((tok, tag))
    return out
