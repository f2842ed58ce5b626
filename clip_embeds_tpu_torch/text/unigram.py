"""Pure-Python sentencepiece *unigram* tokenizer, no native dependency: a
copy of ``clip_embeds_tpu/text/unigram.py`` (the port imports nothing of
the JAX package).

The reference SigLipTokenizer (open_clip/src/open_clip/tokenizer.py:464-528)
wraps HF T5TokenizerFast/GemmaTokenizerFast over a sentencepiece ``.model``
file; both routes need the native ``sentencepiece`` package, which is absent
here. The ``.model`` file is just a protobuf (sentencepiece ModelProto)
whose unigram pieces + log-prob scores fully determine the encoding, so
this module provides:

  * a minimal protobuf wire-format reader for ModelProto (pieces only),
  * the sentencepiece normalization used by the T5/Gemma vocabs
    (NFKC, whitespace collapse, dummy-prefix, U+2581 escaping),
  * Viterbi unigram segmentation with the same unknown-token rules the
    HF ``tokenizers`` Unigram model uses (unk piece only where no
    single-char piece matches, penalty = min_score - 10, consecutive
    unknowns fused),
  * a ModelProto *writer* (tests and ``chip_smoke.py`` build .model
    fixtures with it).
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Iterable, List, Optional, Sequence, Tuple

WS = "▁"  # sentencepiece whitespace escape
UNK_PENALTY = 10.0  # kUnkPenalty (sentencepiece unigram_model.cc)

# SentencePiece.Type enum values
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# -- protobuf wire format -----------------------------------------------------


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire == 1:
            value = data[i:i + 8]
            i += 8
        elif wire == 2:
            length, i = _read_varint(data, i)
            value = data[i:i + length]
            i += length
        elif wire == 5:
            value = data[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """ModelProto bytes -> [(piece, score, type)] in id order.

    ModelProto field 1 = repeated SentencePiece{1: piece, 2: score, 3: type}
    (sentencepiece_model.proto); everything else is ignored.
    """
    pieces: List[Tuple[str, float, int]] = []
    for field, wire, value in _iter_fields(data):
        if field != 1 or wire != 2:
            continue
        piece, score, ptype = "", 0.0, NORMAL
        for f2, w2, v2 in _iter_fields(value):
            if f2 == 1 and w2 == 2:
                piece = v2.decode("utf-8")
            elif f2 == 2 and w2 == 5:
                score = struct.unpack("<f", v2)[0]
            elif f2 == 3 and w2 == 0:
                ptype = v2
        pieces.append((piece, score, ptype))
    return pieces


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_model_proto(pieces: Iterable[Tuple[str, float, int]]) -> bytes:
    """[(piece, score, type)] -> ModelProto bytes (test-fixture writer)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        raw = piece.encode("utf-8")
        body += b"\x0a" + _varint(len(raw)) + raw          # field 1, wire 2
        body += b"\x15" + struct.pack("<f", score)          # field 2, wire 5
        body += b"\x18" + _varint(ptype)                    # field 3, wire 0
        out += b"\x0a" + _varint(len(body)) + bytes(body)   # ModelProto.pieces
    return bytes(out)


# -- normalization ------------------------------------------------------------


def spm_normalize(
    text: str,
    add_dummy_prefix: bool = True,
    remove_extra_whitespace: bool = True,
    escape_whitespace: bool = True,
) -> str:
    """The nmt_nfkc-style normalization of the T5/Gemma sentencepiece vocabs:
    NFKC, control-char strip, whitespace collapse, leading dummy prefix, and
    U+2581 escaping. (The full precompiled charsmap also folds a handful of
    NMT-specific codepoints; NFKC covers the text that survives the CLIP
    cleaning applied before tokenization.)"""
    text = unicodedata.normalize("NFKC", text)
    text = "".join(
        " " if ch in "\t\n\r\x0b\x0c" else ch
        for ch in text
        if unicodedata.category(ch) != "Cc"
    )
    if remove_extra_whitespace:
        text = " ".join(text.split())
    if not text:
        return ""
    if add_dummy_prefix:
        text = " " + text
    if escape_whitespace:
        text = text.replace(" ", WS)
    return text


# -- unigram model ------------------------------------------------------------


class UnigramTokenizer:
    """Viterbi unigram segmentation over a sentencepiece piece table."""

    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        self.pieces = list(pieces)
        self.vocab = {}
        self.unk_id = 0
        min_score = 0.0
        for idx, (piece, score, ptype) in enumerate(self.pieces):
            if ptype == UNKNOWN:
                self.unk_id = idx
            if ptype in (NORMAL, USER_DEFINED):
                self.vocab[piece] = (idx, score)
                min_score = min(min_score, score)
        self.max_piece_len = max((len(p) for p in self.vocab), default=1)
        self.unk_score = min_score - UNK_PENALTY
        self.eos_id = next(
            (i for i, (p, _, t) in enumerate(self.pieces)
             if t == CONTROL and p in ("</s>", "<eos>")), 1,
        )
        self.pad_id = next(
            (i for i, (p, _, t) in enumerate(self.pieces)
             if t == CONTROL and p == "<pad>"), 0,
        )

    @classmethod
    def from_model_file(cls, path: str) -> "UnigramTokenizer":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    def encode(self, text: str, normalize: bool = True) -> List[int]:
        """Text -> piece ids (no specials appended)."""
        s = spm_normalize(text) if normalize else text
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        for i in range(n):
            if best[i] == NEG:
                continue
            matched_single = False
            top = min(self.max_piece_len, n - i)
            for length in range(1, top + 1):
                hit = self.vocab.get(s[i:i + length])
                if hit is None:
                    continue
                if length == 1:
                    matched_single = True
                idx, score = hit
                j = i + length
                cand = best[i] + score
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, idx)
            if not matched_single:
                # unknown char edge (tokenizers Unigram: only where no
                # single-char piece exists; penalty = min_score - 10)
                cand = best[i] + self.unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        j = n
        while j > 0:
            i, idx = back[j]
            ids.append(idx)
            j = i
        ids.reverse()
        # fuse consecutive unknowns (tokenizers fuse_unk for spm conversions)
        fused: List[int] = []
        for idx in ids:
            if fused and idx == self.unk_id and fused[-1] == self.unk_id:
                continue
            fused.append(idx)
        return fused

    def tokenize(self, text: str) -> List[str]:
        return [self.pieces[i][0] for i in self.encode(text)]
