"""``text/tokenizer.py`` against the JAX package's on the CPU: the clean
modes (``whitespace_clean``, ``get_clean_fn``), ``BPETokenizer``'s
``clean`` and ``additional_special_tokens`` with ``all_special_ids``, the
reduction masks (random, shuffle, simple, syntax) on over-long captions
with the same seeds and context lengths, and ``HFTokenizer`` on a BERT
vocabulary written here; every array equal, int32."""

import os
import subprocess
import sys

import numpy as np
import pytest

from clip_embeds_tpu.text import tokenizer as jtok
from clip_embeds_tpu_torch.text import tokenizer as ptok

CASES = ["Hello_World! It's  GREAT.", "a{b}c {kept} d",
         "under_score and CAPS...", "  spaces\teverywhere ",
         "Fish &amp; chips &lt;3", "<mask> a Photo of <X>"]
# over-long captions, so that each reduction mask drops tokens at the
# context lengths below
LONG = [
    "a small brown dog is running quickly across the wide green field "
    "while two happy children are playing with a red ball near the old "
    "wooden fence under the bright blue sky of a warm summer afternoon",
    "the tall glass vase stands on the polished table beside a stack of "
    "dusty books, and the heavy curtains hide the rainy window behind it",
    "short caption",
]


@pytest.fixture(scope="module")
def toks():
    """(port, JAX) BPE tokenizers for each clean mode, with two extra
    special tokens."""
    extra = ["<mask>", "<x>"]
    return {clean: (ptok.BPETokenizer(context_length=16, clean=clean,
                                      additional_special_tokens=extra),
                    jtok.BPETokenizer(context_length=16, clean=clean,
                                      additional_special_tokens=extra))
            for clean in ("lower", "whitespace")}


def test_clean_functions_match_jax():
    for c in CASES:
        assert ptok.whitespace_clean(c) == jtok.whitespace_clean(c)
    for kind in ("canonicalize", "lower", "whitespace"):
        mine, theirs = ptok.get_clean_fn(kind), jtok.get_clean_fn(kind)
        for c in CASES:
            assert mine(c) == theirs(c), (kind, c)
    for mod in (ptok, jtok):
        with pytest.raises(ValueError, match="Invalid clean function"):
            mod.get_clean_fn("upper")


@pytest.mark.parametrize("clean", ["lower", "whitespace"])
def test_bpe_clean_modes_and_special_tokens_match_jax(toks, clean):
    ours, theirs = toks[clean]
    assert ours.all_special_ids == theirs.all_special_ids == [
        49406, 49407, 49408, 49409]
    assert ours.vocab_size == theirs.vocab_size == 49410
    for ctx in (None, 8, 77):
        got, want = ours(CASES + LONG, ctx), theirs(CASES + LONG, ctx)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # the default stays CLIP's lower-case tokenizer
    assert ptok.BPETokenizer().clean_fn is ptok.get_clean_fn("lower")


@pytest.mark.parametrize("kind", ["random", "shuffle", "simple"])
@pytest.mark.parametrize("ctx", [10, 16, 77])
def test_random_and_simple_masks_match_jax(toks, kind, ctx):
    ours, theirs = toks["lower"]
    for seed in (0, 1, 7):
        got = ptok.get_reduction_mask_fn(kind)(
            LONG, ours, ctx, rng=np.random.default_rng(seed))
        want = jtok.get_reduction_mask_fn(kind)(
            LONG, theirs, ctx, rng=np.random.default_rng(seed))
        assert got.dtype == np.int32 and got.shape == (len(LONG), ctx)
        np.testing.assert_array_equal(got, want)
    if ctx < 77:
        # the long captions lost tokens: each row is full, EOT last
        n = len(ours.encode(LONG[0]))
        assert n > ctx - 2
        assert got[0, -1] == ours.eot_token_id and (got[0] != 0).all()


@pytest.mark.parametrize("ctx", [10, 16, 77])
def test_syntax_mask_matches_jax(toks, ctx):
    ours, theirs = toks["lower"]
    for tagger in (None, ptok.simple_pos_tagger):
        got = ptok.syntax_mask_tokenize(LONG, ours, ctx, pos_tag_fn=tagger)
        want = jtok.syntax_mask_tokenize(
            LONG, theirs, ctx,
            pos_tag_fn=None if tagger is None else jtok.simple_pos_tagger)
        assert got.dtype == np.int32 and got.shape == (len(LONG), ctx)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ptok.get_reduction_mask_fn("syntax")(LONG, ours, ctx),
        jtok.get_reduction_mask_fn("syntax")(LONG, theirs, ctx))
    if ctx < 77:
        assert (got[:2] != 0).all()  # the long rows were cut to fit


def test_unknown_reduction_mask_raises_as_jax():
    for mod in (ptok, jtok):
        with pytest.raises(ValueError, match="unsupported reduction mask"):
            mod.get_reduction_mask_fn("nouns")


def test_hf_tokenizer_matches_jax(tmp_path):
    """The wrapper over a BertTokenizer written from a vocabulary here:
    both clean modes, sep stripping, a context cut; JAX's ids."""
    transformers = pytest.importorskip("transformers")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "a", "b",
             "photo", "of", "dog", "!", ".", "_"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    transformers.BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(
        str(tmp_path))
    texts = ["Hello  WORLD", "a b", "a photo of a dog!", "hello_world .",
             "dog " * 20]
    for kw in ({}, {"clean": "lower"}, {"clean": "canonicalize"},
               {"strip_sep_token": True}):
        ours = ptok.HFTokenizer(str(tmp_path), context_length=8, **kw)
        theirs = jtok.HFTokenizer(str(tmp_path), context_length=8, **kw)
        for ctx in (None, 5, 12):
            got, want = ours(texts, ctx), theirs(texts, ctx)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ours("hello world"),
                                      theirs("hello world"))


def test_module_needs_no_transformers():
    """The card's machine has no ``transformers``: the module imports
    without it, and only building an ``HFTokenizer`` asks for it."""
    code = ("import sys; sys.modules['transformers'] = None\n"
            "from clip_embeds_tpu_torch.text import tokenizer as t\n"
            "t.BPETokenizer()(['a photo'])\n"
            "try:\n    t.HFTokenizer('x')\nexcept ImportError:\n"
            "    print('needs transformers')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root)
    assert out.stdout.strip() == "needs transformers"
