"""The port's CLIPScorer, PACLScorer, SPARCScorer, CLIPScore and Score
API against the JAX package's (CPU, fp32, the test-tiny config with one
checkpoint made from JAX params, and PACL/SPARC heads saved by the JAX
package as .npz): the same scores within 1e-4, and the eval CLI's tables
with the heads (--scorer pacl|sparc) equal to JAX's CLI."""

import jax
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.core.factory import load_params as jax_load_params
from clip_embeds_tpu.core.factory import save_params_npz as jax_save_npz
from clip_embeds_tpu.models import heads as jax_heads
from clip_embeds_tpu.scores.score import CLIPScore as JaxCLIPScore
from clip_embeds_tpu.scores.score import Score as JaxScore
from clip_embeds_tpu.scores.scorers import PACLScorer as JaxPACLScorer
from clip_embeds_tpu_torch.core.convert import head_state_dict_from_jax_params
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.models import heads
from clip_embeds_tpu_torch.scores.score import CLIPScore, Score
from clip_embeds_tpu_torch.scores.scorers import PACLScorer
from torch_eval_fixtures import (  # noqa: F401 - fixtures
    HEAD_VARIANTS,
    _head_scorers,
    _samples,
    check_head_table,
    checkpoint,
    head_npz,
    scorers,
)


@pytest.mark.parametrize("method", ["score_batch", "pair_score",
                                    "score_matrix"])
def test_clip_scorer_matches_jax(tmp_path, scorers, method):
    samples = _samples(tmp_path)  # 8 images in batches of 4 (+ a tail)
    images = [s[0] for s in samples][:7]
    texts = [s[1][0] for s in samples][:7]
    args = {"score_batch": (samples[:7],), "pair_score": (images[:2], texts[:2]),
            "score_matrix": (images, texts[:5])}[method]
    got, want = (getattr(s, method)(*args) for s in scorers)
    if method == "score_batch":
        assert [len(g) for g in got] == [len(w) for w in want] == [4] * 7
        got, want = np.stack(got), np.stack(want)
    assert got.shape == np.shape(want) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,batch,sizes", [(10, 4, [4, 4, 4]),
                                           (2, 64, [2]), (8, 8, [8])])
def test_batched_runs_one_size_per_call(n, batch, sizes):
    """Batches of min(batch, n) rows, the tail padded and sliced off; the
    rows are those of one unbatched call."""
    from clip_embeds_tpu_torch.scores.scorers import _batched

    items = np.random.default_rng(4).standard_normal((n, 3)).astype("f4")
    seen = []

    def encode(chunk):
        seen.append(len(chunk))
        return torch.from_numpy(chunk * 2).to(torch.bfloat16)

    out = _batched(encode, items, batch)
    assert seen == sizes and out.dtype == np.float32
    np.testing.assert_array_equal(
        out, torch.from_numpy(items * 2).to(torch.bfloat16).float().numpy())


def test_clip_score_matches_jax(tmp_path, checkpoint):
    samples = _samples(tmp_path)
    images = [s[0] for s in samples][:5]
    texts = [s[1][0] for s in samples][:3]
    model, params = jax_create_model("test-tiny", checkpoint)
    ours = CLIPScore(create_model("test-tiny", checkpoint), batch_size=4)
    theirs = JaxCLIPScore(model, params, batch_size=4)
    got, want = ours(images, texts), theirs(images, texts)
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    dataset = [{"images": images[i:i + 2], "texts": texts[:2]}
               for i in range(0, 4, 2)]
    got = ours.batch_forward(dataset, batch_size=1)
    want = theirs.batch_forward(dataset, batch_size=1)
    assert got.shape == want.shape == (2, 2, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method", ["score_batch", "pair_score"])
@pytest.mark.parametrize("variant", list(HEAD_VARIANTS))
def test_head_scorers_match_jax(tmp_path, checkpoint, head_npz, variant,
                                method):
    """PACLScorer (diagonal compare, the image tiled per option) and
    SPARCScorer (global and local) give JAX's scores within 1e-4."""
    scorers = _head_scorers(checkpoint, head_npz, variant)
    samples = _samples(tmp_path)[:5]  # 5 images: a batch of 4 and a tail
    args = {"score_batch": (samples,),
            "pair_score": ([s[0] for s in samples[:3]],
                           samples[0][1][:2])}[method]
    got, want = (getattr(s, method)(*args) for s in scorers)
    if method == "score_batch":
        assert [len(g) for g in got] == [len(w) for w in want] == [4] * 5
        got, want = np.stack(got), np.stack(want)
    assert got.shape == np.shape(want) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.ptp(got) > 1e-2  # the scores are not all alike


def test_pacl_scorer_takes_precomputed_text_embeddings(tmp_path,
                                                      checkpoint):
    """``text_encoder`` (texts -> embeddings, the LLM2CLIP-PACL variant's
    precomputed text side) replaces the CLIP text tower, as in JAX."""
    model, params = jax_create_model("test-tiny", checkpoint)
    cfg = model.cfg
    jhead = jax_heads.PACLHead(proj_dim=32, rope="after")
    params_h = jhead.init(jax.random.PRNGKey(8), np.zeros(
        (1, cfg.vision.num_patches, cfg.vision.width), "f4"),
        np.zeros((1, 24), "f4"))["params"]
    path = str(tmp_path / "llm_head.npz")
    jax_save_npz(params_h, path)
    head = heads.PACLHead(cfg.vision.width, 24, 32, rope="after")
    head.load_state_dict(head_state_dict_from_jax_params(
        jax_load_params(path)))

    def encode(texts):  # a fixed 24-wide embedding per text
        return np.stack([np.random.default_rng(len(t)).standard_normal(24)
                         .astype("f4") for t in texts])

    ours = PACLScorer(create_model("test-tiny", checkpoint), head,
                      batch_size=4, text_encoder=encode)
    theirs = JaxPACLScorer(model, params, jhead, params_h, batch_size=4,
                           text_encoder=encode)
    samples = _samples(tmp_path)[:3]
    got = np.stack(ours.score_batch(samples))
    want = np.stack(theirs.score_batch(samples))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _mock_forwards():
    """Pair, image-texts and group forwards whose score encodes the call."""
    def pair(images, texts):
        return np.array([len(i) + 10.0 * len(t) for i, t in zip(images, texts)])

    def image_texts(image, texts):
        return np.array([100.0 * len(image) + len(t) for t in texts])

    def groups(images, texts):
        return np.array([[1000.0 * len(i) + len(t) for t in ts]
                         for i, ts in zip(images, texts)])
    return pair, image_texts, groups


@pytest.mark.parametrize("kind", ["pair", "image_texts", "groups"])
def test_score_api_matches_jax(kind):
    pair, image_texts, groups = _mock_forwards()
    kw = {"pair": {}, "image_texts": {"image_texts_forward": image_texts},
          "groups": {"image_texts_forward": image_texts,
                     "groups_forward": groups, "group_size": 2}}[kind]
    ours, theirs = Score(pair, **kw), JaxScore(pair, **kw)
    images = ["a.jpg", "bb.jpg", "ccc.jpg"]
    texts = ["x", "yy", "zzzz"]
    np.testing.assert_array_equal(ours(images, texts), theirs(images, texts))
    np.testing.assert_array_equal(ours("a.jpg", "x"), theirs("a.jpg", "x"))
    dataset = [{"images": images[:2], "texts": texts[:2]},
               {"images": images[1:], "texts": texts[1:]}]
    np.testing.assert_array_equal(ours.batch_forward(dataset, batch_size=1),
                                  theirs.batch_forward(dataset, batch_size=1))


@pytest.mark.parametrize("dataset", ["a", "a4"])
@pytest.mark.parametrize("variant", ["pacl-rope-after", "sparc-local"])
def test_eval_cli_head_tables_match_jax(tmp_path, checkpoint, head_npz,
                                        variant, dataset, capsys,
                                        monkeypatch):
    """--scorer pacl|sparc --model-path <a JAX head .npz> [--rope]
    [--sparc-local]: the same table and results-file text as JAX's CLI
    (the MMVP-VLM cases in tests/test_torch_eval_heads_mmvpvlm_*.py)."""
    check_head_table(tmp_path, checkpoint, head_npz, variant, dataset,
                     capsys, monkeypatch)
