"""The port's VLM2Vec entry points against the JAX package's on the CPU at
the tiny size of test_torch_vlm2vec.py, from one score bundle written by
the JAX package: cli/train_vlm2vec.py on the synthetic, MMEB-directory and
--quant_base routes (the port's adapters drawn as JAX draws them, so the
runs can agree: the losses, the saved adapters and the merged bundle),
cli/eval_mmeb.py with adapters merged and served over the W8A8 trunk (the
same accuracy table, the embedding cache read back), EmbeddingScorer, and
the CLIs' device and mesh rules. Tolerances: losses and embeddings rtol
1e-5 / atol 1e-5 (losses as JAX logs them, to 4 decimals), adapters and
merged weights after two AdamW steps 1e-4."""

import json
import logging
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli.eval_mmeb import main as jax_eval_main
from clip_embeds_tpu.cli.train_vlm2vec import main as jax_train_main
from clip_embeds_tpu.models import lora as jlora
from clip_embeds_tpu.models import quant as jquant
from clip_embeds_tpu.scores.build import save_score_bundle as jsave_bundle
from clip_embeds_tpu.scores.embedding_scorer import (
    EmbeddingScorer as JaxEmbeddingScorer)

from clip_embeds_tpu_torch.cli.eval_mmeb import main as eval_main
from clip_embeds_tpu_torch.cli.train_vlm2vec import main as train_main
from clip_embeds_tpu_torch.models import lora
from clip_embeds_tpu_torch.scores.embedding_scorer import EmbeddingScorer
from test_torch_vlm2vec import (GRAD_TOL, TOL, base, jax_cfg,  # noqa: F401
                                jmodel, port, toy_tokenize,
                                write_mmeb_fixture)

RANK = 4


@pytest.fixture(scope="module")
def bundle(base, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "llava")
    jsave_bundle(path, "llava", jax_cfg(), base[0], conversation="chat")
    return path


def jax_losses(caplog):
    return [float(m) for m in re.findall(r"step \d+/\d+ loss ([-\d.]+)",
                                         caplog.text)]


def npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("route", ["synthetic", "mmeb", "quant_base"])
def test_train_cli_matches_jax(base, bundle, tmp_path, route, caplog,
                               monkeypatch):
    common = ["--checkpoint_path", bundle, "--lora", "--lora_r", str(RANK),
              "--lora_alpha", "8", "--max_steps", "2",
              "--per_device_train_batch_size", "4", "--no_bf16",
              "--grad_cache", "--gc_q_chunk_size", "2", "--learning_rate",
              "1e-3", "--seed", "7", "--data_parallel", "1"]
    if route == "mmeb":
        write_mmeb_fixture(str(tmp_path))
        common += ["--dataset_name", str(tmp_path), "--subset_name", "A",
                   "B", "--num_sample_per_subset", "4", "--max_len", "40"]
    if route == "quant_base":
        common.append("--quant_base")
    jparams = (jquant.quantize_llava_trunk(base[0]) if route == "quant_base"
               else base[0])

    def jax_init(model, rank, generator, targets):
        tree = jlora.init_lora(jparams, rank=rank,
                               rng=jax.random.PRNGKey(7 + 1),
                               targets=targets)
        return {k: {n: torch.tensor(np.asarray(v)) for n, v in ab.items()}
                for k, ab in tree.items()}

    with caplog.at_level(logging.INFO):
        assert jax_train_main(common + ["--output_dir",
                                        str(tmp_path / "jax")]) == 0
    want = jax_losses(caplog)
    monkeypatch.setattr(lora, "init_lora", jax_init)
    state, report = train_main(common + ["--output_dir",
                                         str(tmp_path / "port"), "--device",
                                         "cpu"])
    assert len(want) == 2 and state.step == 2
    np.testing.assert_allclose(report["losses"], want, rtol=0, atol=1e-4)
    got, exp = (npz(tmp_path / d / "adapter-final.npz")
                for d in ("port", "jax"))
    assert sorted(got) == sorted(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], **GRAD_TOL)
    merged = [os.path.isdir(tmp_path / d / "merged") for d in ("port", "jax")]
    assert merged == [route != "quant_base"] * 2
    if route == "synthetic":  # the merged bundles: one layout, one weights
        got, exp = (npz(tmp_path / d / "merged" / "params.npz")
                    for d in ("port", "jax"))
        assert sorted(got) == sorted(exp)
        for k in exp:
            np.testing.assert_allclose(got[k], exp[k], **GRAD_TOL)


def write_eval_fixture(root, seed=0):
    """Two MMEB-eval subsets: image queries against text candidates, and
    text queries against image+text candidates, gold first."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (24, 30, 3), np.uint8)).save(
            os.path.join(root, "images", f"{i}.png"))
    i2t = [{"qry_text": f"what is in picture {i}",
            "qry_img_path": f"{i}.png",
            "tgt_text": [f"object {(i + j) % 5}" for j in range(3)]}
           for i in range(4)]
    t2i = [{"qry_text": f"find the photo of thing {i}", "qry_img_path": "",
            "tgt_text": ["<image> this photo"] * 3,
            "tgt_img_path": [f"{(i + j) % 4}.png" for j in range(3)]}
           for i in range(3)]
    for name, rows in (("I2T", i2t), ("T2I", t2i)):
        with open(os.path.join(root, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)


@pytest.mark.parametrize("how", ["merged", "quant_base"])
def test_eval_mmeb_cli_matches_jax(base, bundle, tmp_path, how):
    """The accuracy table of both packages from one bundle and one adapter
    file, merged (--lora) or served over the W8A8 trunk (--quant_base); a
    second port run reads its embedding cache back."""
    from test_torch_vlm2vec import jax_adapters

    from clip_embeds_tpu.core.factory import flatten_params

    write_eval_fixture(str(tmp_path / "data"))
    adapter = str(tmp_path / "adapter.npz")
    np.savez(adapter, **flatten_params(jax_adapters(base[0])))
    argv = ["--model_name", bundle, "--checkpoint_path", adapter,
            "--lora_r", str(RANK), "--lora_alpha", "8", "--no_bf16",
            "--dataset_name", str(tmp_path / "data"), "--subset_name", "I2T",
            "T2I", "--image_dir", str(tmp_path / "data" / "images"),
            "--per_device_train_batch_size", "2", "--max_len", "40",
            "--lora" if how == "merged" else "--quant_base"]
    assert jax_eval_main(argv + ["--encode_output_path",
                                 str(tmp_path / "jax")]) == 0
    out = str(tmp_path / "port")
    table, report = eval_main(argv + ["--encode_output_path", out,
                                      "--device", "cpu"])
    with open(tmp_path / "jax" / "results.json") as fh:
        want = json.load(fh)
    with open(os.path.join(out, "results.json")) as fh:
        assert json.load(fh) == want
    assert table == want and report["items"] > 0
    for name in ("I2T_qry", "I2T_tgt", "T2I_qry", "T2I_tgt"):
        (got, pairs), (exp, jpairs) = (
            pickle.load(open(os.path.join(d, name), "rb"))
            for d in (out, str(tmp_path / "jax")))
        assert pairs == jpairs
        np.testing.assert_allclose(got, np.asarray(exp, np.float32), **TOL)
    again, report = eval_main(argv + ["--encode_output_path", out,
                                      "--device", "cpu"])
    assert again == table and report["items"] == 0


def test_embedding_scorer_matches_jax(base):
    params, _ = base
    rng = np.random.default_rng(2)
    images = [Image.fromarray(rng.integers(0, 256, (30, 40, 3), np.uint8))
              for _ in range(3)]
    kw = dict(bos_token_id=1, batch_size=2)
    ours = EmbeddingScorer(port(base), toy_tokenize, **kw)
    theirs = JaxEmbeddingScorer(jmodel(), params, toy_tokenize, **kw)
    qs = ["what is here", "count them", "colour"]
    texts = ["a red ball", "two dogs on grass", "nothing"]
    for fn, args in (("embed_queries", (images, qs)),
                     ("embed_image_texts", (images, texts)),
                     ("embed_texts", (texts,))):
        np.testing.assert_allclose(getattr(ours, fn)(*args),
                                   np.asarray(getattr(theirs, fn)(*args)),
                                   **TOL)
    got = ours.score_batch([(images[0], texts), (images[1], texts[:2])],
                           "which")
    want = theirs.score_batch([(images[0], texts), (images[1], texts[:2])],
                              "which")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(ours.pair_score(images, texts),
                               theirs.pair_score(images, texts), **TOL)
    with pytest.raises(ValueError, match="lora_rank > 0"):
        EmbeddingScorer(port(base), toy_tokenize, lora={})


def test_clis_run_on_the_card_unless_asked():
    """Without --device cpu the CLIs ask for the card and exit without one;
    the mesh flags of multi-GPU training raise, naming its ROADMAP item."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (train_main, eval_main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--lora", "--max_steps", "1"])
    for flag in ("--data_parallel", "--model_parallel"):
        with pytest.raises(ValueError, match="queue 1 item 6"):
            train_main(["--lora", flag, "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="fp32"):
        train_main(["--device", "cpu", "--max_steps", "1"])
