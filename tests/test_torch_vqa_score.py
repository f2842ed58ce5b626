"""The port's VQAScore stack against the JAX package's, on the CPU at a tiny
size (a 2-layer trunk of width 64, a 2-layer 32-px tower, a toy word
tokenizer): the prompt formats and the tokenisation, the three VQAScorer
paths, the Score m x n and batch_forward routes (chunked at
``group_size``), the W8A8 trunk, score bundles in both directions, the
registry and the default configs of every family, the 13 T5 / BLIP
names' routes from JAX bundles, GPT-4V's injected transport, the
benchmark copies, and ``cli/t2v_eval.py``."""

import inspect
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds_tpu.cli.t2v_eval import main as jax_t2v_main
from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.evals import benchmarks as jbench
from clip_embeds_tpu.evals import tau as jtau
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.models import llava as jllava
from clip_embeds_tpu.models.quant import quantize_llava_trunk as jquantize
from clip_embeds_tpu.scores import build as jbuild
from clip_embeds_tpu.scores import registry as jregistry
from clip_embeds_tpu.scores import vqa_score as jvqa
from clip_embeds_tpu.scores.score import VQAScore as JVQAScore

from clip_embeds_tpu_torch.cli.t2v_eval import main as t2v_main
from clip_embeds_tpu_torch.core.convert import (
    jax_params_from_module,
    state_dict_from_jax_params,
    vlm_state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.evals import benchmarks as pbench
from clip_embeds_tpu_torch.evals import tau as ptau
from clip_embeds_tpu_torch.models import llava as pllava
from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
from clip_embeds_tpu_torch.scores import build as pbuild
from clip_embeds_tpu_torch.scores import registry as pregistry
from clip_embeds_tpu_torch.scores import vqa_score as pvqa
from clip_embeds_tpu_torch.scores.score import VQAScore

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(batch_size=2, pad_to_multiple=8, suffix_pad_to_multiple=4)
LLAVA_NAMES = (jregistry.LLAVA_MODELS + jregistry.LLAVA_LLAMA_MODELS
               + jregistry.LLAVA16_MODELS)
ITEM13_NAMES = (jregistry.CLIP_T5_MODELS + jregistry.INSTRUCTBLIP_MODELS
                + jregistry.BLIP2_ITM_MODELS + jregistry.BLIP2_ITC_MODELS
                + jregistry.IMAGE_REWARD_MODELS)


def toy_tokenize(text):
    # deterministic word tokenizer with BOS=1
    return [1] + [2 + (sum(map(ord, w)) % 200) for w in text.split()]


def jax_tiny_cfg():
    return jllava.LlavaConfig(
        llama=jllama.LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=256),
        vision=JVisionConfig(image_size=32, patch_size=16, width=64,
                             layers=2, head_width=32),
    )


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, the port's model) on the same weights, every
    float moved off its init value."""
    jcfg = jax_tiny_cfg()
    model = jllava.Llava(jcfg, attn_impl="reference")
    rng = np.random.default_rng(0)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.asarray([[1, jllava.IMAGE_TOKEN_INDEX, 5, 6]], jnp.int32),
        jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32),
    )["params"]
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax.device_get(params))
    cfg = pbuild.config_from_dict(pllava.LlavaConfig,
                                  jbuild.config_to_dict(jcfg))
    port = pllava.Llava(cfg).eval()
    port.load_state_dict(vlm_state_dict_from_jax_params(params, cfg))
    return model, params, port


def _image(seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8))


def _scorers(tiny, **kw):
    model, params, port = tiny
    return (pvqa.VQAScorer(port, toy_tokenize, bos_token_id=1,
                           pad_token_id=0, device="cpu", **SMALL, **kw),
            jvqa.VQAScorer(model, params, toy_tokenize, bos_token_id=1,
                           pad_token_id=0, **SMALL, **kw))


@pytest.mark.parametrize("style", ["plain", "chat", "phi3_instruct",
                                   "llama3"])
def test_prompts_and_tokenization_match_jax(style):
    q = 'Does this figure show "a cat"? Please answer yes or no.'
    assert pvqa.format_question(q, style) == jvqa.format_question(q, style)
    assert pvqa.format_answer("Yes", style) == jvqa.format_answer("Yes", style)
    prompt = pvqa.format_question(q, style) + pvqa.format_answer("Yes", style)
    for bos in (None, 1):
        assert (pvqa.tokenizer_image_token(prompt, toy_tokenize, bos)
                == jvqa.tokenizer_image_token(prompt, toy_tokenize, bos))


def test_exp_neg_mean_ce_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = labels[2, :] = pllava.IGNORE_INDEX
    want = jvqa._exp_neg_mean_ce(jnp.asarray(logits), jnp.asarray(labels))
    got = pvqa._exp_neg_mean_ce(torch.from_numpy(logits),
                                torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("path", ["forward", "forward_image_texts",
                                  "forward_groups"])
def test_vqa_scorer_paths_match_jax(tiny, path):
    """Each path against JAX's on the same inputs; five texts an image with
    batch_size 2 run the suffix loop in chunks."""
    ours, theirs = _scorers(tiny)
    texts = ["a cat on a mat", "a dog", "three green apples on a table",
             "object number four", "x"]
    if path == "forward":
        args = ([_image(1), _image(2), _image(1)], texts[:3])
    elif path == "forward_image_texts":
        args = (_image(3), texts)
    else:
        args = ([_image(4), _image(5), _image(6)],
                [texts[:2], texts[2:4], ["red box", "blue round ball"]])
    got, want = (getattr(s, path)(*args) for s in (ours, theirs))
    assert got.shape == np.shape(want) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_prefix_reuse_matches_pair_path(tiny):
    """Inside the port: the per-image prefix reuse and the k-group path
    give the pair path's scores; a single text falls back to it."""
    ours, _ = _scorers(tiny)
    img = _image(7)
    texts = ["a cat on a mat", "a dog", "three green apples on a table"]
    slow = ours.forward([img] * 3, texts)
    np.testing.assert_allclose(ours.forward_image_texts(img, texts), slow,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ours.forward_groups([img], [texts])[0], slow,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(ours.forward_image_texts(img, ["a cat"]),
                                  ours.forward([img], ["a cat"]))


@pytest.mark.parametrize("route", ["call", "batch_forward"])
def test_score_routes_match_jax(tiny, route):
    """The Score m x n call and batch_forward, at group_size 2 over three
    images (a full group and a remainder), against JAX's VQAScore."""
    model, params, port = tiny
    ours = VQAScore(port, toy_tokenize, group_size=2, bos_token_id=1,
                    pad_token_id=0, device="cpu", **SMALL)
    theirs = JVQAScore(model, params, toy_tokenize, group_size=2,
                       bos_token_id=1, pad_token_id=0, **SMALL)
    images = [_image(40), _image(41), _image(42)]
    texts = ["a cat", "a dog and a cat", "two"]
    if route == "call":
        got, want = ours(images, texts), theirs(images, texts)
        assert got.shape == (3, 3)
    else:
        data = [{"images": [im, _image(50 + i)], "texts": texts[:2]}
                for i, im in enumerate(images)]
        got = ours.batch_forward(data, batch_size=16)
        want = theirs.batch_forward(data, batch_size=16)
        assert got.shape == (3, 2, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_trunk_scores_match_jax(tiny):
    """quantize_llava_trunk and the dynamic QuantLinear trunk against JAX's
    quantised scorer, on the pair and the prefix-reuse paths."""
    model, params, port = tiny
    qmodel = jllava.Llava(jax_tiny_cfg(), attn_impl="reference",
                          quant_llm="dynamic")
    theirs = jvqa.VQAScorer(qmodel, jquantize(params), toy_tokenize,
                            bos_token_id=1, pad_token_id=0, **SMALL)
    ours = pvqa.VQAScorer(quantize_llava_trunk(port), toy_tokenize,
                          bos_token_id=1, pad_token_id=0, device="cpu",
                          **SMALL)
    img, texts = _image(8), ["a cat on a mat", "a dog"]
    for path, args in (("forward", ([img, img], texts)),
                       ("forward_image_texts", (img, texts))):
        np.testing.assert_allclose(getattr(ours, path)(*args),
                                   getattr(theirs, path)(*args), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_jax_bundle_loads_in_the_port(tiny, tmp_path, quant):
    model, params, _ = tiny
    jbuild.save_score_bundle(str(tmp_path), "llava", jax_tiny_cfg(), params,
                             conversation="chat")
    kw = dict(checkpoint=str(tmp_path), tokenize=toy_tokenize,
              batch_size=2, **({"quant": True} if quant else {}))
    ours = pregistry.get_score_model("llava-v1.5-7b", device="cpu", **kw)
    theirs = jregistry.get_score_model("llava-v1.5-7b", **kw)
    images, texts = [_image(9), _image(10)], ["a cat", "a dog", "red box"]
    np.testing.assert_allclose(ours(images, texts), theirs(images, texts),
                               **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_bundle_int8_trunk_is_quantised_from_fp32(tiny, tmp_path, dtype):
    """quant=True quantises the trunk from the bundle's fp32 weights in
    any serving dtype, as JAX quantises its fp32 params: the int8 codes
    and the fp32 scales equal JAX's quantize_llava_trunk's, and the rest
    of the model is in ``dtype``."""
    _, params, _ = tiny
    jbuild.save_score_bundle(str(tmp_path), "llava", jax_tiny_cfg(), params,
                             conversation="chat")
    score = pregistry.get_score_model(
        "llava-v1.5-7b", checkpoint=str(tmp_path), tokenize=toy_tokenize,
        device="cpu", dtype=dtype, quant=True)
    model = score.pair_forward.__self__.model
    want = jquantize(params)["language_model"]["model"]
    n = 0
    for i, layer in enumerate(model.language_model.model.layers):
        for part, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                           "o_proj")),
                            ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                lin = getattr(getattr(layer, part), name)
                node = want[f"layers_{i}"][part][name]
                assert lin.scale.dtype == torch.float32
                np.testing.assert_array_equal(
                    lin.weight_q.numpy(), np.asarray(node["kernel_q"]).T)
                np.testing.assert_array_equal(lin.scale.numpy(),
                                              np.asarray(node["scale"]))
                n += 1
    assert n == 7 * len(model.language_model.model.layers)
    assert model.language_model.embed_tokens.weight.dtype == dtype
    assert model.multi_modal_projector.linear_1.weight.dtype == dtype


def test_port_bundle_loads_in_jax(tiny, tmp_path):
    _, _, port = tiny
    pbuild.save_score_bundle(str(tmp_path), "llava", port.cfg,
                             jax_params_from_module(port),
                             conversation="chat", extra={"source": "port"})
    with open(tmp_path / "config.json") as fh:
        assert json.load(fh)["source"] == "port"
    kw = dict(checkpoint=str(tmp_path), tokenize=toy_tokenize, batch_size=2)
    theirs = jregistry.get_score_model("sharegpt4v-7b", **kw)
    ours = pregistry.get_score_model("sharegpt4v-7b", device="cpu",
                                     scan=True, **kw)
    images, texts = [_image(11)], ["a cat", "a dog"]
    np.testing.assert_allclose(ours(images, texts), theirs(images, texts),
                               **TOL)


@pytest.mark.parametrize("name", LLAVA_NAMES + ITEM13_NAMES)
def test_default_model_config_matches_jax(name):
    assert (pbuild.config_to_dict(pbuild.default_model_config(name))
            == jbuild.config_to_dict(jbuild.default_model_config(name)))
    assert pbuild.VQA_CONVERSATIONS == jbuild.VQA_CONVERSATIONS


def _tiny_family(name):
    """(family, the JAX config at 2 layers and widths 48-64, the port's
    model class) of a T5 / BLIP name."""
    from clip_embeds_tpu.models import blip as jblip
    from clip_embeds_tpu.models import blip2 as jblip2
    from clip_embeds_tpu.models import clip_t5 as jclip_t5
    from clip_embeds_tpu.models import instructblip as jib
    from clip_embeds_tpu.models import t5 as jt5

    from clip_embeds_tpu_torch.models import blip as pblip
    from clip_embeds_tpu_torch.models import blip2 as pblip2
    from clip_embeds_tpu_torch.models import clip_t5 as pclip_t5
    from clip_embeds_tpu_torch.models import instructblip as pib

    vision = JVisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                           head_width=32)
    qformer = jblip2.QFormerConfig(vocab_size=256, hidden_size=48,
                                   num_layers=2, num_heads=4,
                                   intermediate_size=96,
                                   encoder_hidden_size=64)
    if name in jregistry.CLIP_T5_MODELS:
        return ("clip_t5", jclip_t5.CLIPT5Config(t5=jt5.t5_tiny_config(),
                                                 vision=vision),
                pclip_t5.CLIPT5)
    if name in jregistry.INSTRUCTBLIP_MODELS:
        return ("instructblip", jib.InstructBlipConfig(
            vision=vision, qformer=qformer, t5=jt5.t5_tiny_config(),
            num_query_tokens=4), pib.InstructBlipT5)
    if name in jregistry.IMAGE_REWARD_MODELS:
        return ("image_reward", jblip.BlipConfig(
            vision=vision, text=jblip.BlipTextConfig(
                vocab_size=256, hidden_size=48, num_layers=2, num_heads=4,
                intermediate_size=96, max_position_embeddings=64)),
                pblip.ImageReward)
    return ("blip2", jblip2.Blip2Config(vision=vision, qformer=qformer,
                                        num_query_tokens=4,
                                        image_text_hidden_size=16),
            pblip2.Blip2ITM)


@pytest.fixture(scope="module")
def item13_cache(tmp_path_factory):
    """One bundle a family and one JAX result a (family, conversation,
    score kind), shared by the 13 names' cases."""
    return {"bundles": {}, "jax": {}, "root": tmp_path_factory}


@pytest.mark.parametrize("name", ITEM13_NAMES)
def test_item13_names_route_to_a_live_scorer(item13_cache, name):
    """Each T5 / BLIP name builds a live scorer from a bundle through the
    registry on the CPU, whose scores equal JAX's scorer's on the same
    bundle within 1e-5 (JAX's scorer runs once for the names that build
    the same one). The bundle's weights are the port's seeded init
    (``init_score_model``) moved by noise, written in JAX's layout: the
    family test files hold flax-initialised weights, and this saves a
    JAX init compile a family."""
    from clip_embeds_tpu_torch.core.factory import init_score_model

    family, jcfg, cls = _tiny_family(name)
    bundles = item13_cache["bundles"]
    if family not in bundles:
        cfg = pbuild.config_from_dict(
            type(pbuild.default_model_config(name)),
            jbuild.config_to_dict(jcfg))
        with torch.device("meta"):
            port = cls(cfg)
        init_score_model(port, seed=0, device="cpu", dtype=torch.float32)
        rng = np.random.default_rng(1)
        params = jax.tree.map(
            lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
                np.float32), jax_params_from_module(port))
        path = str(item13_cache["root"].mktemp(family))
        jbuild.save_score_bundle(path, family, jcfg, params)
        bundles[family] = path
    kw = dict(checkpoint=bundles[family], tokenize=toy_tokenize,
              batch_size=2)
    if family == "instructblip":
        kw["qformer_tokenize"] = toy_tokenize
    images, texts = [_image(20), _image(21)], ["a cat", "a dog on a mat"]
    got = pregistry.get_score_model(name, device="cpu", **kw)(images, texts)
    assert got.shape == (2, 2) and np.isfinite(got).all()
    key = (family, jbuild.VQA_CONVERSATIONS.get(name),
           name in jregistry.BLIP2_ITC_MODELS)
    if key not in item13_cache["jax"]:
        item13_cache["jax"][key] = jregistry.get_score_model(name, **kw)(
            images, texts)
    np.testing.assert_allclose(got, item13_cache["jax"][key], **TOL)


def test_registry_tables_match_jax():
    for fn in ("list_all_vqascore_models", "list_all_clipscore_models",
               "list_all_itmscore_models", "list_all_models"):
        assert getattr(pregistry, fn)() == getattr(jregistry, fn)()
    assert pregistry.CLIPSCORE_ALIASES == jregistry.CLIPSCORE_ALIASES
    with pytest.raises(NotImplementedError, match="checkpoint="):
        pregistry.get_score_model("llava-v1.5-7b", device="cpu")
    with pytest.raises(KeyError):
        pregistry.get_score_model("no-such-model", device="cpu")


def test_gpt4v_scorer_matches_jax():
    def complete(question, image):
        if image == "bad.png":
            raise OSError("transport failed")
        return [("Yes", -0.5), ("No", -1.2)] if "cat" in question \
            else [("No", -0.1)]

    images, texts = ["a.png", "b.png", "bad.png"], ["a cat", "a dog", "cat"]
    ours = pregistry.get_score_model("gpt-4o", complete=complete)
    theirs = jregistry.get_score_model("gpt-4o", complete=complete)
    np.testing.assert_array_equal(ours.pair_forward(images, texts),
                                  theirs.pair_forward(images, texts))
    with pytest.raises(NotImplementedError, match="complete="):
        pregistry.get_score_model("gpt-4-turbo")


def test_scoring_needs_the_card_unless_asked(tiny, tmp_path, monkeypatch):
    """VQAScorer and build_score_model place the model on the card by
    default; without one they raise instead of running on the CPU."""
    _, params, port = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pvqa.VQAScorer(port, toy_tokenize)
    jbuild.save_score_bundle(str(tmp_path), "llava", jax_tiny_cfg(), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pregistry.get_score_model("llava-v1.5-7b", checkpoint=str(tmp_path),
                                  tokenize=toy_tokenize)


def _body(module):
    """A module's source after its docstring."""
    src = inspect.getsource(module)
    return src[src.index('"""', 3) + 3:]


def test_benchmark_copies_equal_the_jax_modules():
    assert _body(pbench) == _body(jbench)
    assert _body(ptau) == _body(jtau)
    assert sorted(pbench.BENCHMARKS) == sorted(jbench.BENCHMARKS)


def _png(path, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)
                    ).save(path)


def _write_winoground(root, n):
    rows = []
    for i in range(n):
        for s in (0, 1):
            _png(os.path.join(root, "images", f"ex_{i}_img_{s}.png"),
                 2 * i + s)
        rows.append({"image_0": f"ex_{i}_img_0", "image_1": f"ex_{i}_img_1",
                     "caption_0": f"caption zero {i}",
                     "caption_1": f"caption one {i}"})
    with open(os.path.join(root, "examples.jsonl"), "w") as fh:
        fh.write("\n".join(json.dumps(r) for r in rows))


@pytest.mark.parametrize("name", ["winoground", "sugarcrepe", "seetrue",
                                  "genai_bench"])
def test_benchmark_metrics_match_jax(tmp_path, name):
    root = str(tmp_path)
    if name == "winoground":
        _write_winoground(root, 4)
    elif name == "sugarcrepe":
        data = {str(i): {"filename": f"{i}.jpg", "caption": f"real {i}",
                         "negative_caption": f"fake {i}"} for i in range(5)}
        for split in ("swap_obj", "add_att"):
            with open(os.path.join(root, f"{split}.json"), "w") as fh:
                json.dump(data, fh)
    elif name == "seetrue":
        rows = [{"image": f"{i}.jpg", "text": f"t {i}", "label": i % 2,
                 "source": "coco" if i < 3 else "drawbench"}
                for i in range(6)]
        with open(os.path.join(root, "seetrue.json"), "w") as fh:
            json.dump(rows, fh)
    else:
        meta = {f"{i:05d}": {"image": f"{i}.jpg", "prompt": f"p {i}",
                             "human_alignment": [1 + i % 5, 2 + i % 3]}
                for i in range(8)}
        with open(os.path.join(root, "metadata.json"), "w") as fh:
            json.dump(meta, fh)
    ours = pbench.get_benchmark(name, root)
    theirs = jbench.get_benchmark(name, root)
    assert ours.samples == theirs.samples and len(ours) > 0
    shape = (len(ours), len(ours[0]["images"]), len(ours[0]["texts"]))
    scores = np.random.default_rng(3).random(shape).astype(np.float32)
    assert ours.evaluate_scores(scores) == theirs.evaluate_scores(scores)


def test_benchmark_download_is_gated(tmp_path, monkeypatch):
    monkeypatch.delenv("CLIP_EMBEDS_ALLOW_DOWNLOAD", raising=False)
    with pytest.raises(RuntimeError, match="disabled"):
        pbench.download_benchmark("winoground", str(tmp_path / "w"))
    with pytest.raises(KeyError):
        pbench.download_benchmark("not-a-benchmark", str(tmp_path / "x"))


@pytest.fixture(scope="module")
def clip_checkpoint(tmp_path_factory):
    _, params = jax_create_model("test-tiny", seed=5)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save(state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
               path)
    return str(path)


def test_t2v_eval_clip_route_matches_jax(tmp_path, clip_checkpoint):
    """Both CLIs on one Winoground fixture with the same test-tiny
    weights: the same metrics; a dataset with no data is skipped."""
    _write_winoground(str(tmp_path), 3)
    argv = ["--model", "test-tiny", "--pretrained", clip_checkpoint,
            "--root_dir", str(tmp_path), "--datasets", "winoground",
            "tifa160_dsg", "--precision", "fp32", "--batch_size", "4"]
    assert t2v_main(argv + ["--device", "cpu", "--output",
                            str(tmp_path / "ours.json")]) == 0
    assert jax_t2v_main(argv + ["--output", str(tmp_path / "jax.json")]) == 0
    with open(tmp_path / "ours.json") as a, open(tmp_path / "jax.json") as b:
        ours, theirs = json.load(a), json.load(b)
    assert set(ours) == {"winoground"} and ours == theirs


def test_t2v_eval_runs_on_the_card_unless_asked(tmp_path, clip_checkpoint,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t2v_main(["--model", "test-tiny", "--pretrained", clip_checkpoint,
                  "--root_dir", str(tmp_path), "--datasets", "winoground"])
