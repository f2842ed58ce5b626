"""The port's CLIP-FlanT5 (``models/clip_t5.py``) and its VQAScore
(``scores/vqa_score.py T5VQAScorer``, ``scores/score.py T5VQAScore``)
against the JAX package's on the CPU at a tiny size (a 2-layer 32-px
tower of width 64 tapped at layer -2, ``t5_tiny_config``'s trunk, a toy
word tokenizer): ``__call__`` and ``forward_with_features``, the prompt
formats, the three scorer paths and their feature reuse, the W8A8 trunk's
params and scores, an HF-layout state dict through both converters, and
score bundles both ways (fp32, bf16, ``quant=True``). fp32 tolerance
1e-5; the W8A8 scores 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core import torch_convert as jconvert
from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.models import clip_t5 as jclip_t5
from clip_embeds_tpu.models import t5 as jt5
from clip_embeds_tpu.models.llava import IMAGE_TOKEN_INDEX
from clip_embeds_tpu.models.quant import quantize_clip_t5_trunk as jquantize
from clip_embeds_tpu.scores import build as jbuild
from clip_embeds_tpu.scores import registry as jregistry
from clip_embeds_tpu.scores import vqa_score as jvqa

from clip_embeds_tpu_torch.core.convert import (
    clip_t5_state_dict_from_jax_params,
    convert_clip_t5_state_dict,
    jax_params_from_module,
)
from clip_embeds_tpu_torch.models import clip_t5 as pclip_t5
from clip_embeds_tpu_torch.models.quant import quantize_clip_t5_trunk
from clip_embeds_tpu_torch.scores import build as pbuild
from clip_embeds_tpu_torch.scores import registry as pregistry
from clip_embeds_tpu_torch.scores import vqa_score as pvqa

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(batch_size=2, pad_to_multiple=8)


def jinit(model, *args, seed=0, method=None):
    """flax ``model.init`` under jit (one compile, not one per op)."""
    return jax.jit(lambda r: model.init(r, *args, method=method))(
        jax.random.PRNGKey(seed))["params"]


def japply(model, params, *args, method=None):
    """flax ``model.apply`` under jit, as numpy."""
    out = jax.jit(lambda p, *a: model.apply({"params": p}, *a,
                                            method=method))(
        params, *map(jnp.asarray, args))
    return jax.tree.map(np.asarray, out)


def toy_tokenize(text):
    return [2 + (sum(map(ord, w)) % 200) for w in text.split()]


def jax_tiny_cfg():
    return jclip_t5.CLIPT5Config(
        t5=jt5.t5_tiny_config(),
        vision=JVisionConfig(image_size=32, patch_size=16, width=64,
                             layers=2, head_width=32),
    )


def port_cfg(jcfg=None):
    return pbuild.config_from_dict(
        pclip_t5.CLIPT5Config, jbuild.config_to_dict(jcfg or jax_tiny_cfg()))


def port_model(params, quant=""):
    cfg = port_cfg()
    model = pclip_t5.CLIPT5(cfg, quant_t5=quant).eval()
    model.load_state_dict(clip_t5_state_dict_from_jax_params(params, cfg))
    return model


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, the port's model) on the same weights, every
    float moved off its init value."""
    model = jclip_t5.CLIPT5(jax_tiny_cfg(), attn_impl="reference")
    ids = np.full((1, 8), 7, np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    params = jinit(model, jnp.asarray(ids),
                   jnp.zeros((1, 32, 32, 3), jnp.float32),
                   jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax.device_get(params))
    return model, params, port_model(params)


def _image(seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (3, 10)).astype(np.int32)
    ids[:, 3] = IMAGE_TOKEN_INDEX
    mask = np.ones((3, 10), bool)
    mask[1, 7:] = False
    labels = rng.integers(1, 256, (3, 4)).astype(np.int32)
    labels[2, 2:] = -100
    dec_mask = labels != -100
    pixels = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    return ids, pixels, labels, mask, dec_mask


def _t(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)


def test_forward_and_features_match_jax(tiny):
    model, params, port = tiny
    args = _batch()
    want = japply(model, params, *args)
    with torch.no_grad():
        got = port(*map(_t, args)).numpy()
        feats = port.encode_images(_t(args[1]))
        got_feats = port.forward_with_features(
            _t(args[0]), feats, *map(_t, args[2:])).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got_feats, got)
    jfeats = japply(model, params, args[1], method="encode_images")
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **TOL)
    assert feats.shape[1] == port.cfg.n_image_tokens
    assert len(port.vision_tower.transformer.resblocks) == \
        port.cfg.tower_blocks


@pytest.mark.parametrize("style", ["t5_plain", "t5_chat", "t5_chat_no_system",
                                   "t5_chat_no_system_no_user"])
def test_prompts_match_jax(style):
    q = jvqa.DEFAULT_QUESTION_TEMPLATE.format("a cat")
    assert pvqa.format_question_t5(q, style) == \
        jvqa.format_question_t5(q, style)
    prompt = pvqa.format_question_t5(q, style)
    assert pvqa.t5_tokenizer_image_token(prompt, toy_tokenize) == \
        jvqa.t5_tokenizer_image_token(prompt, toy_tokenize)


def _scorers(model, params, port, **kw):
    return (pvqa.T5VQAScorer(port, toy_tokenize, device="cpu", **SMALL, **kw),
            jvqa.T5VQAScorer(model, params, toy_tokenize, **SMALL, **kw))


@pytest.fixture(scope="module")
def scorers(tiny):
    """The port's and JAX's scorers on ``tiny``, built once (JAX compiles
    each shape once for the three path cases)."""
    return _scorers(*tiny)


@pytest.mark.parametrize("path", ["forward", "forward_image_texts",
                                  "forward_groups"])
def test_t5_scorer_paths_match_jax(scorers, path):
    ours, theirs = scorers
    texts = ["a cat on a mat", "a dog", "two red boxes to the left"]
    images = [_image(1), _image(2), _image(3)]
    args = {"forward": (images, texts),
            "forward_image_texts": (images[0], texts),
            "forward_groups": (images[:2], [texts, texts[::-1]])}[path]
    got, want = getattr(ours, path)(*args), getattr(theirs, path)(*args)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all() and (got > 0).all() and (got <= 1).all()


def test_feature_reuse_equals_pair_path(scorers):
    ours, _ = scorers
    images, texts = [_image(4), _image(5)], ["a cat", "a dog on a bed"]
    pair = np.stack([ours.forward([im] * 2, texts) for im in images])
    np.testing.assert_allclose(ours.forward_groups(images, [texts] * 2),
                               pair, **TOL)
    np.testing.assert_allclose(ours.forward_image_texts(images[1], texts),
                               pair[1], **TOL)


def test_w8a8_trunk_matches_jax(tiny):
    """quantize_clip_t5_trunk's codes and scales equal JAX's
    quantize_clip_t5_trunk's (432 projections at XXL depth: 7 an encoder
    layer, 11 a decoder layer), and the dynamic W8A8 scorer JAX's within
    1e-4."""
    model, params, port = tiny
    qport = quantize_clip_t5_trunk(port)
    want = jquantize(params)["t5"]
    back = jax_params_from_module(qport)["t5"]
    n = {"encoder": 0, "decoder": 0}
    for stack in n:
        for i in range(2):
            blk = back[stack][f"block_{i}"]
            for part in ("self_attn", "cross_attn", "ff"):
                for name, node in blk.get(part, {}).items():
                    if "kernel_q" not in node:
                        continue
                    ref = want[stack][f"block_{i}"][part][name]
                    np.testing.assert_array_equal(node["kernel_q"],
                                                  np.asarray(ref["kernel_q"]))
                    np.testing.assert_array_equal(node["scale"],
                                                  np.asarray(ref["scale"]))
                    n[stack] += 1
    assert n == {"encoder": 2 * 7, "decoder": 2 * 11}
    qmodel = jclip_t5.CLIPT5(jax_tiny_cfg(), attn_impl="reference",
                             quant_t5="dynamic")
    ours, theirs = _scorers(qmodel, jquantize(params), qport)
    images, texts = [_image(6), _image(7)], ["a cat", "a dog"]
    np.testing.assert_allclose(ours.forward_groups(images, [texts] * 2),
                               theirs.forward_groups(images, [texts] * 2),
                               rtol=1e-4, atol=1e-4)


def test_hf_state_dict_matches_jax_convert():
    """A random clip-flant5 state dict in the reference's layout (an HF
    CLIPVisionModel under ``vision_tower.vision_tower``, ``mm_projector.
    {0,2}``, plain T5 keys): the port's converter gives JAX's tree, and
    the port's model JAX's logits."""
    pytest.importorskip("transformers")
    from transformers import CLIPVisionConfig, CLIPVisionModel
    from transformers import T5Config as HFConfig
    from transformers import T5ForConditionalGeneration as HFT5

    torch.manual_seed(1)
    vision = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=16))
    t5 = HFT5(HFConfig(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                       num_layers=2, num_heads=4, tie_word_embeddings=False,
                       feed_forward_proj="gated-gelu"))
    sd = {f"vision_tower.vision_tower.{k}": v
          for k, v in vision.state_dict().items()}
    sd.update(t5.state_dict())
    for i, (a, b) in ((0, (64, 64)), (2, (64, 64))):
        sd[f"mm_projector.{i}.weight"] = 0.1 * torch.randn(b, a)
        sd[f"mm_projector.{i}.bias"] = 0.1 * torch.randn(b)
    ours = convert_clip_t5_state_dict(sd)
    theirs = jconvert.convert_clip_t5_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, ours, theirs)
    jcfg = dataclasses.replace(jax_tiny_cfg(), vision_quick_gelu=False)
    model = jclip_t5.CLIPT5(jcfg, attn_impl="reference")
    cfg = port_cfg(jcfg)
    port = pclip_t5.CLIPT5(cfg).eval()
    port.load_state_dict(clip_t5_state_dict_from_jax_params(ours, cfg))
    args = _batch(2)
    with torch.no_grad():
        got = port(*map(_t, args)).numpy()
    want = japply(model, theirs, *args)
    # HF's T5 init draws lm_head at std 1: logits reach |30|
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_jax_bundle_loads_in_the_port(tiny, tmp_path, quant):
    _, params, _ = tiny
    jbuild.save_score_bundle(str(tmp_path), "clip_t5", jax_tiny_cfg(),
                             params, conversation="t5_chat")
    kw = dict(checkpoint=str(tmp_path), tokenize=toy_tokenize, batch_size=2,
              **({"quant": True} if quant else {}))
    ours = pregistry.get_score_model("clip-flant5-xxl", device="cpu", **kw)
    theirs = jregistry.get_score_model("clip-flant5-xxl", **kw)
    images, texts = [_image(9), _image(10)], ["a cat", "a dog", "red box"]
    np.testing.assert_allclose(ours(images, texts), theirs(images, texts),
                               rtol=1e-4 if quant else 1e-5,
                               atol=1e-4 if quant else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_bundle_int8_trunk_is_quantised_from_fp32(tiny, tmp_path, dtype):
    """quant=True quantises the T5 trunk from the bundle's fp32 weights in
    any serving dtype: the codes and scales equal JAX's, the rest of the
    model is in ``dtype``."""
    _, params, _ = tiny
    jbuild.save_score_bundle(str(tmp_path), "clip_t5", jax_tiny_cfg(),
                             params)
    score = pregistry.get_score_model(
        "clip-flant5-xl", checkpoint=str(tmp_path), tokenize=toy_tokenize,
        device="cpu", dtype=dtype, quant=True)
    model = score.pair_forward.__self__.model
    want = jquantize(params)["t5"]
    lin = model.t5.decoder.block[1].cross_attn.k
    node = want["decoder"]["block_1"]["cross_attn"]["k"]
    np.testing.assert_array_equal(lin.weight_q.numpy(),
                                  np.asarray(node["kernel_q"]).T)
    np.testing.assert_array_equal(lin.scale.numpy(), np.asarray(node["scale"]))
    assert lin.scale.dtype == torch.float32
    assert model.t5.shared.weight.dtype == dtype
    assert model.multi_modal_projector.linear_1.weight.dtype == dtype
    out = score([_image(11)], ["a cat", "a dog"])
    assert np.isfinite(out).all() and (out > 0).all()


def test_port_bundle_loads_in_jax(tiny, tmp_path):
    _, _, port = tiny
    pbuild.save_score_bundle(str(tmp_path), "clip_t5", port.cfg,
                             jax_params_from_module(port),
                             conversation="t5_chat_no_system")
    kw = dict(checkpoint=str(tmp_path), tokenize=toy_tokenize, batch_size=2)
    theirs = jregistry.get_score_model("clip-flant5-xxl-no-system", **kw)
    ours = pregistry.get_score_model("clip-flant5-xxl-no-system",
                                     device="cpu", **kw)
    images, texts = [_image(12)], ["a cat", "a dog"]
    np.testing.assert_allclose(ours(images, texts), theirs(images, texts),
                               **TOL)


def test_scoring_needs_the_card_unless_asked(tiny, tmp_path, monkeypatch):
    """The scorer and the registry place the model on the card by
    default, and raise without one, for every item-13 family."""
    _, params, port = tiny
    jbuild.save_score_bundle(str(tmp_path), "clip_t5", jax_tiny_cfg(),
                             params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pvqa.T5VQAScorer(port, toy_tokenize)
    for name in ("clip-flant5-xxl", "instructblip-flant5-xl", "blip2-itm",
                 "blip2-itc", "image-reward-v1"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pregistry.get_score_model(name, checkpoint=str(tmp_path),
                                      tokenize=toy_tokenize)
