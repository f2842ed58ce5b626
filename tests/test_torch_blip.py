"""The port's BLIP family against the JAX package's on the CPU at a tiny
size (2-layer 32-px towers, a 2-layer Q-Former of width 48 with 4 queries,
``t5_tiny_config``-width trunks, a toy word tokenizer): BLIP-2's
``itm_logits`` / ``itc_embeds`` / ``itc_logits`` and its ITM and ITC
scores, InstructBLIP-FlanT5's logits and its scorer's two paths (with the
EVA-g cache) and W8A8 trunk, ImageReward and its score, and HF-layout state
dicts through the port's and JAX's converters (transformers' BLIP-2 and
InstructBLIP; ImageReward's THUDM keys written out by hand). fp32
tolerance 1e-5, W8A8 1e-4."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core import torch_convert as jconvert
from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.models import blip as jblip
from clip_embeds_tpu.models import blip2 as jblip2
from clip_embeds_tpu.models import instructblip as jib
from clip_embeds_tpu.models import t5 as jt5
from clip_embeds_tpu.models.quant import quantize_clip_t5_trunk as jquantize
from clip_embeds_tpu.scores import build as jbuild
from clip_embeds_tpu.scores import registry as jregistry
from clip_embeds_tpu.scores import vqa_score as jvqa

from clip_embeds_tpu_torch.core import convert as pconvert
from clip_embeds_tpu_torch.models import blip as pblip
from clip_embeds_tpu_torch.models import blip2 as pblip2
from clip_embeds_tpu_torch.models import instructblip as pib
from clip_embeds_tpu_torch.models.quant import quantize_clip_t5_trunk
from clip_embeds_tpu_torch.scores import build as pbuild
from clip_embeds_tpu_torch.scores import registry as pregistry
from clip_embeds_tpu_torch.scores import vqa_score as pvqa

TOL = dict(rtol=1e-5, atol=1e-5)


def jinit(model, *args, seed=0, method=None):
    """flax ``model.init`` under jit (one compile, not one per op)."""
    return jax.jit(lambda r: model.init(r, *args, method=method))(
        jax.random.PRNGKey(seed))["params"]


_APPLY = {}


def japply(model, params, *args, method=None):
    """flax ``model.apply`` under jit, as numpy: one jitted function a
    (model, method), so that a shape compiles once in this module."""
    key = (id(model), method)
    if key not in _APPLY:
        _APPLY[key] = model, jax.jit(
            lambda p, *a: model.apply({"params": p}, *a, method=method))
    out = _APPLY[key][1](params, *map(jnp.asarray, args))
    return jax.tree.map(np.asarray, out)


def toy_tokenize(text):
    return [2 + (sum(map(ord, w)) % 90) for w in text.split()]


def _vision(width=64, head_width=16):
    return JVisionConfig(image_size=32, patch_size=16, width=width,
                         layers=2, head_width=head_width, mlp_ratio=2.0)


def _qformer():
    return jblip2.QFormerConfig(vocab_size=100, hidden_size=48, num_layers=2,
                                num_heads=4, intermediate_size=96,
                                encoder_hidden_size=64)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax.device_get(params))


_CONFIGS = {pblip2.Blip2ITM: pblip2.Blip2Config,
            pib.InstructBlipT5: pib.InstructBlipConfig,
            pblip.ImageReward: pblip.BlipConfig}


def _port(cls, jcfg, params, **kw):
    cfg = pbuild.config_from_dict(_CONFIGS[cls], jbuild.config_to_dict(jcfg))
    model = cls(cfg, **kw).eval()
    model.load_state_dict(pconvert.state_dict_from_flax(params))
    return model


def _image(seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8))


def _t(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)


def _text_batch(seed, b=3, n=7, vocab=100):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, vocab, (b, n)).astype(np.int32)
    mask = np.ones((b, n), bool)
    mask[1, 4:] = False
    return pixels, ids, mask


# -- BLIP-2 -------------------------------------------------------------------


def blip2_cfg():
    return jblip2.Blip2Config(vision=_vision(), qformer=_qformer(),
                              num_query_tokens=4, image_text_hidden_size=16)


@pytest.fixture(scope="module")
def blip2():
    model = jblip2.Blip2ITM(blip2_cfg(), attn_impl="reference")
    px, ids = jnp.zeros((1, 32, 32, 3)), jnp.ones((1, 5), jnp.int32)
    params = jinit(model, px, ids, method=lambda m, p, i:
                   (m.itm_logits(p, i), m.itc_embeds(p, i)))
    params = _perturbed(params, 0)
    return model, params, _port(pblip2.Blip2ITM, blip2_cfg(), params)


def test_blip2_heads_match_jax(blip2):
    model, params, port = blip2
    args = _text_batch(1)
    for method in ("itm_logits", "itc_embeds", "itc_logits"):
        want = japply(model, params, *args, method=method)
        with torch.no_grad():
            got = getattr(port, method)(*map(_t, args))
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g.numpy(), np.asarray(w), **TOL), got, want)
    with torch.no_grad():  # the image side alone, then the text side alone
        img, _ = port.itc_embeds(_t(args[0]))
        _, txt = port.itc_embeds(None, _t(args[1]), _t(args[2]))
    assert img.shape == (3, 4, 16) and txt.shape == (3, 16)


@pytest.mark.parametrize("name", ["blip2-itm", "blip2-itc-coco"])
def test_blip2_scores_match_jax(blip2, tmp_path, name):
    _, params, _ = blip2
    jbuild.save_score_bundle(str(tmp_path), "blip2", blip2_cfg(), params)
    kw = dict(checkpoint=str(tmp_path), tokenize=toy_tokenize, batch_size=2)
    ours = pregistry.get_score_model(name, device="cpu", **kw)
    theirs = jregistry.get_score_model(name, **kw)
    images, texts = [_image(1), _image(2)], ["a cat", "a dog on a mat", "x"]
    got = ours(images, texts)
    np.testing.assert_allclose(got, theirs(images, texts), **TOL)
    assert got.shape == (2, 3) and (np.abs(got) <= 1).all()


@pytest.mark.parametrize("name", ["blip2-itm", "blip2-itc"])
def test_blip2_bundle_needs_the_head_its_name_reads(blip2, tmp_path, name):
    """A bundle without the head that the name reads (ITM: ``itm_head``;
    ITC: the two projections) raises; one without only the other head
    scores as the whole bundle does."""
    _, params, _ = blip2
    itm_head = ("itm_head",)
    projections = ("vision_projection", "text_projection")
    reads, other = ((itm_head, projections) if name == "blip2-itm"
                    else (projections, itm_head))
    kw = dict(tokenize=toy_tokenize, batch_size=2)
    images, texts = [_image(1)], ["a cat", "a dog"]

    def bundle(drop, sub):
        path = str(tmp_path / sub)
        jbuild.save_score_bundle(path, "blip2", blip2_cfg(), {
            k: v for k, v in params.items() if k not in drop})
        return path

    with pytest.raises(RuntimeError, match="Missing key"):
        pregistry.get_score_model(name, checkpoint=bundle(reads, "reads"),
                                  device="cpu", **kw)
    whole = pregistry.get_score_model(name, checkpoint=bundle((), "whole"),
                                      device="cpu", **kw)
    part = pregistry.get_score_model(name, checkpoint=bundle(other, "other"),
                                     device="cpu", **kw)
    np.testing.assert_array_equal(part(images, texts), whole(images, texts))


def test_blip2_hf_state_dict_matches_jax_convert(blip2):
    """A random HF ``Blip2ForImageTextRetrieval``: the port's converter
    gives JAX's tree and the port's model JAX's ITM logits; a state dict
    holding the qkv biases apart raises."""
    pytest.importorskip("transformers")
    from transformers import Blip2Config as HFConfig
    from transformers import (
        Blip2ForImageTextRetrieval,
        Blip2QFormerConfig,
        Blip2VisionConfig,
    )

    cfg = HFConfig(
        vision_config=Blip2VisionConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, image_size=32, patch_size=16).to_dict(),
        qformer_config=Blip2QFormerConfig(
            hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, encoder_hidden_size=64, vocab_size=100,
            cross_attention_frequency=2, use_qformer_text_input=True,
        ).to_dict(),
        num_query_tokens=4, image_text_hidden_size=16)
    torch.manual_seed(0)
    hf = Blip2ForImageTextRetrieval(cfg).eval()
    with torch.no_grad():
        hf.query_tokens.normal_(0, 0.5)
    sd = hf.state_dict()
    ours = pconvert.convert_blip2_state_dict(sd)
    theirs = jconvert.convert_blip2_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, ours, theirs)
    port = _port(pblip2.Blip2ITM, blip2_cfg(), ours)
    model = blip2[0]
    args = _text_batch(2)
    want = japply(model, theirs, *args, method="itm_logits")
    with torch.no_grad():
        got = port.itm_logits(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    split = {k: v for k, v in sd.items() if not k.endswith("qkv.bias")}
    split["vision_model.encoder.layers.0.self_attn.q_bias"] = torch.zeros(64)
    with pytest.raises(ValueError, match="q_bias"):
        pconvert.convert_blip2_state_dict(split)


# -- InstructBLIP-FlanT5 ------------------------------------------------------


def ib_cfg():
    return jib.InstructBlipConfig(
        vision=_vision(), qformer=_qformer(),
        t5=jt5.T5Config(vocab_size=256, d_model=48, d_kv=12, d_ff=96,
                        num_layers=2, num_heads=4),
        num_query_tokens=4)


def _ib_batch(seed):
    rng = np.random.default_rng(seed)
    b = 2
    pixels = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    q_ids = rng.integers(1, 100, (b, 6)).astype(np.int32)
    t_ids = rng.integers(1, 256, (b, 7)).astype(np.int32)
    labels = rng.integers(1, 256, (b, 3)).astype(np.int32)
    labels[1, 2] = -100
    q_mask = np.ones((b, 6), bool)
    q_mask[1, -2:] = False
    t_mask = np.ones((b, 7), bool)
    t_mask[0, -3:] = False
    return pixels, q_ids, t_ids, labels, q_mask, t_mask, labels != -100


@pytest.fixture(scope="module")
def ib():
    model = jib.InstructBlipT5(ib_cfg(), attn_impl="reference")
    args = _ib_batch(0)
    params = _perturbed(jinit(model, *map(jnp.asarray, args), seed=1), 1)
    return model, params, _port(pib.InstructBlipT5, ib_cfg(), params)


def test_instructblip_logits_match_jax(ib):
    model, params, port = ib
    args = _ib_batch(2)
    want = japply(model, params, *args)
    with torch.no_grad():
        got = port(*map(_t, args))
        again = port.forward_with_vision(port.encode_vision(_t(args[0])),
                                         *map(_t, args[1:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


IB_KW = dict(batch_size=2, pad_to_multiple=8)
IB_TEXTS = ["a cat", "a dog on a red mat", "two boxes"]


@pytest.fixture(scope="module")
def ib_scorers(ib):
    """The port's and JAX's InstructBLIP scorers on ``ib``'s weights, fp32
    and W8A8 (the port's trunk quantised from fp32, JAX's tree by
    ``quantize_clip_t5_trunk``), built once: the scorer and bundle cases
    share JAX's compiles."""
    model, params, port = ib
    qmodel = jib.InstructBlipT5(ib_cfg(), attn_impl="reference",
                                quant_t5="dynamic")
    qparams, qport = jquantize(params), quantize_clip_t5_trunk(port)
    return {quant: (pvqa.InstructBlipVQAScorer(p, toy_tokenize, toy_tokenize,
                                                device="cpu", **IB_KW),
                    jvqa.InstructBlipVQAScorer(m, tree, toy_tokenize,
                                               toy_tokenize, **IB_KW), tree)
            for quant, m, tree, p in ((False, model, params, port),
                                      (True, qmodel, qparams, qport))}


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_instructblip_scorer_matches_jax(ib_scorers, quant):
    ours, theirs, _ = ib_scorers[quant]
    tol = dict(rtol=1e-4, atol=1e-4) if quant else TOL
    texts = IB_TEXTS
    images = [_image(3), _image(4), _image(5)]
    pair = ours.forward(images, texts)
    if not quant:  # the W8A8 pair path: against the cached path below
        np.testing.assert_allclose(pair, theirs.forward(images, texts), **tol)
    cached = ours.forward_image_texts(images[0], texts)
    np.testing.assert_allclose(cached,
                               theirs.forward_image_texts(images[0], texts),
                               **tol)
    np.testing.assert_allclose(cached, ours.forward([images[0]] * 3, texts),
                               **TOL)
    assert np.isfinite(pair).all() and (pair > 0).all()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_instructblip_bundle_matches_jax(ib, ib_scorers, tmp_path, quant):
    """The port's bundle: JAX reads it back to the config and weights
    (``quant``: the fp32 weights it quantises) that its scorer holds, and
    the port's registry scorer on it gives that scorer's m x n scores."""
    _, params, port = ib
    pbuild.save_score_bundle(str(tmp_path), "instructblip", port.cfg,
                             pconvert.jax_params_from_module(port))
    meta, tree = jbuild.load_score_bundle(str(tmp_path))
    assert jbuild.config_from_dict(jib.InstructBlipConfig,
                                   meta["model"]) == ib_cfg()
    jax.tree.map(np.testing.assert_array_equal, tree, params)
    kw = dict(checkpoint=str(tmp_path), tokenize=toy_tokenize,
              qformer_tokenize=toy_tokenize, batch_size=2,
              **({"quant": True} if quant else {}))
    ours = pregistry.get_score_model("instructblip-flant5-xxl", device="cpu",
                                     **kw)
    theirs = ib_scorers[quant][1]
    images = [_image(3), _image(6)]
    want = np.stack([theirs.forward_image_texts(im, IB_TEXTS)
                     for im in images])
    np.testing.assert_allclose(ours(images, IB_TEXTS), want,
                               rtol=1e-4 if quant else 1e-5,
                               atol=1e-4 if quant else 1e-5)


def test_instructblip_hf_state_dict_matches_jax_convert(ib):
    pytest.importorskip("transformers")
    from transformers import InstructBlipConfig as HFConfig
    from transformers import (
        InstructBlipForConditionalGeneration,
        InstructBlipQFormerConfig,
        InstructBlipVisionConfig,
    )
    from transformers import T5Config as HFT5Config

    cfg = HFConfig(
        vision_config=InstructBlipVisionConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, image_size=32, patch_size=16).to_dict(),
        qformer_config=InstructBlipQFormerConfig(
            hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, encoder_hidden_size=64, vocab_size=100,
            cross_attention_frequency=2).to_dict(),
        text_config=HFT5Config(
            vocab_size=256, d_model=48, d_kv=12, d_ff=96, num_layers=2,
            num_heads=4, tie_word_embeddings=False,
            feed_forward_proj="gated-gelu").to_dict(),
        num_query_tokens=4, image_token_index=255)
    torch.manual_seed(1)
    hf = InstructBlipForConditionalGeneration(cfg).eval()
    sd = hf.state_dict()
    ours = pconvert.convert_instructblip_state_dict(sd)
    theirs = jconvert.convert_instructblip_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, ours, theirs)
    port = _port(pib.InstructBlipT5, ib_cfg(), ours)
    model = ib[0]
    args = _ib_batch(3)
    want = japply(model, theirs, *args)
    with torch.no_grad():
        got = port(*map(_t, args)).numpy()
    # HF's T5 init draws lm_head at std 1: logits reach |20|
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)


# -- ImageReward --------------------------------------------------------------


def ir_cfg():
    return jblip.BlipConfig(
        vision=_vision(48, 24),
        text=jblip.BlipTextConfig(vocab_size=100, hidden_size=32,
                                  num_layers=2, num_heads=2,
                                  intermediate_size=64,
                                  max_position_embeddings=64))


@pytest.fixture(scope="module")
def image_reward():
    model = jblip.ImageReward(ir_cfg(), attn_impl="reference")
    args = _text_batch(0)
    params = _perturbed(jinit(model, *map(jnp.asarray, args), seed=2), 2)
    return model, params, _port(pblip.ImageReward, ir_cfg(), params)


def test_image_reward_matches_jax(image_reward, tmp_path):
    model, params, port = image_reward
    args = _text_batch(4)
    want = japply(model, params, *args)
    with torch.no_grad():
        got = port(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pbuild.save_score_bundle(str(tmp_path), "image_reward", port.cfg,
                             pconvert.jax_params_from_module(port))
    kw = dict(checkpoint=str(tmp_path), tokenize=toy_tokenize, batch_size=2)
    ours = pregistry.get_score_model("image-reward-v1", device="cpu", **kw)
    theirs = jregistry.get_score_model("image-reward-v1", **kw)
    images, texts = [_image(8), _image(9)], ["a cat", "a dog", "a red box"]
    np.testing.assert_allclose(ours(images, texts), theirs(images, texts),
                               **TOL)


def _thudm_state_dict(seed):
    """Random ImageReward weights under THUDM's keys (timm ViT under
    ``blip.visual_encoder``, med BertModel under ``blip.text_encoder``,
    the MLP under ``mlp.layers``), at ``ir_cfg``'s widths."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(key, i, o):
        sd[key + ".weight"] = 0.1 * torch.randn(o, i, generator=g)
        sd[key + ".bias"] = 0.1 * torch.randn(o, generator=g)

    def ln(key, w):
        sd[key + ".weight"] = 1 + 0.1 * torch.randn(w, generator=g)
        sd[key + ".bias"] = 0.1 * torch.randn(w, generator=g)

    v, t = "blip.visual_encoder.", "blip.text_encoder."
    sd[v + "patch_embed.proj.weight"] = 0.1 * torch.randn(48, 3, 16, 16,
                                                          generator=g)
    sd[v + "patch_embed.proj.bias"] = 0.1 * torch.randn(48, generator=g)
    sd[v + "cls_token"] = 0.1 * torch.randn(1, 1, 48, generator=g)
    sd[v + "pos_embed"] = 0.1 * torch.randn(1, 5, 48, generator=g)
    for i in range(2):
        b = f"{v}blocks.{i}."
        ln(b + "norm1", 48)
        ln(b + "norm2", 48)
        lin(b + "attn.qkv", 48, 144)
        lin(b + "attn.proj", 48, 48)
        lin(b + "mlp.fc1", 48, 96)
        lin(b + "mlp.fc2", 96, 48)
    ln(v + "norm", 48)
    sd[t + "embeddings.word_embeddings.weight"] = torch.randn(100, 32,
                                                              generator=g)
    sd[t + "embeddings.position_embeddings.weight"] = torch.randn(
        64, 32, generator=g)
    ln(t + "embeddings.LayerNorm", 32)
    for i in range(2):
        b = f"{t}encoder.layer.{i}."
        for a, kv in (("attention", 32), ("crossattention", 48)):
            lin(b + a + ".self.query", 32, 32)
            lin(b + a + ".self.key", kv, 32)
            lin(b + a + ".self.value", kv, 32)
            lin(b + a + ".output.dense", 32, 32)
            ln(b + a + ".output.LayerNorm", 32)
        lin(b + "intermediate.dense", 32, 64)
        lin(b + "output.dense", 64, 32)
        ln(b + "output.LayerNorm", 32)
    dims = (32,) + pblip.REWARD_DIMS
    for idx, (a, o) in zip((0, 2, 4, 6, 7), zip(dims[:-1], dims[1:])):
        lin(f"mlp.layers.{idx}", a, o)
    return sd


def test_image_reward_thudm_state_dict_matches_jax_convert(image_reward):
    model, _, _ = image_reward
    sd = _thudm_state_dict(5)
    ours = pconvert.convert_image_reward_state_dict(sd)
    theirs = jblip.convert_image_reward_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, ours, theirs)
    port = _port(pblip.ImageReward, ir_cfg(), ours)
    args = _text_batch(6)
    want = japply(model, theirs, *args)
    with torch.no_grad():
        got = port(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
