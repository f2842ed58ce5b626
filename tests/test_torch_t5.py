"""The port's T5 (``clip_embeds_tpu_torch/models/t5.py``) against the JAX
package's on the CPU at a tiny size (``t5_tiny_config``: 2 + 2 layers of
width 64, 4 heads of 16): the relative-position buckets (exactly equal),
``shift_right``, the logits with encoder padding, the decoder's
causality, the tied and ReLU variants, the W8A8 trunk, and an HF-layout
state dict through the port's and JAX's converters. fp32 throughout;
tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core import torch_convert as jconvert
from clip_embeds_tpu.models import t5 as jt5
from clip_embeds_tpu.models.quant import (
    T5_QUANT_LAYER_NAMES as J_T5_QUANT,
    quantize_dense_tree,
)

from clip_embeds_tpu_torch.core.convert import (
    convert_t5_state_dict,
    jax_params_from_module,
    state_dict_from_flax,
)
from clip_embeds_tpu_torch.models import t5 as pt5
from clip_embeds_tpu_torch.models.quant import T5_QUANT_LAYER_NAMES
from clip_embeds_tpu_torch.scores.build import config_from_dict, config_to_dict

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


def _inputs(seed=0, b=3, n=9, t=5, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, n)).astype(np.int32)
    mask = np.ones((b, n), bool)
    mask[1, 6:] = False
    mask[2, 3:] = False
    dec = rng.integers(1, vocab, (b, t)).astype(np.int32)
    dec_mask = np.ones((b, t), bool)
    dec_mask[2, 3:] = False
    return ids, mask, dec, dec_mask


def _jax_logits(model, params, ids, mask, dec, dec_mask):
    return japply(model, params, ids, dec, mask, dec_mask)


def _port(cfg, params, quant=""):
    pcfg = config_from_dict(pt5.T5Config, config_to_dict(cfg))
    model = pt5.T5ForConditionalGeneration(pcfg, quant).eval()
    model.load_state_dict(state_dict_from_flax(params))
    return model


def _port_logits(model, ids, mask, dec, dec_mask):
    t = lambda a: torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        return model(t(ids), t(dec), t(mask), t(dec_mask)).numpy()


def _jax_init(cfg, seed=0):
    """flax-initialised params, every float moved off its init value."""
    model = jt5.T5ForConditionalGeneration(cfg)
    ids, mask, dec, dec_mask = _inputs()
    params = jinit(model, *map(jnp.asarray, (ids, dec, mask, dec_mask)),
                   seed=seed)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax.device_get(params))
    return model, params


@pytest.fixture(scope="module")
def tiny():
    return _jax_init(jt5.t5_tiny_config())


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["encoder", "decoder"])
def test_relative_position_bucket_matches_jax(bidirectional):
    cfg = jt5.T5Config()
    r = np.arange(-2048, 2049)
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(r), bidirectional, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance))
    got = pt5.relative_position_bucket(
        torch.from_numpy(r), bidirectional,
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    table = pt5.bucket_table(5, 7, bidirectional, 32, 128).numpy()
    offsets = np.arange(7)[None, :] - np.arange(5)[:, None]
    np.testing.assert_array_equal(table, np.asarray(
        jt5.relative_position_bucket(jnp.asarray(offsets), bidirectional,
                                     32, 128)))


def test_shift_right_matches_jax():
    labels = np.array([[5, 6, -100, -100], [7, -100, 8, 9]], np.int32)
    want = np.asarray(jt5.shift_right(jnp.asarray(labels), 3, 1))
    got = pt5.shift_right(torch.from_numpy(labels).long(), 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_t5_logits_match_jax(tiny):
    model, params = tiny
    port = _port(jt5.t5_tiny_config(), params)
    args = _inputs(1)
    np.testing.assert_allclose(_port_logits(port, *args),
                               _jax_logits(model, params, *args), **TOL)


def test_decoder_is_causal_and_padding_is_ignored(tiny):
    """A later decoder token moves no earlier logit; a padded encoder
    position's id moves nothing."""
    _, params = tiny
    port = _port(jt5.t5_tiny_config(), params)
    ids, mask, dec, dec_mask = _inputs(2)
    base = _port_logits(port, ids, mask, dec, dec_mask)
    dec2 = dec.copy()
    dec2[:, 3] = (dec2[:, 3] + 1) % 256
    moved = _port_logits(port, ids, mask, dec2, dec_mask)
    np.testing.assert_array_equal(moved[:, :3], base[:, :3])
    assert np.abs(moved[:, 3:] - base[:, 3:]).max() > 1e-3
    ids2 = ids.copy()
    ids2[1, 7] = (ids2[1, 7] + 5) % 256  # padded in row 1
    np.testing.assert_allclose(
        _port_logits(port, ids2, mask, dec, dec_mask)[1], base[1], **TOL)


@pytest.mark.parametrize("variant", ["tied", "relu"])
def test_t5_variants_match_jax(variant):
    import dataclasses

    cfg = dataclasses.replace(
        jt5.t5_tiny_config(), tie_word_embeddings=variant == "tied",
        feed_forward_proj="relu" if variant == "relu" else "gated-gelu",
        num_decoder_layers=3)
    model, params = _jax_init(cfg, seed=3)
    port = _port(cfg, params)
    args = _inputs(4)
    np.testing.assert_allclose(_port_logits(port, *args),
                               _jax_logits(model, params, *args), **TOL)


def test_w8a8_trunk_matches_jax(tiny):
    """The JAX quantised tree through the port's loader, against JAX's
    dynamic QuantDense trunk: logits within 1e-4 (the int8 sums are exact;
    the activation scale's rounding moves a code only on a .5 tie)."""
    _, params = tiny
    assert T5_QUANT_LAYER_NAMES == J_T5_QUANT
    qparams = quantize_dense_tree(params, J_T5_QUANT)
    qmodel = jt5.T5ForConditionalGeneration(jt5.t5_tiny_config(),
                                            quant="dynamic")
    port = _port(jt5.t5_tiny_config(), qparams, quant="dynamic")
    args = _inputs(5)
    np.testing.assert_allclose(_port_logits(port, *args),
                               _jax_logits(qmodel, qparams, *args),
                               rtol=1e-4, atol=1e-4)
    n = sum(1 for name, _ in port.named_modules()
            if name.split(".")[-1] in T5_QUANT_LAYER_NAMES)
    assert n == 2 * 7 + 2 * 11  # encoder 7 a layer, decoder 11
    back = jax_params_from_module(port)
    np.testing.assert_array_equal(
        back["encoder"]["block_1"]["ff"]["wo"]["kernel_q"],
        np.asarray(qparams["encoder"]["block_1"]["ff"]["wo"]["kernel_q"]))


def test_hf_state_dict_matches_jax_convert(tiny):
    """A random HF ``T5ForConditionalGeneration`` state dict: the port's
    converter gives JAX's tree, and the port's model JAX's logits."""
    pytest.importorskip("transformers")
    from transformers import T5Config as HFConfig
    from transformers import T5ForConditionalGeneration as HFT5

    model, _ = tiny
    torch.manual_seed(0)
    hf = HFT5(HFConfig(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                       num_layers=2, num_heads=4, tie_word_embeddings=False,
                       feed_forward_proj="gated-gelu")).eval()
    sd = hf.state_dict()
    ours, theirs = convert_t5_state_dict(sd), jconvert.convert_t5_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, ours, theirs)
    port = _port(jt5.t5_tiny_config(), ours)
    args = _inputs(6)
    want = _jax_logits(model, theirs, *args)
    # HF's init draws lm_head at std 1, so the logits reach |25|: 1e-4
    # absolute is 4e-6 of them
    np.testing.assert_allclose(_port_logits(port, *args), want, rtol=1e-5,
                               atol=1e-4)
