"""The port's CLIP towers and serving paths against the JAX package, on the
same weights (JAX params -> open_clip state dict) and numpy inputs, fp32 on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core.factory import create_model as jax_create_model
from clip_embeds_tpu.models.serving import (
    fused_encode_image as jax_fused_encode_image,
)
from clip_embeds_tpu_torch.core.convert import (
    load_open_clip_state_dict,
    state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.models.serving import (
    fused_encode_image,
    fused_encode_text,
    fused_path_available,
)


def _pair(name, quick, seed=1):
    """(jax model, jax params, port model) sharing one set of weights."""
    tag = "openai" if quick else None
    jm, jp = jax_create_model(name, pretrained=tag, seed=seed,
                              attn_impl="reference")
    jp = jax.tree.map(np.asarray, jp)
    tm = create_model(name, pretrained=tag)
    load_open_clip_state_dict(tm, state_dict_from_jax_params(jp))
    assert tm.cfg.quick_gelu is quick
    return jm, jp, tm


def _inputs(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.standard_normal((batch, s, s, 3)).astype(np.float32)
    ids = rng.integers(1, 49406, (batch, cfg.text.context_length))
    for row, length in zip(ids, rng.integers(3, 20, batch)):
        row[0], row[length - 1], row[length:] = 49406, 49407, 0
    return images, ids.astype(np.int32)


@pytest.mark.parametrize("quick", [False, True])
def test_towers_match_jax(quick):
    jm, jp, tm = _pair("test-tiny", quick)
    images, ids = _inputs(tm.cfg, 3)
    want_img = jm.apply({"params": jp}, jnp.asarray(images), normalize=True,
                        method="encode_image")
    want_txt = jm.apply({"params": jp}, jnp.asarray(ids), normalize=True,
                        method="encode_text")
    want_logits, _ = jm.apply({"params": jp}, jnp.asarray(images),
                              jnp.asarray(ids), method="get_logits")
    with torch.no_grad():
        got_img = tm.encode_image(torch.from_numpy(images), normalize=True)
        got_txt = tm.encode_text(torch.from_numpy(ids).long(),
                                 normalize=True)
        got_logits, _ = tm.get_logits(torch.from_numpy(images),
                                      torch.from_numpy(ids).long())
        out = tm(torch.from_numpy(images), torch.from_numpy(ids).long())
    # fp32 both sides: summation order only
    for got, want in ((got_img, want_img), (got_txt, want_txt),
                      (out["image_features"], want_img),
                      (out["text_features"], want_txt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)


def test_vitl_width_towers_match_jax():
    """ViT-L/14-336 widths (577 tokens, width 1024, 16 heads), 2 layers."""
    jm, jp, tm = _pair("test-vitl-2layer", quick=True)
    images, ids = _inputs(tm.cfg, 1)
    want_img = jm.apply({"params": jp}, jnp.asarray(images), normalize=True,
                        method="encode_image")
    want_txt = jm.apply({"params": jp}, jnp.asarray(ids), normalize=True,
                        method="encode_text")
    with torch.no_grad():
        got_img = tm.encode_image(torch.from_numpy(images), normalize=True)
        got_txt = tm.encode_text(torch.from_numpy(ids).long(),
                                 normalize=True)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt),
                               rtol=1e-4, atol=1e-5)


def test_hidden_layer_tap_matches_jax():
    """VisionTransformer(hidden_layer=-2): the Transformer num_blocks tap."""
    jm, jp, tm = _pair("test-tiny", quick=True)
    images, _ = _inputs(tm.cfg, 2)
    want = jm.apply({"params": jp}, jnp.asarray(images),
                    method=lambda m, x: m.visual(x, hidden_layer=-2))
    with torch.no_grad():
        got = tm.visual(torch.from_numpy(images), hidden_layer=-2)
    assert got.shape == (2, tm.cfg.vision.num_patches + 1,
                         tm.cfg.vision.width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_output_tokens_shapes():
    _, _, tm = _pair("test-tiny", quick=False)
    images, _ = _inputs(tm.cfg, 2)
    cfg = tm.cfg
    with torch.no_grad():
        pooled, tokens = tm.encode_image(torch.from_numpy(images),
                                         output_tokens=True)
        f_pooled, f_tokens = fused_encode_image(
            tm, torch.from_numpy(images), normalize=False,
            dtype=torch.float32, output_tokens=True)
        t_pooled, t_tokens = tm.encode_text(
            torch.zeros(2, cfg.text.context_length, dtype=torch.long),
            output_tokens=True)
    assert pooled.shape == f_pooled.shape == (2, cfg.embed_dim)
    assert tokens.shape == f_tokens.shape == (2, cfg.vision.num_patches,
                                              cfg.vision.width)
    assert t_pooled.shape == (2, cfg.embed_dim)
    assert t_tokens.shape == (2, cfg.text.context_length, cfg.text.width)
    torch.testing.assert_close(f_tokens, tokens, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f_pooled, pooled, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cls_fast_last", [True, False])
@pytest.mark.parametrize("quick", [False, True])
def test_fused_encode_image_matches_jax(quick, cls_fast_last):
    jm, jp, tm = _pair("test-tiny", quick, seed=3)
    images, _ = _inputs(tm.cfg, 2)
    want = jax_fused_encode_image(jm, jp, jnp.asarray(images),
                                  dtype=jnp.float32, interpret=True,
                                  cls_fast_last=cls_fast_last)
    with torch.no_grad():
        got = fused_encode_image(tm, torch.from_numpy(images),
                                 dtype=torch.float32,
                                 cls_fast_last=cls_fast_last)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quick", [False, True])
def test_fused_encode_text_matches_jax(quick):
    jm, jp, tm = _pair("test-tiny", quick, seed=4)
    _, ids = _inputs(tm.cfg, 3)
    want = jm.apply({"params": jp}, jnp.asarray(ids), normalize=True,
                    method="encode_text")
    with torch.no_grad():
        got = fused_encode_text(tm, torch.from_numpy(ids).long(),
                                dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_fused_path_available():
    from clip_embeds_tpu_torch.core.config import get_model_config
    from clip_embeds_tpu_torch.models.clip import CLIP

    assert fused_path_available(
        CLIP(get_model_config("test-vitl-2layer", pretrained="openai")))
    assert fused_path_available(CLIP(get_model_config("test-tiny")))


def test_seeded_init_is_deterministic():
    a = create_model("test-tiny", seed=7)
    b = create_model("test-tiny", seed=7)
    c = create_model("test-tiny", seed=8)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.visual.proj, c.visual.proj)


@pytest.mark.parametrize("name,pretrained", [
    ("test-tiny", None), ("test-tiny", "openai"), ("test-pacl-tiny", None)])
def test_factory_build_skips_only_the_overwritten_default_init(name,
                                                              pretrained):
    """create_model builds without PyTorch's default init: the same values
    as a default-initialised CLIP given the seeded init (LayerNorms at
    ones / zeros, the logit scale from the config)."""
    from clip_embeds_tpu_torch.core.config import get_model_config
    from clip_embeds_tpu_torch.core.factory import init_params
    from clip_embeds_tpu_torch.models.clip import CLIP

    want = CLIP(get_model_config(name, pretrained))
    init_params(want, seed=3)
    got = create_model(name, pretrained, seed=3)
    assert got.state_dict().keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
