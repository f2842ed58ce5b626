"""The zoo vision towers of the port against the JAX package, fp32 on the
CPU: ModifiedResNet, EVA01, EVA02 (SwiGLU / rope and post-norm), the timm
gap ViT, the rel-pos ViT, MCi-ViT, Swin, ViTamin, FastViT and ConvNeXt
(linear and MLP heads), each inside a CLIP with a one-layer text tower.

One numpy-seeded open_clip state dict (the port's own key layout, which is
open_clip's; timm's unfolded training layout for FastViT and MCi-ViT's
stem) loads into the port with ``load_state_dict`` and goes to JAX through
its converters (``convert_clip_state_dict(sd, vision_tower=...)``;
``convert_convnext_tower`` for ConvNeXt, which it does not dispatch). JAX
runs at ``attn_impl="reference"``. Pooled features and tokens, the
L2-normalised image and text features within 1e-4, the stored
``logit_scale`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu_torch.core.convert import load_open_clip_state_dict
from clip_embeds_tpu_torch.core.factory import init_params
from clip_embeds_tpu_torch.models.clip import CLIP
from torch_zoo_fixtures import (  # noqa: F401 - fixture
    one_torch_thread,
    TOL,
    TOWERS,
    inputs,
    jax_config_of,
    jax_params,
    open_clip_state_dict,
    seeded_state_dict,
    tiny_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_zoo_tower_matches_jax(kind):
    cfg = tiny_config(kind)
    model = CLIP(cfg).eval()
    sd = open_clip_state_dict(kind, model)
    load_open_clip_state_dict(model, dict(sd))
    images, ids = inputs(cfg)
    with torch.no_grad():
        pooled, tokens = model.encode_image(torch.from_numpy(images),
                                            output_tokens=True)
        out = model(torch.from_numpy(images), torch.from_numpy(ids))
    jmodel = JaxCLIP(jax_config_of(cfg), attn_impl="reference")
    params = jax_params(kind, cfg, sd)
    jpooled, jtokens = jmodel.apply({"params": params}, jnp.asarray(images),
                                    output_tokens=True, method="encode_image")
    jout = jmodel.apply({"params": params}, jnp.asarray(images),
                        jnp.asarray(ids))
    assert pooled.shape == jpooled.shape and tokens.shape == jtokens.shape
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jtokens),
                               rtol=TOL, atol=TOL)
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   atol=TOL)
    # the stored temperature is equal; its exp rounds apart by an ulp
    assert model.logit_scale.item() == float(params["logit_scale"])
    np.testing.assert_allclose(float(out["logit_scale"]),
                               float(jout["logit_scale"]), rtol=1e-6)


def test_eva01_keeps_the_timm_layout_both_ways():
    """EVA01's blocks are the composable Transformer (#4 on the card), but
    its state dict is timm's: q_bias / v_bias and no k bias, and a fused
    qkv.bias loads too."""
    model = CLIP(tiny_config("eva"))
    sd = seeded_state_dict(model)
    assert "visual.trunk.blocks.1.attn.q_bias" in sd
    assert not any("resblocks" in k for k in sd if k.startswith("visual."))
    load_open_clip_state_dict(model, dict(sd))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    fused = dict(sd)
    for i in range(2):
        pre = f"visual.trunk.blocks.{i}.attn."
        q, v = fused.pop(pre + "q_bias"), fused.pop(pre + "v_bias")
        fused[pre + "qkv.bias"] = torch.cat([q, torch.zeros_like(q), v])
    other = CLIP(tiny_config("eva"))
    load_open_clip_state_dict(other, fused)
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_custom_text_checkpoint_keys_load():
    """An open_clip CustomTextCLIP checkpoint (EVA, ViTamin) keeps the text
    tower under ``text.``; it loads into the port's CLIP as the same
    weights."""
    model = CLIP(tiny_config("vitamin"))
    sd = seeded_state_dict(model)
    moved = {("text." + k if not k.startswith(("visual.", "logit_"))
              else k): v for k, v in sd.items()}
    load_open_clip_state_dict(model, moved)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("kind", ["resnet", "eva02-post", "fastvit", "swin"])
def test_seeded_zoo_init_is_finite_and_distinct(kind):
    """``init_params`` draws every zoo tower from the seed: finite
    features, the same for one seed, other ones for another."""
    feats = []
    for seed in (0, 0, 1):
        model = CLIP(tiny_config(kind)).eval()
        init_params(model, seed)
        images, _ = inputs(model.cfg)
        with torch.no_grad():
            feats.append(model.encode_image(torch.from_numpy(images)))
    assert torch.isfinite(feats[0]).all()
    assert torch.equal(feats[0], feats[1])
    assert not torch.allclose(feats[0], feats[2])


@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_create_model_builds_every_tower_kind(monkeypatch, kind):
    """``create_model`` of a name whose config has the tower: seeded,
    finite unit features of the embed width, eval mode."""
    from clip_embeds_tpu_torch.core import config as port_config
    from clip_embeds_tpu_torch.core.factory import create_model

    monkeypatch.setitem(port_config.MODEL_CONFIGS, f"tiny-{kind}",
                        tiny_config(kind))
    model = create_model(f"tiny-{kind}", seed=0)
    assert not model.training and model.cfg.vision.tower == \
        TOWERS[kind]["tower"]
    images, ids = inputs(model.cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(ids))
    for key in ("image_features", "text_features"):
        assert out[key].shape == (2, 32) and torch.isfinite(out[key]).all()
        np.testing.assert_allclose(out[key].norm(dim=-1).numpy(), 1.0,
                                   rtol=1e-5)


def test_eva01_blocks_take_the_attention_dispatch(monkeypatch):
    """EVA01's blocks are the composable Transformer's: every block calls
    ``ops.attention.dot_product_attention`` (the flash kernel on the card
    in bf16), unmasked; EVA02's einsum attention does not."""
    from clip_embeds_tpu_torch.models import layers

    calls = []
    real = layers.dot_product_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), kw.get("mask")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(layers, "dot_product_attention", counted)
    for kind, want in (("eva", 2), ("eva02-swiglu", 0)):
        calls.clear()
        model = CLIP(tiny_config(kind)).eval()
        images, _ = inputs(model.cfg)
        with torch.no_grad():
            model.encode_image(torch.from_numpy(images))
        assert len(calls) == want, kind
        assert all(mask is None and shape == (2, 4, 5, 16)
                   for shape, mask in calls)
