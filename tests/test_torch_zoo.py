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

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core.torch_convert import (
    _layernorm,
    _np,
    _transformer,
    convert_clip_state_dict,
)
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu_torch.core.config import (
    CLIPConfig,
    TextConfig,
    VisionConfig,
)
from clip_embeds_tpu_torch.core.convert import load_open_clip_state_dict
from clip_embeds_tpu_torch.core.factory import init_params
from clip_embeds_tpu_torch.models.clip import CLIP

TOL = 1e-4

TOWERS = {
    "resnet": dict(tower="resnet", image_size=64, width=16,
                   resnet_layers=(1, 1, 2, 1)),
    "eva": dict(tower="eva", image_size=32, patch_size=16, width=64,
                layers=2, head_width=16, mlp_ratio=2.0),
    "eva02-swiglu": dict(tower="eva02", image_size=48, patch_size=16,
                         width=64, layers=2, head_width=16, mlp_ratio=8 / 3,
                         eva_rope=True, eva_swiglu=True,
                         eva_attn_inner_norm=True,
                         eva_ref_feat_shape=(16, 16)),
    "eva02-post": dict(tower="eva02", image_size=32, patch_size=16,
                       width=64, layers=2, head_width=16, mlp_ratio=2.0,
                       eva_post_norm=True),
    "timm-vit": dict(tower="timm-vit", image_size=32, patch_size=16,
                     width=64, layers=2, head_width=16, pool_type="avg",
                     final_ln_after_pool=True),
    "relpos-vit": dict(tower="relpos-vit", image_size=48, patch_size=16,
                       width=64, layers=2, head_width=16),
    "mci-vit": dict(tower="mci-vit", image_size=64, patch_size=16, width=64,
                    layers=2, head_width=16),
    "swin": dict(tower="swin", image_size=64, patch_size=4, width=16,
                 swin_depths=(2, 2, 2, 2), swin_heads=(2, 2, 4, 4),
                 swin_window=2),
    "vitamin": dict(tower="vitamin", image_size=64, patch_size=16, width=64,
                    layers=2, head_width=16, mlp_ratio=2.0,
                    vitamin_mbconv_dims=(16, 32),
                    vitamin_mbconv_depths=(1, 2)),
    "fastvit": dict(tower="fastvit", image_size=64, patch_size=32, width=64,
                    fastvit_layers=(1, 2, 1, 1), fastvit_dims=(8, 16, 32, 64),
                    mlp_ratio=3.0),
    "convnext-linear": dict(tower="convnext", image_size=64, width=16,
                            convnext_depths=(1, 1, 2, 1),
                            convnext_dims=(16, 32, 64, 128)),
    "convnext-mlp": dict(tower="convnext", image_size=64, width=16,
                         convnext_depths=(1, 1, 2, 1),
                         convnext_dims=(16, 32, 64, 128), head_proj="mlp"),
}
TEXT = dict(context_length=16, width=32, heads=2, layers=1)


def tiny_config(kind: str) -> CLIPConfig:
    return CLIPConfig(embed_dim=32, vision=VisionConfig(**TOWERS[kind]),
                      text=TextConfig(**TEXT))


def jax_config_of(cfg: CLIPConfig):
    return jax_config.CLIPConfig(
        embed_dim=cfg.embed_dim, quick_gelu=cfg.quick_gelu,
        vision=jax_config.VisionConfig(**dataclasses.asdict(cfg.vision)),
        text=jax_config.TextConfig(**dataclasses.asdict(cfg.text)))


def _value(rng, key: str, shape) -> np.ndarray:
    """Seeded values for one entry: norms near one (BatchNorm variances in
    [0.5, 1.5]), matrices and kernels at fan-in^-1/2, the rest at 0.1."""
    if key.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if len(shape) == 1 and key.endswith("weight"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if len(shape) >= 2 and key.endswith("weight"):
        return rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
    return 0.1 * rng.standard_normal(shape)


def seeded_state_dict(model: torch.nn.Module, seed: int = 0):
    """Every float entry of ``model.state_dict()`` (open_clip's layout)
    drawn from numpy; integer buffers as they are."""
    rng = np.random.default_rng(seed)
    return {k: (torch.from_numpy(np.asarray(_value(
                rng, k, tuple(v.shape)), np.float32))
                if v.is_floating_point() else v.clone())
            for k, v in model.state_dict().items()}


def _mobileone(sd, rng, pre, cin, cout, k, groups, stride):
    """timm's training-layout MobileOneBlock: a kxk conv + BN, a 1x1 scale
    conv + BN where k > 1, and an identity BN where the shape allows."""
    put = _put_fn(sd, rng)
    put(f"{pre}.conv_kxk.0.conv.weight", (cout, cin // groups, k, k))
    put_bn(sd, rng, f"{pre}.conv_kxk.0.bn", cout)
    if k > 1:
        put(f"{pre}.conv_scale.conv.weight", (cout, cin // groups, 1, 1))
        put_bn(sd, rng, f"{pre}.conv_scale.bn", cout)
    if cin == cout and stride == 1:
        put_bn(sd, rng, f"{pre}.identity", cout)


def _put_fn(sd, rng):
    def put(key, shape):
        sd[key] = torch.from_numpy(_value(rng, key, shape).astype(np.float32))
    return put


def put_bn(sd, rng, pre, c):
    put = _put_fn(sd, rng)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        put(f"{pre}.{leaf}", (c,))


def fastvit_train_layout(model: CLIP, seed: int = 0):
    """The port model's text tower and logit scale, and a FastViT trunk in
    timm's unfolded training layout (MobileOne branches with BatchNorms,
    layer scales, the attention pre-BN, RepCPE, SE), as an open_clip
    MobileCLIP-S checkpoint holds it."""
    from clip_embeds_tpu_torch.models.fastvit import SE_RD_RATIO

    rng = np.random.default_rng(seed)
    sd = {k: v for k, v in seeded_state_dict(model, seed).items()
          if not k.startswith("visual.")}
    cfg = model.visual.cfg
    put = _put_fn(sd, rng)
    t = "visual.trunk"
    d0 = cfg.dims[0]
    for i, (ci, co, k, g, s) in enumerate(((3, d0, 3, 1, 2),
                                           (d0, d0, 3, d0, 2),
                                           (d0, d0, 1, 1, 1))):
        _mobileone(sd, rng, f"{t}.stem.{i}", ci, co, k, g, s)

    def se(pre, c):
        rd = max(1, int(c * SE_RD_RATIO))
        put(f"{pre}.fc1.weight", (rd, c, 1, 1))
        put(f"{pre}.fc1.bias", (rd,))
        put(f"{pre}.fc2.weight", (c, rd, 1, 1))
        put(f"{pre}.fc2.bias", (c,))

    for si, (depth, dim) in enumerate(zip(cfg.layers, cfg.dims)):
        sp = f"{t}.stages.{si}"
        if si > 0:
            lk = f"{sp}.downsample.proj.0"
            put(f"{lk}.large_conv.conv.weight", (dim, 1, 7, 7))
            put_bn(sd, rng, f"{lk}.large_conv.bn", dim)
            put(f"{lk}.small_conv.conv.weight", (dim, 1, 3, 3))
            put_bn(sd, rng, f"{lk}.small_conv.bn", dim)
            if cfg.se_downsamples[si]:
                se(f"{lk}.se", dim)
            _mobileone(sd, rng, f"{sp}.downsample.proj.1", dim, dim, 1, 1, 1)
        if si in cfg.pos_embed_stages:
            put(f"{sp}.pos_emb.pos_enc.weight", (dim, 1, 7, 7))
            put(f"{sp}.pos_emb.pos_enc.bias", (dim,))
        hidden = int(dim * cfg.mlp_ratio)
        for bi in range(depth):
            bp = f"{sp}.blocks.{bi}"
            if cfg.token_mixers[si] == "attention":
                put_bn(sd, rng, f"{bp}.norm", dim)
                put(f"{bp}.token_mixer.qkv.weight", (3 * dim, dim))
                put(f"{bp}.token_mixer.proj.weight", (dim, dim))
                put(f"{bp}.token_mixer.proj.bias", (dim,))
                put(f"{bp}.layer_scale_1.gamma", (dim, 1, 1))
                put(f"{bp}.layer_scale_2.gamma", (dim, 1, 1))
            else:
                mix = f"{bp}.token_mixer"
                _mobileone(sd, rng, f"{mix}.mixer", dim, dim, 3, dim, 1)
                put_bn(sd, rng, f"{mix}.norm.identity", dim)
                put(f"{mix}.layer_scale.gamma", (dim, 1, 1))
                put(f"{bp}.layer_scale.gamma", (dim, 1, 1))
            put(f"{bp}.mlp.conv.conv.weight", (dim, 1, 7, 7))
            put_bn(sd, rng, f"{bp}.mlp.conv.bn", dim)
            put(f"{bp}.mlp.fc1.weight", (hidden, dim, 1, 1))
            put(f"{bp}.mlp.fc1.bias", (hidden,))
            put(f"{bp}.mlp.fc2.weight", (dim, hidden, 1, 1))
            put(f"{bp}.mlp.fc2.bias", (dim,))
    _mobileone(sd, rng, f"{t}.final_conv", cfg.dims[-1], cfg.final_dim, 3,
               cfg.dims[-1], 1)
    se(f"{t}.final_conv.se", cfg.final_dim)
    put(f"{t}.head.fc.weight", (cfg.embed_dim, cfg.final_dim))
    put(f"{t}.head.fc.bias", (cfg.embed_dim,))
    return sd


def open_clip_state_dict(kind: str, model: CLIP):
    if kind == "fastvit":
        return fastvit_train_layout(model)
    sd = seeded_state_dict(model)
    if kind == "mci-vit":  # timm's stem: conv (no bias) + BatchNorm
        rng = np.random.default_rng(1)
        for i in range(2):
            pre = f"visual.trunk.patch_embed.backbone.{i}"
            c = sd.pop(f"{pre}.conv.bias").shape[0]
            put_bn(sd, rng, f"{pre}.bn", c)
            sd[f"{pre}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def jax_params(kind: str, cfg: CLIPConfig, sd):
    sdn = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    if cfg.vision.tower != "convnext":
        return convert_clip_state_dict(sdn, vision_tower=cfg.vision.tower)
    from clip_embeds_tpu.models.convnext import (
        ConvNeXtConfig,
        convert_convnext_tower,
    )

    v = cfg.vision
    visual = convert_convnext_tower(sdn, ConvNeXtConfig(
        depths=v.convnext_depths, dims=v.convnext_dims,
        embed_dim=cfg.embed_dim, proj=v.head_proj, image_size=v.image_size))
    text = {"token_embedding": {
                "embedding": _np(sdn["token_embedding.weight"])},
            "positional_embedding": _np(sdn["positional_embedding"]),
            "transformer": _transformer(sdn, "transformer", cfg.text.layers),
            "ln_final": _layernorm(sdn, "ln_final"),
            "text_projection": _np(sdn["text_projection"])}
    return {"visual": visual, "text": text,
            "logit_scale": _np(sdn["logit_scale"]).reshape(())}


def inputs(cfg: CLIPConfig, seed: int = 0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.standard_normal((2, s, s, 3)).astype(np.float32)
    ids = rng.integers(1, 1000, (2, cfg.text.context_length))
    ids[:, 5] = 49407  # EOT: the argmax pool's position
    return images, ids.astype(np.int32)


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
