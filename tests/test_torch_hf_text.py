"""The HF text towers (BERT / RoBERTa, T5 / mT5, M2M100 / NLLB), the
CustomTextCLIP assembly (ViT and SigLIP vision) and LLM2CLIP of the port
against the JAX package, fp32 on the CPU at tiny widths.

One numpy-seeded state dict in open_clip's layout (HF's encoder keys under
``text.transformer.``) loads into the port with ``load_state_dict`` and
goes to JAX through its converters: ``convert_t5_state_dict``,
``convert_m2m100_encoder_state_dict``, the key-for-key BERT mapping below,
and ``convert_llm2clip_state_dict`` for LLM2CLIP's HF layout. Features
within 1e-4; the registry's nine hf-text names resolve to JAX's configs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core import openclip_registry as jax_registry
from clip_embeds_tpu.core.torch_convert import convert_t5_state_dict
from clip_embeds_tpu.models import custom_text_clip as jax_ctc
from clip_embeds_tpu.models import llm2clip as jax_llm2clip
from clip_embeds_tpu.models.hf_text import convert_m2m100_encoder_state_dict
from clip_embeds_tpu.models.siglip import SiglipVisionConfig as JaxSiglipV
from clip_embeds_tpu_torch.core.config import VisionConfig
from clip_embeds_tpu_torch.core.convert import jax_params_from_module
from clip_embeds_tpu_torch.models import custom_text_clip as port_ctc
from clip_embeds_tpu_torch.models import llm2clip as port_llm2clip
from clip_embeds_tpu_torch.models.siglip import SiglipVisionConfig

TOL = 1e-4
TINY_TEXT = {
    "tiny/bert": dict(kind="bert", vocab_size=96, hidden_size=32,
                      num_layers=2, num_heads=4, intermediate_size=64,
                      max_position_embeddings=40),
    "tiny/t5": dict(kind="t5", vocab_size=96, d_model=32, d_kv=8, d_ff=64,
                    num_layers=2, num_heads=4),
    "tiny/m2m": dict(kind="m2m100", vocab_size=96, d_model=32, num_layers=2,
                     num_heads=4, ffn_dim=64, max_position_embeddings=40),
}
VISION = dict(image_size=32, patch_size=16, width=32, layers=2,
              head_width=16)
SIGLIP = dict(image_size=32, patch_size=16, width=48, layers=2, heads=2,
              intermediate_size=96)


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, shape in TINY_TEXT.items():
        monkeypatch.setitem(jax_ctc.HF_TEXT_SHAPES, name, shape)
        monkeypatch.setitem(port_ctc.HF_TEXT_SHAPES, name, shape)


def _value(rng, key, shape):
    if len(shape) == 1 and (key.endswith("weight") and "embed" not in key):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if len(shape) >= 2:
        return rng.standard_normal(shape) * (
            0.5 if "embed" in key else np.prod(shape[1:]) ** -0.5)
    return 0.1 * rng.standard_normal(shape)


def seeded(model, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(np.asarray(_value(rng, k, tuple(v.shape)),
                                           np.float32))
            for k, v in model.state_dict().items()}


def _np(t):
    return t.detach().float().numpy()


def _dense(sd, key, bias=True):
    out = {"kernel": _np(sd[key + ".weight"]).T}
    if bias:
        out["bias"] = _np(sd[key + ".bias"])
    return out


def _ln(sd, key):
    return {"scale": _np(sd[key + ".weight"]), "bias": _np(sd[key + ".bias"])}


def jax_bert_params(sd, layers, p="text.transformer"):
    """open_clip's BERT text tower -> JAX's BertTextTower tree (the HF key
    of each flax leaf)."""
    out = {"word_embeddings": {"embedding": _np(
               sd[f"{p}.embeddings.word_embeddings.weight"])},
           "position_embeddings": {"embedding": _np(
               sd[f"{p}.embeddings.position_embeddings.weight"])},
           "embed_ln": _ln(sd, f"{p}.embeddings.LayerNorm")}
    for i in range(layers):
        lp = f"{p}.encoder.layer.{i}"
        out[f"layer_{i}_attention"] = {
            "query": _dense(sd, f"{lp}.attention.self.query"),
            "key": _dense(sd, f"{lp}.attention.self.key"),
            "value": _dense(sd, f"{lp}.attention.self.value"),
            "out_dense": _dense(sd, f"{lp}.attention.output.dense"),
            "out_ln": _ln(sd, f"{lp}.attention.output.LayerNorm")}
        out[f"layer_{i}_ffn"] = {
            "intermediate": _dense(sd, f"{lp}.intermediate.dense"),
            "output": _dense(sd, f"{lp}.output.dense"),
            "ln": _ln(sd, f"{lp}.output.LayerNorm")}
    return out


def jax_text_params(kind, sd, shape):
    p = "text.transformer."
    hf = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    if kind == "bert":
        out = jax_bert_params(sd, shape["num_layers"])
    elif kind == "t5":
        t5 = {"shared.weight": hf["embed_tokens.weight"],
              "decoder.final_layer_norm.weight": torch.ones(1)}
        t5.update({"encoder." + k: v for k, v in hf.items()
                   if k != "embed_tokens.weight"})
        params = convert_t5_state_dict(t5)
        out = {"shared": params["shared"], "encoder": params["encoder"]}
    else:
        from clip_embeds_tpu.models.hf_text import M2M100Config

        cfg = M2M100Config(**{k: v for k, v in shape.items()
                              if k != "kind"})
        out = convert_m2m100_encoder_state_dict(
            {"encoder." + k: v for k, v in hf.items()}, cfg)
        out["proj"] = _dense(sd, "text.proj", bias=False)
        return out
    out["proj"] = {"fc1": _dense(sd, "text.proj.0", bias=False),
                   "fc2": _dense(sd, "text.proj.2", bias=False)}
    return out


def text_inputs(kind, n=2, length=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 96, (n, length)).astype(np.int32)
    mask = np.ones((n, length), np.int32)
    mask[1, 6:] = 0
    if kind == "m2m":
        ids[mask == 0] = 1  # NLLB's pad id
    return ids, mask


CASES = [("tiny/bert", "mean", None), ("tiny/t5", "mean", None),
         ("tiny/m2m", "first", None), ("tiny/m2m", "first", "siglip")]


@pytest.mark.parametrize("hf,pooler,vision", CASES,
                         ids=["bert", "t5", "m2m100", "m2m100-siglip"])
def test_custom_text_clip_matches_jax(tiny_shapes, hf, pooler, vision):
    kind = TINY_TEXT[hf]["kind"]
    bias = -10.0 if vision else None
    cfg = port_ctc.CustomTextCLIPConfig(
        embed_dim=48, vision=VisionConfig(**VISION), hf_model_name=hf,
        pooler=pooler, init_logit_bias=bias,
        siglip_vision=SiglipVisionConfig(**SIGLIP) if vision else None)
    model = port_ctc.CustomTextCLIP(cfg).eval()
    sd = seeded(model)
    model.load_state_dict(sd)
    jcfg = jax_ctc.CustomTextCLIPConfig(
        embed_dim=48, vision=jax_config.VisionConfig(**VISION),
        hf_model_name=hf, pooler=pooler, init_logit_bias=bias,
        siglip_vision=JaxSiglipV(**SIGLIP) if vision else None)
    visual = jax_params_from_module(model.visual)
    if vision:  # the MAP head's packed projection is a flax kernel
        head = visual["head"]
        head["in_proj_kernel"] = head.pop("in_proj_weight").T
    params = {"visual": visual,
              "text": jax_text_params(kind, sd, TINY_TEXT[hf]),
              "logit_scale": _np(sd["logit_scale"])}
    if bias is not None:
        params["logit_bias"] = _np(sd["logit_bias"])
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids, mask = text_inputs(hf.split("/")[1])
    jm = jax_ctc.CustomTextCLIP(jcfg, attn_impl="reference")
    want = jm.apply({"params": params}, jnp.asarray(images),
                    jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(ids).long(),
                    torch.from_numpy(mask))
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL)
    if bias is not None:
        assert got["logit_bias"].item() == float(want["logit_bias"])
    np.testing.assert_allclose(got["logit_scale"].item(),
                               float(want["logit_scale"]), rtol=1e-6)


def test_t5_tower_keeps_hf_names():
    """open_clip's mT5 tower keys (HF's encoder stack) both ways."""
    model = port_ctc.CustomTextCLIP(port_ctc.CustomTextCLIPConfig(
        embed_dim=48, vision=VisionConfig(**VISION), hf_model_name="x"),
        text_shapes=TINY_TEXT["tiny/t5"])
    sd = seeded(model)
    assert "text.transformer.block.1.layer.1.DenseReluDense.wi_0.weight" \
        in sd and "text.transformer.final_layer_norm.weight" in sd
    assert not any(".stack." in k for k in sd)
    model.load_state_dict(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_registry_hf_text_names_build_as_in_jax():
    """The nine hf-text names resolve to JAX's configs and build (meta
    device: the published widths); coca_roberta-ViT-B-32 stays a CoCa,
    refused as in JAX; a clip name is not hf-text in either package."""
    names = [n for n in jax_registry.list_openclip_models()
             if jax_registry.classify_model(n)[0] == "hf-text"]
    assert len(names) == 9
    for name in names:
        ours = port_ctc.custom_text_config(name)
        theirs = jax_ctc.build_custom_text_clip(name).cfg
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
        with torch.device("meta"):
            model = port_ctc.build_custom_text_clip(name)
        assert model.cfg == ours
    for builder in (port_ctc.build_custom_text_clip,
                    jax_ctc.build_custom_text_clip):
        with pytest.raises(NotImplementedError) as exc:
            builder("ViT-B-32")
    assert "is not an hf-text config" in str(exc.value)
    from clip_embeds_tpu_torch.core import openclip_registry as port_registry

    for reg in (port_registry, jax_registry):
        with pytest.raises(NotImplementedError, match="HF text tower"):
            reg.resolve_coca_config("coca_roberta-ViT-B-32")


# -- LLM2CLIP ----------------------------------------------------------------

def llm2clip_tiny():
    v = dict(image_size=32, patch_size=16, width=32, layers=2, head_width=16)
    kw = dict(embed_dim=24, text_embedding_dim=40, adaptor_layers=2,
              expansion_factor=2)
    return (port_llm2clip.LLM2CLIPConfig(vision=VisionConfig(**v), **kw),
            jax_llm2clip.LLM2CLIPConfig(vision=jax_config.VisionConfig(**v),
                                        **kw))


def hf_llm2clip_state_dict(cfg, seed=0):
    """HF's LLM2CLIP layout: a CLIPVisionModel, ``visual_projection`` and
    the ``text_adapter``."""
    rng = np.random.default_rng(seed)
    v, w = cfg.vision, cfg.vision.width
    p = "vision_model."
    shapes = {p + "embeddings.patch_embedding.weight":
              (w, 3, v.patch_size, v.patch_size),
              p + "embeddings.class_embedding": (w,),
              p + "embeddings.position_embedding.weight":
              (v.num_patches + 1, w)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        shapes.update({f"{p}{ln}.weight": (w,), f"{p}{ln}.bias": (w,)})
    for i in range(v.layers):
        lp = f"{p}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            shapes.update({f"{lp}{ln}.weight": (w,), f"{lp}{ln}.bias": (w,)})
        for x in ("q", "k", "v", "out"):
            shapes.update({f"{lp}self_attn.{x}_proj.weight": (w, w),
                           f"{lp}self_attn.{x}_proj.bias": (w,)})
        shapes.update({f"{lp}mlp.fc1.weight": (4 * w, w),
                       f"{lp}mlp.fc1.bias": (4 * w,),
                       f"{lp}mlp.fc2.weight": (w, 4 * w),
                       f"{lp}mlp.fc2.bias": (w,)})
    shapes["visual_projection.weight"] = (cfg.embed_dim, w)
    d, h = cfg.text_embedding_dim, cfg.text_embedding_dim * 2
    n = cfg.adaptor_layers
    for i in range(n):
        ap = f"text_adapter.adaptor.{i}."
        shapes.update({ap + "ln.weight": (d,), ap + "ln.bias": (d,),
                       ap + "fn.0.weight": (h, d), ap + "fn.0.bias": (h,),
                       ap + "fn.3.weight": (d, h), ap + "fn.3.bias": (d,)})
    shapes.update({f"text_adapter.adaptor.{n}.weight": (d,),
                   f"text_adapter.adaptor.{n}.bias": (d,),
                   f"text_adapter.adaptor.{n + 1}.weight": (cfg.embed_dim, d),
                   f"text_adapter.adaptor.{n + 1}.bias": (cfg.embed_dim,)})
    return {k: torch.from_numpy(np.asarray(_value(rng, k, s), np.float32))
            for k, s in shapes.items()}


def test_llm2clip_matches_jax():
    cfg, jcfg = llm2clip_tiny()
    sd = hf_llm2clip_state_dict(cfg)
    model = port_llm2clip.load_llm2clip_state_dict(
        port_llm2clip.LLM2CLIP(cfg).eval(), sd)
    jm = jax_llm2clip.LLM2CLIP(jcfg, attn_impl="reference")
    params = jax_llm2clip.convert_llm2clip_state_dict(sd)
    rng = np.random.default_rng(2)
    px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    emb = rng.standard_normal((3, 40)).astype(np.float32)
    with torch.no_grad():
        got_i = model.get_image_features(torch.from_numpy(px),
                                         normalize=True)
        got_t = model.get_text_features(torch.from_numpy(emb),
                                        normalize=True)
        got_p = model.image_patches(torch.from_numpy(px))
        got_raw = model.get_text_features(torch.from_numpy(emb))
    want_i = jm.apply({"params": params}, jnp.asarray(px), normalize=True,
                      method="get_image_features")
    want_t = jm.apply({"params": params}, jnp.asarray(emb), normalize=True,
                      method="get_text_features")
    want_p = jm.apply({"params": params}, jnp.asarray(px),
                      method="image_patches")
    want_raw = jm.apply({"params": params}, jnp.asarray(emb),
                        method="get_text_features")
    for got, want in ((got_i, want_i), (got_t, want_t), (got_p, want_p),
                      (got_raw, want_raw)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_llm2clip_refuses_another_adapter_layout_as_jax():
    cfg, _ = llm2clip_tiny()
    sd = {k.replace(".fn.0.", ".fc1."): v
          for k, v in hf_llm2clip_state_dict(cfg).items()}
    with pytest.raises(KeyError, match="adaptor.0.fn.0") as got:
        port_llm2clip.load_llm2clip_state_dict(
            port_llm2clip.LLM2CLIP(cfg), sd)
    with pytest.raises(KeyError, match="adaptor.0.fn.0") as want:
        jax_llm2clip.convert_llm2clip_state_dict(sd)
    assert str(got.value) == str(want.value)
