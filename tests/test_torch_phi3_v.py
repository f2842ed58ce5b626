"""The port's Phi-3-V (``clip_embeds_tpu_torch/models/{phi3,phi3_v}.py``)
against the JAX package's, on the CPU at a tiny size (a 2-layer trunk of
width 64; a 3-layer 56-px tower of width 64 read at block -2, 4 x 4
patches a crop), fp32, on the same seeded numpy weights and inputs: the
host processor (integer- and bit-equal), the image embedding, logits and
``embed_last_token`` with and without an image and on a mixed batch, the
HF converters (packed qkv / gate_up split, the vision embedding), the
weights carried back, the seeded init; and VLM2Vec's backbone registry,
the default configs, ``ModelArguments.model_backbone`` and the MMEB
prompt rewrite of every registry name. Tolerance rtol = atol = 1e-5 (2e-5
over the trunk)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.data import mmeb as jmmeb
from clip_embeds_tpu.models import backbones as jbackbones
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.models import phi3 as jphi3
from clip_embeds_tpu.models import phi3_v as jp
from clip_embeds_tpu.scores.build import config_to_dict

from clip_embeds_tpu_torch.core import convert as pconvert
from clip_embeds_tpu_torch.core.factory import init_vlm
from clip_embeds_tpu_torch.data import mmeb as pmmeb
from clip_embeds_tpu_torch.models import backbones as pbackbones
from clip_embeds_tpu_torch.models import phi3 as pphi3
from clip_embeds_tpu_torch.models import phi3_v as pp
from clip_embeds_tpu_torch.models.llava import Llava
from clip_embeds_tpu_torch.scores.build import config_from_dict
from clip_embeds_tpu_torch.train.arguments import ModelArguments

TOL = dict(rtol=1e-5, atol=1e-5)
LONG_TOL = dict(rtol=2e-5, atol=2e-5)
CROPS = (1, 2)  # h_crop, w_crop of the model tests
MAX_CROPS = 3


def jax_cfg():
    return jp.Phi3VConfig(
        text=jllama.LlamaConfig(vocab_size=512, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4, max_position_embeddings=256),
        vision=JVisionConfig(image_size=56, patch_size=14, width=64,
                             layers=3, head_width=32),
    )


def n_image_tokens(h_crop, w_crop, g=4):
    """phi3v_num_image_tokens for a g x g patch grid (12 at 336 px)."""
    h, w = h_crop * g // 2, w_crop * g // 2
    return h * (w + 1) + 1 + (g // 2) * (g // 2 + 1)


def filled(shapes, seed):
    """A flax tree of ShapeDtypeStructs -> seeded numpy values (kernels
    at fan_in^-1/2, norms near one, the rest spread)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return z * s.shape[0] ** -0.5
        if name in ("scale", "weight"):
            return 1.0 + 0.1 * z
        return 0.3 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _t(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t


def _batch(seed, b=2, length=30, image_rows=(0, 1)):
    """Rows with the image's tokens as -1 after BOS (rows in
    ``image_rows``), right-padded by 2 a row; pixels [b, 1 + MAX_CROPS,
    56, 56, 3]; the mask."""
    rng = np.random.default_rng(seed)
    s = n_image_tokens(*CROPS)
    ids = np.zeros((b, length), np.int32)
    mask = np.zeros((b, length), np.int32)
    for i in range(b):
        n = length - 2 * i
        ids[i, :n] = rng.integers(2, 500, n)
        if i in image_rows:
            ids[i, 1:1 + s] = -1
        mask[i, :n] = 1
    px = rng.standard_normal((b, 1 + MAX_CROPS, 56, 56, 3)).astype(
        np.float32)
    return ids, px, mask


@functools.lru_cache(maxsize=None)
def tiny():
    jcfg = jax_cfg()
    model = jp.Phi3V(jcfg, attn_impl="reference")
    ids, px, _ = _batch(0)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.asarray(ids), jnp.asarray(px), *CROPS),
        jax.random.PRNGKey(0))["params"]
    params = filled(shapes, 1)
    cfg = config_from_dict(pp.Phi3VConfig, config_to_dict(jcfg))
    port = pp.Phi3V(cfg).eval()
    port.load_state_dict(pconvert.vlm_state_dict_from_jax_params(params,
                                                                 cfg))
    return model, params, port


# -- host side ---------------------------------------------------------------


@pytest.mark.parametrize("wh", [(500, 300), (300, 700), (336, 336),
                                (1000, 120)])
@pytest.mark.parametrize("hd_num", [4, 16])
def test_hd_transform_grid_matches_jax(wh, hd_num):
    got = pp.hd_transform_grid(*wh, hd_num)
    assert got == jp.hd_transform_grid(*wh, hd_num)
    assert pp.phi3v_num_image_tokens(*got) == jp.phi3v_num_image_tokens(*got)


def test_bicubic_is_bit_equal_and_torch_bicubic():
    arr = np.random.default_rng(2).standard_normal((90, 70, 3)).astype(
        np.float32)
    got = pp.bicubic_no_antialias(arr, 33, 41)
    np.testing.assert_array_equal(got, jp.bicubic_no_antialias(arr, 33, 41))
    want = torch.nn.functional.interpolate(
        _t(arr).permute(2, 0, 1)[None], size=(33, 41), mode="bicubic",
        align_corners=False, antialias=False)[0].permute(1, 2, 0)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("wh", [(400, 230), (200, 420)], ids=["wide", "tall"])
def test_process_image_is_bit_equal(wh):
    img = np.random.default_rng(3).integers(0, 256, (wh[1], wh[0], 3),
                                            dtype=np.uint8)
    got, ggrid = pp.phi3v_process_image(img, hd_num=4, max_crops=6)
    want, wgrid = jp.phi3v_process_image(img, hd_num=4, max_crops=6)
    assert ggrid == wgrid and got.shape == (7, 336, 336, 3)
    np.testing.assert_array_equal(got, want)


# -- the device model ----------------------------------------------------------


def test_image_embedding_matches_jax():
    model, params, port = tiny()
    _, px, _ = _batch(4)
    emb = jp.Phi3VImageEmbedding(model.cfg, attn_impl="reference")
    want = emb.apply({"params": params["vision_embed"]}, jnp.asarray(px),
                     *CROPS)
    with torch.no_grad():
        got = port.vision_embed(_t(px), *CROPS)
    assert got.shape == (2, n_image_tokens(*CROPS), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_logits_match_jax(masked):
    model, params, port = tiny()
    ids, px, mask = _batch(5)
    m = mask if masked else None
    want = model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(px),
                       *CROPS, None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got = port(_t(ids), _t(px), *CROPS, None if m is None else _t(m))
    keep = mask.astype(bool) if masked else np.ones(ids.shape, bool)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               **LONG_TOL)


@pytest.mark.parametrize("rows", ["image", "text", "mixed"])
def test_embed_last_token_matches_jax(rows):
    model, params, port = tiny()
    image_rows = {"image": (0, 1), "text": (), "mixed": (0,)}[rows]
    ids, px, mask = _batch(6, image_rows=image_rows)
    use_px = rows != "text"
    want = model.apply({"params": params}, jnp.asarray(ids),
                       jnp.asarray(px) if use_px else None, *CROPS,
                       jnp.asarray(mask), method="embed_last_token")
    with torch.no_grad():
        got = port.embed_last_token(_t(ids), _t(px) if use_px else None,
                                    *CROPS, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LONG_TOL)
    if rows == "mixed":  # each row as it would run alone
        with torch.no_grad():
            one = port.embed_last_token(_t(ids[:1]), _t(px[:1]), *CROPS,
                                        _t(mask[:1]))
            two = port.embed_last_token(_t(ids[1:, :28]), None, *CROPS,
                                        _t(mask[1:, :28]))
        np.testing.assert_allclose(torch.cat([one, two]).numpy(),
                                   got.numpy(), **LONG_TOL)


def test_weights_carry_back_to_jax():
    _, params, port = tiny()
    back = pconvert.jax_params_from_module(port)
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))


# -- HF layouts, init ------------------------------------------------------------


def _hf_clip_vision(put, prefix, v):
    w, p = v.width, v.patch_size
    e = prefix + "embeddings."
    put(e + "patch_embedding.weight", w, 3, p, p)
    put(e + "class_embedding", w)
    put(e + "position_embedding.weight", (v.image_size // p) ** 2 + 1, w)
    for n in ("pre_layrnorm", "post_layernorm"):
        put(f"{prefix}{n}.weight", w)
        put(f"{prefix}{n}.bias", w)
    for i in range(v.layers):
        pre = f"{prefix}encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            put(pre + n + ".weight", w)
            put(pre + n + ".bias", w)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{pre}self_attn.{n}.weight", w, w)
            put(f"{pre}self_attn.{n}.bias", w)
        put(pre + "mlp.fc1.weight", 4 * w, w)
        put(pre + "mlp.fc1.bias", 4 * w)
        put(pre + "mlp.fc2.weight", w, 4 * w)
        put(pre + "mlp.fc2.bias", w)


def _hf_phi3_v(seed=7):
    cfg = jax_cfg()
    t, v = cfg.text, cfg.vision
    rng = np.random.default_rng(seed)
    sd = {}

    def put(k, *shape):
        sd[k] = rng.standard_normal(shape).astype(np.float32)

    h, m = t.hidden_size, t.intermediate_size
    put("model.embed_tokens.weight", t.vocab_size, h)
    put("model.norm.weight", h)
    put("lm_head.weight", t.vocab_size, h)
    for i in range(t.num_layers):
        p = f"model.layers.{i}."
        put(p + "input_layernorm.weight", h)
        put(p + "post_attention_layernorm.weight", h)
        put(p + "self_attn.qkv_proj.weight", 3 * h, h)
        put(p + "self_attn.o_proj.weight", h, h)
        put(p + "mlp.gate_up_proj.weight", 2 * m, h)
        put(p + "mlp.down_proj.weight", h, m)
    vis = "model.vision_embed_tokens."
    _hf_clip_vision(put, vis + "img_processor.vision_model.", v)
    put(vis + "glb_GN", 1, 1, 4 * v.width)
    put(vis + "sub_GN", 1, 1, 1, 4 * v.width)
    put(vis + "img_projection.0.weight", h, 4 * v.width)
    put(vis + "img_projection.0.bias", h)
    put(vis + "img_projection.2.weight", h, h)
    put(vis + "img_projection.2.bias", h)
    return sd


def _assert_trees_equal(got, want):
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v)


def test_hf_converters_match_jax():
    sd = _hf_phi3_v()
    _, _, port = tiny()
    jcfg = jax_cfg()
    _assert_trees_equal(pconvert.convert_phi3_v_state_dict(sd, port.cfg),
                        jp.convert_phi3_v_state_dict(sd, jcfg))
    _assert_trees_equal(
        pphi3.convert_phi3_state_dict(sd, port.cfg.text),
        jphi3.convert_phi3_state_dict(sd, jcfg.text))
    _assert_trees_equal(
        pconvert.convert_phi3v_image_embedding_state_dict(
            sd, "model.vision_embed_tokens."),
        jp.convert_phi3v_image_embedding_state_dict(
            sd, "model.vision_embed_tokens."))
    tree = jp.convert_phi3_v_state_dict(sd, jcfg)
    model = pp.Phi3V(port.cfg)
    model.load_state_dict(pconvert.vlm_state_dict_from_jax_params(
        tree, port.cfg))
    assert len(model.vision_embed.img_processor.transformer.resblocks) == 2


def test_init_needs_a_card_unless_cpu():
    _, _, port = tiny()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            init_vlm("phi3_v", port.cfg)
    model = init_vlm("TIGER-Lab/VLM2Vec-Full", port.cfg, seed=3,
                     device="cpu", dtype=torch.float32)
    ids, px, mask = _batch(8)
    with torch.no_grad():
        emb = model.embed_last_token(_t(ids), _t(px), *CROPS, _t(mask))
    assert torch.isfinite(emb).all() and emb.shape == (2, 64)
    assert model.vision_embed.glb_GN.std() > 0


# -- the registry and what names it ------------------------------------------


def test_backbone_registry_matches_jax():
    """JAX tests/test_vlm2vec.py test_backbone_registry, on both packages:
    the same table, the same class and converter for every family and HF
    name, default configs equal field for field, KeyError otherwise."""
    assert pbackbones.HF_MODEL_TO_VLM_BACKBONE == \
        jbackbones.HF_MODEL_TO_VLM_BACKBONE
    names = sorted(set(jbackbones.HF_MODEL_TO_VLM_BACKBONE)
                   | set(jbackbones.HF_MODEL_TO_VLM_BACKBONE.values()))
    for name in names:
        got, want = pbackbones.get_backbone(name), jbackbones.get_backbone(
            name)
        assert got.model_cls.__name__ == want.model_cls.__name__
        assert got.converter.__name__ == want.converter.__name__
        assert config_to_dict(got.config_factory()) == config_to_dict(
            want.config_factory())
    assert pbackbones.get_backbone("TIGER-Lab/VLM2Vec-Full").model_cls \
        is pp.Phi3V
    with pytest.raises(KeyError):
        pbackbones.get_backbone("not-a-backbone")


def test_model_backbone_argument_resolves_and_mmeb_rewrites_as_jax():
    """ModelArguments.model_backbone's default resolves through the
    registry to LLaVA-1.5; MMEB's prompt rewrite and resolution for every
    registry name are JAX's. Both packages leave the registry's own family
    names 'llava_15', 'qwen2_vl' and 'qwen2_5_vl' (and 'phi3_v') without
    a rewrite: only 'llava_next', 'llava-1.5', 'llava_1.5',
    'llava-hf/llava-1.5-7b-hf' and 'qwen' match."""
    assert pbackbones.get_backbone(
        ModelArguments().model_backbone).model_cls is Llava
    text = "<|image_1|> Represent the given image."
    names = sorted(set(pbackbones.HF_MODEL_TO_VLM_BACKBONE)
                   | set(pbackbones.HF_MODEL_TO_VLM_BACKBONE.values())
                   | {"qwen", "llava-1.5", "llava_1.5"})
    seen = {}
    for name in names:
        got = pmmeb.MMEBTrainDataset({}, model_backbone=name)
        want = jmmeb.MMEBTrainDataset({}, model_backbone=name)
        assert got._rewrite(text) == want._rewrite(text), name
        assert got._resolution() == want._resolution(), name
        seen[name] = got._rewrite(text) != text
    assert not seen["llava_15"] and not seen["qwen2_vl"]
    assert seen["llava_next"] and seen["qwen"]
