"""The port's LLaVA-NeXT (``clip_embeds_tpu_torch/models/llava_next.py``)
against the JAX package's, on the CPU at a tiny size (a 2-layer trunk of
width 64; a 3-layer 32-px tower of width 64 read at block -2, 2 x 2
patches a crop; pinpoints 32x64, 64x32, 64x64), fp32, on the same seeded
numpy weights and inputs: the host plan and processor (integer- and
bit-equal), the tower's crop features, the pack, logits and
``embed_last_token`` (the last *valid* index over holes) with and without
an image and on a mixed batch, the HF converter in both key spellings, the
weights carried back, and the seeded init. Tolerance rtol = atol = 1e-5
(2e-5 over the trunk)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core import torch_convert as jconvert
from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.models import llava_next as jn
from clip_embeds_tpu.scores.build import config_to_dict

from clip_embeds_tpu_torch.core import convert as pconvert
from clip_embeds_tpu_torch.core.factory import init_vlm
from clip_embeds_tpu_torch.models import llava_next as pn
from clip_embeds_tpu_torch.models.llava import IMAGE_TOKEN_INDEX as IMG
from clip_embeds_tpu_torch.scores.build import config_from_dict

TOL = dict(rtol=1e-5, atol=1e-5)
LONG_TOL = dict(rtol=2e-5, atol=2e-5)
PINPOINTS = ((32, 64), (64, 32), (64, 64))
SIZES = ((20, 50), (60, 25))  # a wide and a tall image, (h, w)


def jax_cfg():
    return jn.LlavaNextConfig(
        llama=jllama.LlamaConfig(vocab_size=512, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=4, max_position_embeddings=256,
                                 rms_norm_eps=1e-6),
        vision=JVisionConfig(image_size=32, patch_size=16, width=64,
                             layers=3, head_width=32),
        grid_pinpoints=PINPOINTS,
    )


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


def _batch(seed, sizes=SIZES, length=12, image_rows=(0, 1)):
    """Rows with the sentinel after BOS (an imageless row holds it in its
    padding, as the mixed route does), right-padded by 2 + 2i; pixels
    [B, 1 + 4, 32, 32, 3]; the plans' gather / is_newline / valid (all
    False for an imageless row); the mask."""
    rng = np.random.default_rng(seed)
    cfg = jax_cfg()
    b = len(sizes)
    ids = rng.integers(2, 500, (b, length)).astype(np.int32)
    mask = np.zeros((b, length), np.int32)
    plans = [jn.anyres_pack_plan(hw, PINPOINTS, 32, 16, cfg.max_features)
             for hw in sizes]
    for i in range(b):
        n = length - 2 - 2 * i
        mask[i, :n] = 1
        ids[i, n:] = 0
        if i in image_rows:
            ids[i, 1] = IMG
        else:
            ids[i, n] = IMG
            plans[i].valid[:] = False
    px = rng.standard_normal((b, 5, 32, 32, 3)).astype(np.float32)
    stack = lambda k: np.stack([getattr(p, k) for p in plans])
    return (ids, px, stack("gather"), stack("is_newline"), stack("valid"),
            mask)


@functools.lru_cache(maxsize=None)
def tiny():
    jcfg = jax_cfg()
    model = jn.LlavaNext(jcfg, attn_impl="reference")
    args = [jnp.asarray(a) for a in _batch(0)[:5]]
    shapes = jax.eval_shape(lambda k: model.init(k, *args),
                            jax.random.PRNGKey(0))["params"]
    params = filled(shapes, 1)
    cfg = config_from_dict(pn.LlavaNextConfig, config_to_dict(jcfg))
    port = pn.LlavaNext(cfg).eval()
    port.load_state_dict(pconvert.vlm_state_dict_from_jax_params(params,
                                                                 cfg))
    return model, params, port


# -- host side ---------------------------------------------------------------


@pytest.mark.parametrize("hw", [(20, 50), (60, 25), (40, 40), (336, 1000),
                                (900, 700)])
def test_plan_is_integer_equal(hw):
    assert pn.select_best_resolution(hw, pn.DEFAULT_GRID_PINPOINTS) == \
        jn.select_best_resolution(hw, jn.DEFAULT_GRID_PINPOINTS)
    assert pn.anyres_grid_shape(hw, PINPOINTS, 32) == jn.anyres_grid_shape(
        hw, PINPOINTS, 32)
    for pins, size, patch in ((PINPOINTS, 32, 16),
                              (pn.DEFAULT_GRID_PINPOINTS, 336, 14)):
        assert pn.max_num_crops(pins, size) == jn.max_num_crops(pins, size)
        assert pn.anyres_max_features(pins, size, patch) == \
            jn.anyres_max_features(pins, size, patch)
        got = pn.anyres_pack_plan(hw, pins, size, patch)
        want = jn.anyres_pack_plan(hw, pins, size, patch)
        assert (got.num_crops, got.feature_len) == (want.num_crops,
                                                    want.feature_len)
        for k in ("gather", "is_newline", "valid"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("hw", [(120, 300), (700, 260)], ids=["wide", "tall"])
def test_process_anyres_image_is_bit_equal(hw):
    img = np.random.default_rng(2).integers(0, 256, hw + (3,), np.uint8)
    mean, std = (0.48, 0.45, 0.40), (0.26, 0.26, 0.27)
    got, ghw = pn.process_anyres_image(img, 336, pn.DEFAULT_GRID_PINPOINTS,
                                       mean, std)
    want, whw = jn.process_anyres_image(img, 336, jn.DEFAULT_GRID_PINPOINTS,
                                        mean, std)
    assert ghw == whw and got.shape == (5, 336, 336, 3)
    np.testing.assert_array_equal(got, want)


# -- the device model ----------------------------------------------------------


def test_crop_features_and_pack_match_jax():
    model, params, port = tiny()
    ids, px, gather, newline, valid, mask = _batch(3)
    feats = model.apply({"params": params}, jnp.asarray(px),
                        method="encode_crops")
    want = model.apply({"params": params}, feats, jnp.asarray(gather),
                       jnp.asarray(newline), method="pack")
    with torch.no_grad():
        got_feats = port.encode_crops(_t(px))
        got = port.pack(got_feats, _t(gather), _t(newline))
    np.testing.assert_allclose(got_feats.numpy(), np.asarray(feats), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_logits_match_jax(masked):
    model, params, port = tiny()
    ids, px, gather, newline, valid, mask = _batch(4)
    m = mask if masked else None
    want = model.apply({"params": params}, *map(jnp.asarray, (
        ids, px, gather, newline, valid)),
        None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got = port(*map(_t, (ids, px, gather, newline, valid)),
                   None if m is None else _t(m))
        _, keep, _ = port.merge(_t(ids), torch.zeros(2, valid.shape[1], 64),
                                _t(valid), None if m is None else _t(m))
    keep = keep.numpy()
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               **LONG_TOL)


@pytest.mark.parametrize("rows", ["image", "text", "mixed"])
def test_embed_last_token_matches_jax(rows):
    model, params, port = tiny()
    image_rows = {"image": (0, 1), "text": (), "mixed": (0,)}[rows]
    ids, px, gather, newline, valid, mask = _batch(5, image_rows=image_rows)
    if rows == "text":
        ids = np.where(ids == IMG, 0, ids)
        args = (ids, None, None, None, None, mask)
    else:
        args = (ids, px, gather, newline, valid, mask)
    want = model.apply({"params": params}, *(
        None if a is None else jnp.asarray(a) for a in args),
        method="embed_last_token")
    with torch.no_grad():
        got = port.embed_last_token(*(None if a is None else _t(a)
                                      for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LONG_TOL)
    if rows == "mixed":  # each row as it would run alone
        with torch.no_grad():
            one = port.embed_last_token(*(_t(a[:1]) for a in args))
            two = port.embed_last_token(_t(ids[1:, :8]), None, None, None,
                                        None, _t(mask[1:, :8]))
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


# -- HF layout, init -------------------------------------------------------------


def _hf_llava_next(newer, seed=6):
    cfg = jax_cfg()
    t, v = cfg.llama, cfg.vision
    rng = np.random.default_rng(seed)
    sd = {}

    def put(k, *shape):
        sd[k] = rng.standard_normal(shape).astype(np.float32)

    top = "model." if newer else ""
    vis = top + "vision_tower.vision_model."
    w, p = v.width, v.patch_size
    put(vis + "embeddings.patch_embedding.weight", w, 3, p, p)
    put(vis + "embeddings.class_embedding", w)
    put(vis + "embeddings.position_embedding.weight", 5, w)
    for n in ("pre_layrnorm", "post_layernorm"):
        put(f"{vis}{n}.weight", w)
        put(f"{vis}{n}.bias", w)
    for i in range(v.layers):
        pre = f"{vis}encoder.layers.{i}."
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
    h, m = t.hidden_size, t.intermediate_size
    put(top + "multi_modal_projector.linear_1.weight", h, w)
    put(top + "multi_modal_projector.linear_1.bias", h)
    put(top + "multi_modal_projector.linear_2.weight", h, h)
    put(top + "multi_modal_projector.linear_2.bias", h)
    put(top + "image_newline", h)
    lm = "model.language_model." if newer else "language_model.model."
    put(lm + "embed_tokens.weight", t.vocab_size, h)
    put(lm + "norm.weight", h)
    put("lm_head.weight" if newer else "language_model.lm_head.weight",
        t.vocab_size, h)
    for i in range(t.num_layers):
        pre = f"{lm}layers.{i}."
        put(pre + "input_layernorm.weight", h)
        put(pre + "post_attention_layernorm.weight", h)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put(f"{pre}self_attn.{n}.weight", h, h)
        for n, o, i_ in (("gate_proj", m, h), ("up_proj", m, h),
                         ("down_proj", h, m)):
            put(f"{pre}mlp.{n}.weight", o, i_)
    return sd


@pytest.mark.parametrize("newer", [False, True], ids=["classic", "newer"])
def test_hf_converter_matches_jax(newer):
    sd = _hf_llava_next(newer)
    want = jconvert.convert_llava_next_state_dict(sd)
    got = pconvert.convert_llava_next_state_dict(sd)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v)
    _, _, port = tiny()
    model = pn.LlavaNext(port.cfg)
    model.load_state_dict(pconvert.vlm_state_dict_from_jax_params(
        want, port.cfg))


def test_init_needs_a_card_unless_cpu():
    _, _, port = tiny()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            init_vlm("llava_next", port.cfg)
    model = init_vlm("llava_next", port.cfg, seed=2, device="cpu",
                     dtype=torch.float32)
    ids, px, gather, newline, valid, mask = _batch(7)
    with torch.no_grad():
        emb = model.embed_last_token(*map(_t, (ids, px, gather, newline,
                                               valid, mask)))
    assert torch.isfinite(emb).all() and emb.shape == (2, 64)
    std = float(model.image_newline.detach().std())
    assert 0.5 * 64 ** -0.5 < std < 2 * 64 ** -0.5
