"""The port's Qwen2-VL and Qwen2.5-VL (``clip_embeds_tpu_torch/models/
qwen2_vl.py``) and the trunk's multimodal RoPE (``models/llama.py``)
against the JAX package's, on the CPU at a tiny size (a 2-layer trunk of
width 48, GQA 4/2, sections (2, 2, 2); towers of width 32 over 4-px
patches, Qwen2.5's windows 2 cells a side), fp32, on the same seeded numpy
weights and inputs: M-RoPE and its dispatch, ``get_rope_index``, the host
processors, ``_window_plan``, each tower (one frame and two), logits and
``embed_last_token`` with and without an image, the W8A8 trunk in both
modes, the HF converters in both key layouts, the weights carried back, and
the seeded inits. Tolerance rtol = atol = 1e-5 (2e-5 over the trunks'
longer sums)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core import torch_convert as jconvert
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.models import qwen2_vl as jq
from clip_embeds_tpu.models.quant import quantize_llava_trunk as jquantize
from clip_embeds_tpu.scores.build import config_to_dict

from clip_embeds_tpu_torch.core import convert as pconvert
from clip_embeds_tpu_torch.core.factory import init_vlm
from clip_embeds_tpu_torch.models import llama as pllama
from clip_embeds_tpu_torch.models import qwen2_vl as pq
from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
from clip_embeds_tpu_torch.scores.build import config_from_dict

TOL = dict(rtol=1e-5, atol=1e-5)
LONG_TOL = dict(rtol=2e-5, atol=2e-5)
IMAGE_TOKEN = 500
GRID = (1, 8, 8)  # one frame of 8 x 8 patches: 16 merged tokens


def _text(**kw):
    base = dict(vocab_size=512, hidden_size=48, intermediate_size=96,
                num_layers=2, num_heads=4, num_kv_heads=2,
                max_position_embeddings=128, rms_norm_eps=1e-5,
                attention_bias=True, mrope_section=(2, 2, 2))
    base.update(kw)
    return jllama.LlamaConfig(**base)


def jax_cfg(v25=False):
    ids = dict(image_token_id=IMAGE_TOKEN, video_token_id=501,
               vision_start_token_id=502)
    if v25:
        return jq.Qwen25VLConfig(
            text=_text(), vision=jq.Qwen25VLVisionConfig(
                depth=3, embed_dim=32, intermediate_size=64, hidden_size=48,
                num_heads=2, patch_size=4, spatial_merge_size=2,
                temporal_patch_size=2, window_size=16,
                fullatt_block_indexes=(1,)), **ids)
    return jq.Qwen2VLConfig(
        text=_text(), vision=jq.Qwen2VLVisionConfig(
            depth=2, embed_dim=32, hidden_size=48, mlp_ratio=2.0,
            num_heads=2, patch_size=4, spatial_merge_size=2,
            temporal_patch_size=2), **ids)


def filled(shapes, seed):
    """A flax tree of ShapeDtypeStructs -> seeded numpy values: kernels at
    fan_in^-1/2, norms near one, biases and embeddings spread, so a
    dropped or swapped tensor shows."""
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


def _patches(seed, b, grid=GRID, patch_dim=96):
    t, h, w = grid
    return np.random.default_rng(seed).standard_normal(
        (b, t * h * w, patch_dim)).astype(np.float32)


def _rows(seed, b, length, n_image, pad_to=None):
    """b rows of ``length`` tokens with ``n_image`` image-pad tokens after
    a 3-token prefix (none when 0), right-padded to ``pad_to``; and the
    mask."""
    rng = np.random.default_rng(seed)
    pad_to = pad_to or length
    ids = np.zeros((b, pad_to), np.int32)
    mask = np.zeros((b, pad_to), np.int32)
    for i in range(b):
        n = length - (2 * i if pad_to != length else 0)
        ids[i, :n] = rng.integers(1, 400, n)
        if n_image:
            ids[i, 3:3 + n_image] = IMAGE_TOKEN
        mask[i, :n] = 1
    return ids, mask


@functools.lru_cache(maxsize=None)
def family(v25):
    """(JAX model, its params, the port's model on them)."""
    jcfg = jax_cfg(v25)
    cls = jq.Qwen25VL if v25 else jq.Qwen2VL
    model = cls(jcfg, attn_impl="reference")
    ids, _ = _rows(0, 2, 32, 16)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.asarray(ids), jnp.asarray(_patches(0, 2)), GRID),
        jax.random.PRNGKey(0))["params"]
    params = filled(shapes, 1 + v25)
    pcls = pq.Qwen25VLConfig if v25 else pq.Qwen2VLConfig
    cfg = config_from_dict(pcls, config_to_dict(jcfg))
    port = (pq.Qwen25VL if v25 else pq.Qwen2VL)(cfg).eval()
    port.load_state_dict(pconvert.vlm_state_dict_from_jax_params(params,
                                                                 cfg))
    return model, params, port


# -- M-RoPE ------------------------------------------------------------------


@pytest.mark.parametrize("section", [(2, 2, 2), (16, 24, 24)])
def test_mrope_cos_sin_matches_jax(section):
    hd = 2 * sum(section)
    pos = np.random.default_rng(3).integers(0, 300, (2, 3, 9))
    want = jllama.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, section)
    got = pllama.mrope_cos_sin(_t(pos), hd, 1e6, section)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError):
        pllama.mrope_cos_sin(_t(pos), hd + 2, 1e6, section)


@pytest.mark.parametrize("mrope", [True, False], ids=["mrope", "rope1d"])
def test_trunk_dispatches_3d_positions_as_jax(mrope):
    """[B, 3, N] positions: M-RoPE on an M-RoPE trunk, row 0 on a 1-D one."""
    jcfg = _text(mrope_section=(2, 2, 2) if mrope else None)
    model = jllama.LlamaForCausalLM(jcfg, attn_impl="reference")
    ids = np.random.default_rng(4).integers(1, 500, (2, 32)).astype(np.int32)
    pos = np.random.default_rng(5).integers(0, 40, (2, 3, 32))
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.asarray(ids)),
                            jax.random.PRNGKey(0))["params"]
    params = filled(shapes, 6)
    want = model.apply({"params": params}, jnp.asarray(ids),
                       positions=jnp.asarray(pos))
    port = pllama.LlamaForCausalLM(config_from_dict(
        pllama.LlamaConfig, config_to_dict(jcfg))).eval()
    port.load_state_dict(pconvert.state_dict_from_flax(params))
    with torch.no_grad():
        got = port(_t(ids), positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LONG_TOL)


# -- host side ---------------------------------------------------------------


def test_rope_index_is_integer_equal():
    cfg = jax_cfg()
    pcfg = config_from_dict(pq.Qwen2VLConfig, config_to_dict(cfg))
    ids = np.full((3, 40), 7, np.int64)
    ids[0, 2:18] = IMAGE_TOKEN                 # one image of 8 x 8
    ids[1, 5:9] = IMAGE_TOKEN                  # a 4 x 4 image, then
    ids[1, 12:24] = IMAGE_TOKEN                # a 2-frame 4 x 6 one
    mask = np.ones((3, 40), np.int64)
    mask[0, 30:] = 0
    mask[2, 25:] = 0                           # text only
    grids = [(1, 8, 8), (1, 4, 4), (2, 4, 6)]
    want = jq.get_rope_index(ids, grids, mask, cfg)
    got = pq.get_rope_index(ids, grids, mask, pcfg)
    assert got.dtype == want.dtype and got.shape == (3, 3, 40)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pq.get_rope_index(ids[2:], [], None, pcfg),
                                  jq.get_rope_index(ids[2:], [], None, cfg))


@pytest.mark.parametrize("hw", [(448, 448), (900, 200), (20, 30), (5000, 4000)])
def test_smart_resize_matches_jax(hw):
    assert pq.smart_resize(*hw) == jq.smart_resize(*hw)


@pytest.mark.parametrize("frames", [None, 3], ids=["image", "video3"])
def test_image_to_patches_is_bit_equal(frames):
    cfg = jax_cfg().vision
    shape = (3, 16, 24) if frames is None else (frames, 3, 16, 24)
    arr = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    got, ggrid = pq.image_to_patches(arr, cfg)
    want, wgrid = jq.image_to_patches(arr, cfg)
    assert ggrid == wgrid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", [(1, 8, 8), (2, 12, 20), (1, 32, 32)])
def test_vision_rope_and_window_plan_are_equal(grid):
    for a, b in zip(pq._vision_rope(grid, 16, 2), jq._vision_rope(grid, 16,
                                                                  2)):
        np.testing.assert_array_equal(a, b)
    cfg = jq.Qwen25VLVisionConfig(window_size=16, patch_size=4)
    if grid == (1, 32, 32):  # the 7B's 448 px: 4 x 4 = 16 windows
        cfg = jq.Qwen25VLVisionConfig()
        grid = (1, 32, 32)
    got = pq._window_plan(grid, config_from_dict(
        pq.Qwen25VLVisionConfig, config_to_dict(cfg)))
    want = jq._window_plan(grid, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if cfg.window_size == 112:
        assert len(set(got[1].tolist())) == 16


# -- the towers and the models -----------------------------------------------


@pytest.mark.parametrize("v25", [False, True], ids=["qwen2", "qwen2.5"])
@pytest.mark.parametrize("grid", [(1, 8, 8), (2, 4, 12)],
                         ids=["image", "2frames"])
def test_tower_matches_jax(v25, grid):
    model, params, port = family(v25)
    x = _patches(8, 2, grid)
    tower = (jq.Qwen25VisionTower if v25 else jq.Qwen2VisionTower)(
        model.cfg.vision)
    want = tower.apply({"params": params["visual"]}, jnp.asarray(x), grid)
    with torch.no_grad():
        got = port.visual(_t(x), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("v25", [False, True], ids=["qwen2", "qwen2.5"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_logits_match_jax(v25, masked):
    model, params, port = family(v25)
    cfg = model.cfg
    ids, mask = _rows(9, 2, 32 if not masked else 30, 16, pad_to=32)
    pos = jq.get_rope_index(ids, [GRID] * 2, mask, cfg)
    x = _patches(10, 2)
    m = mask if masked else None
    want = model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(x),
                       GRID, None if m is None else jnp.asarray(m),
                       jnp.asarray(pos))
    with torch.no_grad():
        got = port(_t(ids), _t(x), GRID, None if m is None else _t(m),
                   _t(pos))
    keep = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               **LONG_TOL)


@pytest.mark.parametrize("v25", [False, True], ids=["qwen2", "qwen2.5"])
@pytest.mark.parametrize("image", [True, False], ids=["image", "text"])
def test_embed_last_token_matches_jax(v25, image):
    model, params, port = family(v25)
    ids, mask = _rows(11, 2, 30, 16 if image else 0, pad_to=32)
    pos = jq.get_rope_index(ids, [GRID] * 2 if image else [], mask,
                            model.cfg)
    x = _patches(12, 2) if image else None
    want = model.apply({"params": params}, jnp.asarray(ids),
                       None if x is None else jnp.asarray(x),
                       GRID if image else None, jnp.asarray(mask),
                       jnp.asarray(pos), method="embed_last_token")
    with torch.no_grad():
        got = port.embed_last_token(_t(ids), None if x is None else _t(x),
                                    GRID if image else None, _t(mask),
                                    _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LONG_TOL)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_w8a8_trunk_matches_jax_quant_llm(mode):
    """quantize_llava_trunk on the port's Qwen2-VL gives JAX's int8 codes,
    scales and fp32 q/k/v biases; the W8A8 model (JAX's quant_llm) gives
    JAX's logits, also built from JAX's quantised tree."""
    model, params, port = family(False)
    tree = jquantize(params)
    if mode == "static":
        rng = np.random.default_rng(13)

        def with_scale(node):
            if isinstance(node, dict) and "kernel_q" in node:
                return dict(node, act_scale=np.float32(
                    0.01 + 0.02 * rng.random()))
            if isinstance(node, dict):
                return {k: with_scale(v) for k, v in node.items()}
            return node

        tree = with_scale(tree)
    qport = quantize_llava_trunk(port, mode)
    sd = qport.state_dict()
    layer = tree["language_model"]["model"]["layers_1"]["self_attn"]
    key = "language_model.model.layers.1.self_attn."
    np.testing.assert_array_equal(sd[key + "k_proj.weight_q"].numpy(),
                                  np.asarray(layer["k_proj"]["kernel_q"]).T)
    np.testing.assert_array_equal(sd[key + "q_proj.bias"].numpy(),
                                  np.asarray(layer["q_proj"]["bias"]))
    assert sd[key + "v_proj.bias"].dtype == torch.float32
    assert sum(k.endswith("weight_q") for k in sd) == 14
    jmodel = jq.Qwen2VL(model.cfg, attn_impl="reference", quant_llm=mode)
    ids, mask = _rows(14, 2, 32, 16)
    pos = jq.get_rope_index(ids, [GRID] * 2, mask, model.cfg)
    x = _patches(15, 2)
    want = np.asarray(jmodel.apply({"params": tree}, jnp.asarray(ids),
                                   jnp.asarray(x), GRID, None,
                                   jnp.asarray(pos)))
    from_jax = pq.Qwen2VL(port.cfg, quant_llm=mode).eval()
    from_jax.load_state_dict(pconvert.vlm_state_dict_from_jax_params(
        tree, port.cfg))
    models = [from_jax] + ([qport] if mode == "dynamic" else [])
    with torch.no_grad():
        for m in models:
            got = m(_t(ids), _t(x), GRID, None, _t(pos)).numpy()
            np.testing.assert_allclose(got, want, **LONG_TOL)


@pytest.mark.parametrize("v25", [False, True], ids=["qwen2", "qwen2.5"])
def test_weights_carry_back_to_jax(v25):
    _, params, port = family(v25)
    back = pconvert.jax_params_from_module(port)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], np.asarray(v))


# -- HF layouts, inits ---------------------------------------------------------


def _hf_qwen(v25, newer, seed=16):
    """A random HF-layout state dict of the tiny config (both key
    layouts)."""
    cfg = jax_cfg(v25)
    v, t = cfg.vision, cfg.text
    rng = np.random.default_rng(seed)
    sd = {}

    def put(k, *shape):
        sd[k] = rng.standard_normal(shape).astype(np.float32)

    vis = "model.visual." if newer else "visual."
    lm = "model.language_model." if newer else "model."
    d = v.embed_dim
    put(vis + "patch_embed.proj.weight", d, 3, 2, 4, 4)
    mlp = v.intermediate_size if v25 else int(d * v.mlp_ratio)
    for i in range(v.depth):
        p = f"{vis}blocks.{i}."
        for n in ("norm1", "norm2"):
            put(p + n + ".weight", d)
            if not v25:
                put(p + n + ".bias", d)
        put(p + "attn.qkv.weight", 3 * d, d)
        put(p + "attn.qkv.bias", 3 * d)
        put(p + "attn.proj.weight", d, d)
        put(p + "attn.proj.bias", d)
        names = (("gate_proj", mlp, d), ("up_proj", mlp, d),
                 ("down_proj", d, mlp)) if v25 else (
            ("fc1", mlp, d), ("fc2", d, mlp))
        for n, o, i_ in names:
            put(f"{p}mlp.{n}.weight", o, i_)
            put(f"{p}mlp.{n}.bias", o)
    put(vis + "merger.ln_q.weight", d)
    if not v25:
        put(vis + "merger.ln_q.bias", d)
    put(vis + "merger.mlp.0.weight", 4 * d, 4 * d)
    put(vis + "merger.mlp.0.bias", 4 * d)
    put(vis + "merger.mlp.2.weight", t.hidden_size, 4 * d)
    put(vis + "merger.mlp.2.bias", t.hidden_size)
    h, kv = t.hidden_size, t.kv_heads * t.head_dim
    put(lm + "embed_tokens.weight", t.vocab_size, h)
    put(lm + "norm.weight", h)
    for i in range(t.num_layers):
        p = f"{lm}layers.{i}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            put(p + n + ".weight", h)
        for n, o in (("q_proj", h), ("k_proj", kv), ("v_proj", kv)):
            put(f"{p}self_attn.{n}.weight", o, h)
            put(f"{p}self_attn.{n}.bias", o)
        put(p + "self_attn.o_proj.weight", h, h)
        for n, o, i_ in (("gate_proj", t.intermediate_size, h),
                         ("up_proj", t.intermediate_size, h),
                         ("down_proj", h, t.intermediate_size)):
            put(f"{p}mlp.{n}.weight", o, i_)
    put("lm_head.weight", t.vocab_size, h)
    return sd


def _assert_trees_equal(got, want):
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v)


@pytest.mark.parametrize("v25", [False, True], ids=["qwen2", "qwen2.5"])
@pytest.mark.parametrize("newer", [False, True], ids=["old", "new"])
def test_hf_converters_match_jax(v25, newer):
    sd = _hf_qwen(v25, newer)
    name = "convert_qwen2_5_vl_state_dict" if v25 else \
        "convert_qwen2_vl_state_dict"
    want = getattr(jconvert, name)(sd)
    _assert_trees_equal(getattr(pconvert, name)(sd), want)
    # and the tree loads into the port's model whole
    _, _, port = family(v25)
    model = type(port)(port.cfg)
    model.load_state_dict(pconvert.vlm_state_dict_from_jax_params(
        want, port.cfg))


@pytest.mark.parametrize("name", ["qwen2_vl", "qwen2_5_vl"])
def test_inits_need_a_card_unless_cpu(name):
    _, _, port = family(name == "qwen2_5_vl")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            init_vlm(name, port.cfg, seed=0)
    kw = dict(seed=0, device="cpu", dtype=torch.float32)
    model = init_vlm(name, port.cfg, **kw)
    again = init_vlm(name, port.cfg, **kw)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    ids, mask = _rows(17, 2, 32, 16)
    pos = pq.get_rope_index(ids, [GRID] * 2, mask, port.cfg)
    with torch.no_grad():
        emb = model.embed_last_token(_t(ids), _t(_patches(18, 2)), GRID,
                                     _t(mask), _t(pos))
    assert torch.isfinite(emb).all() and emb.shape == (2, 48)
