"""The port's Llama trunk and LLaVA (``clip_embeds_tpu_torch/models/
{llama,llava}.py``) against the JAX package's on the same weights, on the
CPU at a tiny size (a 2-layer trunk of width 64 with 4 heads, a 2-layer
32-px tower): RoPE, the trunk's logits (MHA and GQA, with and without a
padding mask), the splice, the LLaVA forward, the prefill's per-layer K/V
against JAX's sown ``kv`` collection, the suffix pass (per-row prefix
lengths, ``suffix_block``), the prefix-reuse identities inside the port,
HF-layout weights in both key spellings, the int8 trunk's codes and
logits, and weights carried both ways between the packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.core.torch_convert import convert_llava_state_dict
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.models import llava as jllava
from clip_embeds_tpu.models.quant import quantize_llava_trunk as jquantize
from clip_embeds_tpu.scores.build import config_to_dict

from clip_embeds_tpu_torch.core.convert import (
    jax_params_from_llava,
    llama_state_dict_from_jax_params,
    llava_state_dict_from_hf,
    llava_state_dict_from_jax_params,
)
from clip_embeds_tpu_torch.core.factory import init_llava
from clip_embeds_tpu_torch.models import llama as pllama
from clip_embeds_tpu_torch.models import llava as pllava
from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
from clip_embeds_tpu_torch.scores.build import config_from_dict

IMG = jllava.IMAGE_TOKEN_INDEX
TOL = dict(rtol=1e-5, atol=1e-5)
SUFFIX_TOL = dict(rtol=2e-5, atol=2e-5)


def jax_tiny_cfg(**llama):
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, max_position_embeddings=256)
    kw.update(llama)
    return jllava.LlavaConfig(
        llama=jllama.LlamaConfig(**kw),
        vision=JVisionConfig(image_size=32, patch_size=16, width=64,
                             layers=2, head_width=32),
    )


def port_cfg(jcfg):
    return config_from_dict(pllava.LlavaConfig, config_to_dict(jcfg))


def perturbed(params, seed):
    """Every float leaf moved by N(0, 0.05): norms, biases and scales away
    from their init values, so a dropped one shows."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree.map(move, jax.device_get(params))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_cfg()
    model = jllava.Llava(jcfg, attn_impl="reference")
    rng = np.random.default_rng(0)
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray([[1, IMG, 5, 6]], jnp.int32),
        jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32),
    )["params"]
    params = perturbed(params, 1)
    cfg = port_cfg(jcfg)
    port = pllava.Llava(cfg).eval()
    port.load_state_dict(llava_state_dict_from_jax_params(params, cfg))
    return model, params, port


def _pixels(seed, b=1):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def _t(a):
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def test_rope_and_rotary_match_jax():
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 200, (2, 7)).astype(np.int32)
    cos_j, sin_j = jllama.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    cos_p, sin_p = pllama.rope_cos_sin(_t(pos), 16, 10000.0)
    np.testing.assert_allclose(cos_p.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_p.numpy(), np.asarray(sin_j), **TOL)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    want = jllama.apply_rotary(jnp.asarray(x), cos_j, sin_j)
    got = pllama.apply_rotary(_t(x), cos_p, sin_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("padded", [False, True], ids=["nomask", "mask"])
def test_llama_logits_match_jax(kv_heads, padded):
    cfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64,
                             intermediate_size=96, num_layers=2,
                             num_heads=4, num_kv_heads=kv_heads,
                             max_position_embeddings=64)
    model = jllama.LlamaForCausalLM(cfg, attn_impl="reference")
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 120, (2, 12)).astype(np.int32)
    params = perturbed(model.init(jax.random.PRNGKey(1),
                                  jnp.asarray(ids))["params"], 4)
    mask = None
    if padded:
        mask = np.ones((2, 12), bool)
        mask[1, 8:] = False
    want = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask)))
    port = pllama.LlamaForCausalLM(
        config_from_dict(pllama.LlamaConfig, config_to_dict(cfg))).eval()
    port.load_state_dict(llama_state_dict_from_jax_params(params))
    with torch.no_grad():
        got = port(_t(ids), None if mask is None else _t(mask)).numpy()
    if padded:  # padded queries are masked garbage in both
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_allclose(got[1, :8], want[1, :8], **TOL)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_splice_positions_and_expand_match_jax():
    ids = np.asarray([[1, 9, IMG, 5, 6, 0], [1, IMG, 7, 8, 0, 0]], np.int32)
    want = jllava.splice_positions(jnp.asarray(ids), 5)
    got = pllava.splice_positions(_t(ids), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    labels = np.arange(12, dtype=np.int32).reshape(2, 6)
    want = jllava.expand_like_tokens(jnp.asarray(labels), jnp.asarray(ids),
                                     5, -100)
    got = pllava.expand_like_tokens(_t(labels), _t(ids), 5, -100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llava_forward_logits_match_jax(tiny):
    model, params, port = tiny
    ids = np.asarray([[1, 9, IMG, 17, 23, 40, 0],
                      [1, IMG, 31, 37, 41, 0, 0]], np.int32)
    mask = ids != 0
    px = _pixels(5, 2)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(px), jnp.asarray(mask)))
    with torch.no_grad():
        got = port(_t(ids), _t(px), _t(mask)).numpy()
    n_image = port.cfg.n_image_tokens
    for row in range(2):  # the real positions of each row
        real = int(mask[row].sum()) - 1 + n_image
        np.testing.assert_allclose(got[row, :real], want[row, :real], **TOL)


def _jax_prefill(model, params, prefix_ids, px, valid):
    pmask, mut = model.apply(
        {"params": params}, jnp.asarray(prefix_ids), jnp.asarray(px),
        jnp.asarray(valid), method="prefill", mutable=["kv"])
    return jllava.extract_prefix_kv(mut["kv"],
                                    model.cfg.llama.num_layers), pmask


def _prefix(rows, lp):
    ids = np.zeros((len(rows), lp), np.int32)
    valid = np.zeros((len(rows), lp), bool)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        valid[i, : len(r)] = True
    return ids, valid


def test_prefill_kv_matches_jax_kv_collection(tiny):
    model, params, port = tiny
    ids, valid = _prefix([[1, 9, IMG, 17, 23], [1, IMG, 31, 37, 41, 43]], 8)
    px = _pixels(6, 2)
    kv_j, pmask_j = _jax_prefill(model, params, ids, px, valid)
    with torch.no_grad():
        kv_p, pmask_p = port.prefill(_t(ids), _t(px), _t(valid))
    np.testing.assert_array_equal(pmask_p.numpy(), np.asarray(pmask_j))
    assert len(kv_p) == len(kv_j) == 2
    for (kp, vp), (kj, vj) in zip(kv_p, kv_j):
        np.testing.assert_allclose(kp.numpy(), np.asarray(kj), **TOL)
        np.testing.assert_allclose(vp.numpy(), np.asarray(vj), **TOL)


@pytest.mark.parametrize("block", [None, 4], ids=["rows", "suffix_block"])
def test_suffix_logits_match_jax(tiny, block):
    """A batched prefill of two images with per-row real prefix lengths,
    then the suffix pass: separate rows, or per row two candidates
    concatenated in blocks of 4 (the second row's last one padded)."""
    model, params, port = tiny
    rows = [[1, 9, IMG, 17, 23], [1, IMG, 31, 37, 41, 43]]
    ids, valid = _prefix(rows, 8)
    px = _pixels(7, 2)
    kv_j, pmask_j = _jax_prefill(model, params, ids, px, valid)
    real_f = np.asarray([len(r) - 1 + port.cfg.n_image_tokens
                         for r in rows], np.int32)
    if block is None:
        sfx = np.asarray([[40, 41, 42], [50, 51, 0]], np.int32)
    else:
        sfx = np.asarray([[40, 41, 42, 43, 60, 61, 0, 0],
                          [50, 51, 52, 0, 70, 71, 72, 73]], np.int32)
    smask = sfx != 0
    want = np.asarray(model.apply(
        {"params": params}, jnp.asarray(sfx), kv_j, pmask_j,
        jnp.asarray(smask), jnp.asarray(real_f), method="suffix_logits",
        suffix_block=block))
    with torch.no_grad():
        kv_p, pmask_p = port.prefill(_t(ids), _t(px), _t(valid))
        got = port.suffix_logits(_t(sfx), kv_p, pmask_p, _t(smask),
                                 _t(real_f), suffix_block=block).numpy()
    np.testing.assert_allclose(got[smask], want[smask], **SUFFIX_TOL)


def test_prefill_suffix_equal_the_full_forward(tiny):
    """Inside the port: the suffix pass over a padded prefill's K/V gives
    the full forward's logits at the suffix positions, for a batched
    prefill of two images with per-row prefix lengths (the counterparts
    of test_vqa_prefix.py's prefill / batched-prefill tests)."""
    _, _, port = tiny
    n_image = port.cfg.n_image_tokens
    rows = [[1, 9, IMG, 17, 23], [1, IMG, 31, 37, 41, 43]]
    sfx = np.asarray([[40, 41, 42], [50, 51, 52]], np.int32)
    px = _pixels(11, 2)
    ids, valid = _prefix(rows, 8)
    with torch.no_grad():
        kv, pmask = port.prefill(_t(ids), _t(px), _t(valid))
        real_f = _t(np.asarray([len(r) - 1 + n_image for r in rows]))
        got = port.suffix_logits(_t(sfx), kv, pmask,
                                 torch.ones(2, 3, dtype=torch.bool), real_f)
        for i, r in enumerate(rows):
            full = port(_t([r + list(sfx[i])]), _t(px[i : i + 1]))
            np.testing.assert_allclose(
                got[i].numpy(), full[0, len(r) - 1 + n_image:].numpy(),
                **SUFFIX_TOL)


def test_concatenated_suffix_block_mode(tiny):
    """Inside the port: candidates concatenated in one row with
    suffix_block give the separate-rows logits block by block."""
    _, _, port = tiny
    ids, valid = _prefix([[1, 9, IMG, 17, 23]], 8)
    texts = np.asarray([[40, 41, 42, 43], [50, 51, 52, 53]], np.int32)
    with torch.no_grad():
        kv, pmask = port.prefill(_t(ids), _t(_pixels(13)), _t(valid))
        real_f = 5 - 1 + port.cfg.n_image_tokens
        sep = port.suffix_logits(_t(texts), kv, pmask,
                                 torch.ones(2, 4, dtype=torch.bool), real_f)
        cat = port.suffix_logits(_t(texts.reshape(1, 8)), kv, pmask,
                                 torch.ones(1, 8, dtype=torch.bool), real_f,
                                 suffix_block=4)
    np.testing.assert_allclose(cat.reshape(2, 4, -1).numpy(), sep.numpy(),
                               **SUFFIX_TOL)


def test_prefix_kv_gqa_exactness():
    """Inside the port, under GQA: the trunk's K/V is returned before the
    repeat (kv_heads wide), and the suffix pass over it gives the full
    causal forward's logits."""
    cfg = pllama.LlamaConfig(vocab_size=128, hidden_size=64,
                             intermediate_size=96, num_layers=2,
                             num_heads=8, num_kv_heads=2,
                             max_position_embeddings=64)
    torch.manual_seed(0)
    model = pllama.LlamaForCausalLM(cfg).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    ids = _t(np.random.default_rng(0).integers(1, 120, (2, 12)))
    p_len = 7
    with torch.no_grad():
        want = model(ids)
        _, kv = model.trunk(model.embed(ids[:, :p_len]), sow_kv=True)
        assert kv[0][0].shape[1] == 2
        positions = p_len + torch.arange(12 - p_len).expand(2, -1)
        hidden = model.trunk(model.embed(ids[:, p_len:]), None, positions,
                             prefix_kv=kv)
        got = model.logits(hidden)
    np.testing.assert_allclose(got.numpy(), want[:, p_len:].numpy(),
                               **SUFFIX_TOL)


def _hf_state_dict(jcfg, seed, new_layout):
    """An HF LlavaForConditionalGeneration state dict drawn from a seed,
    in the classic or the newer (``model.*``) key spelling."""
    rng = np.random.default_rng(seed)
    v, l = jcfg.vision, jcfg.llama
    w, d, m = v.width, l.hidden_size, l.intermediate_size

    def r(*shape, std=0.1):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32))

    vis, lm = {}, {}
    vis["embeddings.patch_embedding.weight"] = r(w, 3, 16, 16, std=0.05)
    vis["embeddings.class_embedding"] = r(w)
    vis["embeddings.position_embedding.weight"] = r(v.num_patches + 1, w)
    vis["embeddings.position_ids"] = torch.arange(v.num_patches + 1)[None]
    for ln in ("pre_layrnorm", "post_layernorm"):
        vis[f"{ln}.weight"], vis[f"{ln}.bias"] = 1 + r(w), r(w)
    for i in range(v.layers):
        p = f"encoder.layers.{i}"
        for x in ("q", "k", "v", "out"):
            vis[f"{p}.self_attn.{x}_proj.weight"] = r(w, w)
            vis[f"{p}.self_attn.{x}_proj.bias"] = r(w)
        for ln in ("layer_norm1", "layer_norm2"):
            vis[f"{p}.{ln}.weight"], vis[f"{p}.{ln}.bias"] = 1 + r(w), r(w)
        vis[f"{p}.mlp.fc1.weight"], vis[f"{p}.mlp.fc1.bias"] = r(4 * w, w), r(4 * w)
        vis[f"{p}.mlp.fc2.weight"], vis[f"{p}.mlp.fc2.bias"] = r(w, 4 * w), r(w)
    proj = {"linear_1.weight": r(d, w), "linear_1.bias": r(d),
            "linear_2.weight": r(d, d), "linear_2.bias": r(d)}
    lm["embed_tokens.weight"] = r(l.vocab_size, d)
    lm["norm.weight"] = 1 + r(d)
    for i in range(l.num_layers):
        p = f"layers.{i}"
        for x in ("q", "k", "v", "o"):
            lm[f"{p}.self_attn.{x}_proj.weight"] = r(d, d)
        lm[f"{p}.mlp.gate_proj.weight"] = r(m, d)
        lm[f"{p}.mlp.up_proj.weight"] = r(m, d)
        lm[f"{p}.mlp.down_proj.weight"] = r(d, m)
        lm[f"{p}.input_layernorm.weight"] = 1 + r(d)
        lm[f"{p}.post_attention_layernorm.weight"] = 1 + r(d)
    head = r(l.vocab_size, d)
    sd = {}
    if new_layout:
        sd.update({f"model.vision_tower.vision_model.{k}": t
                   for k, t in vis.items()})
        sd.update({f"model.multi_modal_projector.{k}": t
                   for k, t in proj.items()})
        sd.update({f"model.language_model.{k}": t for k, t in lm.items()})
        sd["lm_head.weight"] = head
    else:
        sd.update({f"vision_tower.vision_model.{k}": t
                   for k, t in vis.items()})
        sd.update({f"multi_modal_projector.{k}": t for k, t in proj.items()})
        sd.update({f"language_model.model.{k}": t for k, t in lm.items()})
        sd["language_model.lm_head.weight"] = head
    return sd


@pytest.mark.parametrize("new_layout", [False, True], ids=["classic", "new"])
def test_hf_weights_give_the_jax_logits(new_layout):
    jcfg = jax_tiny_cfg()
    sd = _hf_state_dict(jcfg, 8, new_layout)
    params = convert_llava_state_dict(sd)
    model = jllava.Llava(jcfg, attn_impl="reference")
    cfg = port_cfg(jcfg)
    port = pllava.Llava(cfg).eval()
    port.load_state_dict(llava_state_dict_from_hf(sd, cfg))
    ids = np.asarray([[1, 9, IMG, 17, 23, 40]], np.int32)
    px = _pixels(9)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(px)))
    with torch.no_grad():
        got = port(_t(ids), _t(px)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_trunk_codes_and_logits_match_jax(tiny):
    """quantize_llava_trunk gives JAX's int8 codes and scales for the
    seven projections of each layer and leaves the rest floating point;
    the dynamic W8A8 model gives JAX's logits, also when it is built from
    JAX's quantised tree."""
    model, params, port = tiny
    jq = jquantize(params)
    qport = quantize_llava_trunk(port)
    sd = qport.state_dict()
    n_q = 0
    for i in range(2):
        layer = jq["language_model"]["model"][f"layers_{i}"]
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                            "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                key = f"language_model.model.layers.{i}.{group}.{name}"
                np.testing.assert_array_equal(
                    sd[key + ".weight_q"].numpy(),
                    np.asarray(layer[group][name]["kernel_q"]).T)
                np.testing.assert_allclose(
                    sd[key + ".scale"].numpy(),
                    np.asarray(layer[group][name]["scale"]), rtol=1e-6)
                assert key + ".bias" not in sd
                n_q += 1
    assert n_q == 14
    assert sd["language_model.lm_head.weight"].dtype == torch.float32
    qmodel = jllava.Llava(jax_tiny_cfg(), attn_impl="reference",
                          quant_llm="dynamic")
    ids = np.asarray([[1, 9, IMG, 17, 23, 40]], np.int32)
    px = _pixels(10)
    want = np.asarray(qmodel.apply({"params": jq}, jnp.asarray(ids),
                                   jnp.asarray(px)))
    from_jax = pllava.Llava(port.cfg, quant_llm="dynamic").eval()
    from_jax.load_state_dict(
        llava_state_dict_from_jax_params(jax.device_get(jq), port.cfg))
    with torch.no_grad():
        for m in (qport, from_jax):
            got = m(_t(ids), _t(px)).numpy()
            np.testing.assert_allclose(got, want, **TOL)


def test_weights_round_trip_between_packages(tiny):
    """The port's model -> the JAX tree (``jax_params_from_llava``) gives
    the JAX model the port's logits, and reads back to the same state."""
    model, _, _ = tiny
    cfg = port_cfg(jax_tiny_cfg())
    port = init_llava(cfg, seed=3, device="cpu", dtype=torch.float32)
    tree = jax_params_from_llava(port)
    ids = np.asarray([[1, 9, IMG, 17, 23, 40]], np.int32)
    px = _pixels(12)
    want = np.asarray(model.apply({"params": tree}, jnp.asarray(ids),
                                  jnp.asarray(px)))
    with torch.no_grad():
        got = port(_t(ids), _t(px)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    back = llava_state_dict_from_jax_params(tree, cfg)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


def test_init_llava_is_seeded_and_in_place():
    cfg = port_cfg(jax_tiny_cfg())
    a = init_llava(cfg, seed=5, device="cpu", dtype=torch.bfloat16)
    b = init_llava(cfg, seed=5, device="cpu", dtype=torch.bfloat16)
    c = init_llava(cfg, seed=6, device="cpu", dtype=torch.bfloat16)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(t.dtype == torch.bfloat16 for t in sa.values())
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["language_model.lm_head.weight"],
                           sc["language_model.lm_head.weight"])
    assert torch.all(sa["language_model.model.norm.weight"] == 1)
    assert torch.all(sa["vision_tower.ln_pre.bias"] == 0)
    std = sa["language_model.model.layers.0.mlp.up_proj.weight"].float().std()
    assert 0.015 < float(std) < 0.025
    assert len(a.vision_tower.transformer.resblocks) == cfg.tower_blocks == 1
