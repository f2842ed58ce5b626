"""The port's decode KV cache and generation (``clip_embeds_tpu_torch/models/
{llama,generate}.py``) against the JAX package, on the CPU in fp32 at a
tiny size (``llama_tiny_config``, a GQA and an M-RoPE variant, the tiny
LLaVA): the cached logits step by step against JAX's ``trunk(decode=True)``
fed at positions ``n + step``, greedy tokens against that loop and the
argmax of JAX's teacher-forced full forward, the two JAX generate faults
beside the port, W8A8 decoding, and the logits processors, ties
included."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.models import generate as jgen
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.models import llava as jllava
from clip_embeds_tpu.models.quant import quantize_llava_trunk as jquantize
from clip_embeds_tpu.scores.build import config_to_dict

from clip_embeds_tpu_torch.core.convert import (
    state_dict_from_flax, vlm_state_dict_from_jax_params)
from clip_embeds_tpu_torch.models import generate as pgen
from clip_embeds_tpu_torch.models import llama as pllama
from clip_embeds_tpu_torch.models import llava as pllava
from clip_embeds_tpu_torch.models.quant import quantize_llava_trunk
from clip_embeds_tpu_torch.scores.build import config_from_dict

TOL = dict(rtol=1e-5, atol=1e-5)
IMG = jllava.IMAGE_TOKEN_INDEX
STEPS = 8


def filled(model, seed, *args):
    """Seeded numpy params for ``model.init(key, *args)``'s tree, built
    from ``jax.eval_shape`` (no init runs): kernels at fan_in^-1/2, norms
    near one, the rest spread."""
    shapes = jax.eval_shape(lambda k: model.init(k, *args),
                            jax.random.PRNGKey(0))["params"]
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
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def llama_pair(seed=0, **kw):
    """(JAX LM, its params, the port's LM on the same weights)."""
    cfg = jllama.LlamaConfig(**{**config_to_dict(jllama.llama_tiny_config()),
                                **kw})
    model = jllama.LlamaForCausalLM(cfg, attn_impl="reference")
    params = filled(model, seed, jnp.zeros((1, 4), jnp.int32))
    port = pllama.LlamaForCausalLM(
        config_from_dict(pllama.LlamaConfig, config_to_dict(cfg))).eval()
    port.load_state_dict(state_dict_from_flax(params))
    return model, params, port


def jax_cached_decode(lm, params, embeds, steps, positions=None,
                      step_positions=None):
    """JAX's decode trunk run the way the port's greedy loop runs it: the
    prompt embeddings prefill the cache at ``positions`` (default
    0..n-1), then each argmax token is fed at ``step_positions(step)``
    (default n + step). -> (tokens [B, steps], logits [steps, B, V])."""
    b, n = embeds.shape[:2]
    if positions is None:
        positions = jnp.broadcast_to(jnp.arange(n)[None], (b, n))
    if step_positions is None:
        def step_positions(step):
            return jnp.full((b, 1), n + step, jnp.int32)

    @jax.jit
    def run(e, pos, cache):
        h, upd = lm.apply({"params": params, "cache": cache}, e, None, pos,
                          True, method="trunk", mutable=["cache"])
        logits = lm.apply({"params": params}, h[:, -1:], method="logits")
        return logits[:, 0], upd["cache"]

    embed = jax.jit(lambda ids: lm.apply({"params": params}, ids,
                                         method="embed"))
    logits, cache = run(jnp.asarray(embeds), positions,
                        jgen.init_cache(lm, b))
    out, tokens = [np.asarray(logits)], [np.asarray(logits.argmax(-1))]
    for step in range(steps - 1):
        e = embed(jnp.asarray(tokens[-1])[:, None])
        logits, cache = run(e, step_positions(step), cache)
        out.append(np.asarray(logits))
        tokens.append(np.asarray(logits.argmax(-1)))
    return np.stack(tokens, 1), np.stack(out)


def port_cached_decode(lm, embeds, steps, positions=None,
                       step_positions=None, max_len=None):
    """The same loop through the port's trunk and KVCache."""
    b, n = embeds.shape[:2]
    if positions is None:
        positions = torch.arange(n).expand(b, n)
    if step_positions is None:
        def step_positions(step):
            return torch.full((b, 1), n + step)
    with torch.no_grad():
        cache = pgen.init_cache(lm, b, max_len)
        h, cache = lm.trunk(embeds, None, positions, cache=cache)
        logits = lm.logits(h[:, -1])
        out, tokens = [logits.numpy()], [logits.argmax(-1)]
        for step in range(steps - 1):
            h, cache = lm.trunk(lm.embed(tokens[-1][:, None]), None,
                                step_positions(step), cache=cache)
            logits = lm.logits(h[:, -1])
            out.append(logits.numpy())
            tokens.append(logits.argmax(-1))
    assert cache.index == n + steps - 1
    return torch.stack(tokens, 1).numpy(), np.stack(out)


def teacher_forced_argmax(lm, params, prompt, tokens):
    """Argmax of JAX's full forward over prompt + tokens at the positions
    that predict each token."""
    seq = np.concatenate([prompt, tokens], 1).astype(np.int32)
    logits = np.asarray(lm.apply({"params": params}, jnp.asarray(seq)))
    n = prompt.shape[1]
    return logits[:, n - 1:n - 1 + tokens.shape[1]].argmax(-1)


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_cached_decode_matches_jax_step_by_step(kv_heads):
    """Per step, the port's cached logits equal JAX's decode trunk fed at
    positions n + step (the prefill too: the port's causal route over the
    prompt against JAX's plain attention over the whole cache); the port's
    greedy tokens equal that loop's and the argmax of JAX's full forward
    over prompt + tokens."""
    model, params, port = llama_pair(num_kv_heads=kv_heads)
    prompt = np.random.default_rng(1).integers(1, 500, (2, 7))
    embeds = np.asarray(model.apply({"params": params},
                                    jnp.asarray(prompt, jnp.int32),
                                    method="embed"))
    want_tok, want_logits = jax_cached_decode(model, params, embeds, STEPS)
    got_tok, got_logits = port_cached_decode(port, _t(embeds), STEPS)
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    np.testing.assert_array_equal(got_tok, want_tok)
    greedy = pgen.greedy_generate(port, _t(prompt), STEPS).numpy()
    np.testing.assert_array_equal(greedy, want_tok)
    np.testing.assert_array_equal(
        greedy, teacher_forced_argmax(model, params, prompt, greedy))


def test_jax_greedy_generate_positions_fault_beside_the_port():
    """JAX's greedy_generate feeds step s at RoPE position n + s + 1, one
    past its cache slot: its tokens leave the argmax of JAX's own full
    forward from the second token on; the port's (position n + s) keep
    it at every step."""
    model, params, port = llama_pair()
    prompt = np.random.default_rng(1).integers(1, 500, (2, 7))
    jax_tok = np.asarray(jgen.greedy_generate(
        model, params, jnp.asarray(prompt, jnp.int32), STEPS))
    teacher = teacher_forced_argmax(model, params, prompt, jax_tok)
    np.testing.assert_array_equal(jax_tok[:, 0], teacher[:, 0])
    assert (jax_tok[:, 1:] != teacher[:, 1:]).any()
    greedy = pgen.greedy_generate(port, _t(prompt), STEPS).numpy()
    np.testing.assert_array_equal(
        greedy, teacher_forced_argmax(model, params, prompt, greedy))
    assert not np.array_equal(greedy, jax_tok)


def test_mrope_positions_decode_as_jax():
    """[B, 3, N] (t, h, w) positions through the cache on an M-RoPE trunk:
    the port's per-step logits equal JAX's decode trunk's."""
    model, params, port = llama_pair(seed=2, num_kv_heads=2,
                                     mrope_section=(2, 2, 4))
    rng = np.random.default_rng(3)
    b, n = 2, 6
    embeds = rng.standard_normal((b, n, 64)).astype(np.float32)
    pos = rng.integers(0, 20, (b, 3, n)).astype(np.int32)
    steps = np.cumsum(rng.integers(1, 3, (STEPS, b, 3)), 0) + 20

    want_tok, want_logits = jax_cached_decode(
        model, params, embeds, STEPS, positions=jnp.asarray(pos),
        step_positions=lambda s: jnp.asarray(steps[s, :, :, None],
                                             jnp.int32))
    got_tok, got_logits = port_cached_decode(
        port, _t(embeds), STEPS, positions=_t(pos),
        step_positions=lambda s: _t(steps[s, :, :, None]).long())
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    np.testing.assert_array_equal(got_tok, want_tok)


def test_cache_size_leaves_the_tokens():
    """A cache of max_position_embeddings slots and greedy_generate's of
    prompt + new tokens give the same tokens (masked slots weigh exactly
    zero); a chunk past the cache raises."""
    _, _, port = llama_pair()
    prompt = _t(np.random.default_rng(4).integers(1, 500, (3, 5)))
    short = pgen.greedy_generate(port, prompt, STEPS)
    assert pgen.init_cache(port, 3).max_len == 128
    with torch.no_grad():
        embeds = port.embed(prompt)
    full, _ = port_cached_decode(port, embeds, STEPS, max_len=128)
    np.testing.assert_array_equal(short.numpy(), full)
    with pytest.raises(ValueError, match="KV cache holds 4 slots"):
        port_cached_decode(port, embeds, STEPS, max_len=4)


def test_eos_pads_and_stops():
    """JAX's eos semantics: a row that emits eos is padded with eos after,
    the others decode on unchanged."""
    _, _, port = llama_pair()
    prompt = _t(np.random.default_rng(5).integers(1, 500, (3, 5)))
    free = pgen.greedy_generate(port, prompt, STEPS)
    eos = int(free[0, 2])
    got = pgen.greedy_generate(port, prompt, STEPS, eos_token_id=eos)
    for row, tokens in zip(got, free):
        stop = next((i for i, t in enumerate(tokens) if t == eos), None)
        if stop is None:
            torch.testing.assert_close(row, tokens, rtol=0, atol=0)
        else:
            torch.testing.assert_close(row[:stop + 1], tokens[:stop + 1],
                                       rtol=0, atol=0)
            assert (row[stop + 1:] == eos).all()


# -- LLaVA ---------------------------------------------------------------------


def jax_tiny_llava():
    return jllava.LlavaConfig(
        llama=jllama.LlamaConfig(vocab_size=256, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=4, max_position_embeddings=256),
        vision=JVisionConfig(image_size=32, patch_size=16, width=64,
                             layers=2, head_width=32))


@pytest.fixture(scope="module")
def llava():
    jcfg = jax_tiny_llava()
    model = jllava.Llava(jcfg, attn_impl="reference")
    rng = np.random.default_rng(0)
    params = filled(model, 1, jnp.asarray([[1, IMG, 5, 6]], jnp.int32),
                    jnp.zeros((1, 32, 32, 3), jnp.float32))
    cfg = config_from_dict(pllava.LlavaConfig, config_to_dict(jcfg))
    port = pllava.Llava(cfg).eval()
    port.load_state_dict(vlm_state_dict_from_jax_params(params, cfg))
    ids = np.asarray([[1, 9, IMG, 17, 23, 40], [1, 3, IMG, 8, 2, 11]],
                     np.int32)
    px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return model, params, port, ids, px


def _jax_embeds(model, params, ids, px):
    feats = model.apply({"params": params}, jnp.asarray(px),
                        method="encode_images")
    return np.asarray(model.apply({"params": params}, jnp.asarray(ids),
                                  feats, method="merge"))


def test_llava_greedy_generate_matches_jax_loop(llava):
    model, params, port, ids, px = llava
    lm = jllama.LlamaForCausalLM(model.cfg.llama, attn_impl="reference")
    want, _ = jax_cached_decode(lm, params["language_model"],
                                _jax_embeds(model, params, ids, px), STEPS)
    got = pgen.llava_greedy_generate(port, _t(ids), _t(px), STEPS).numpy()
    np.testing.assert_array_equal(got, want)


def test_w8a8_llava_decodes_as_jax_and_jax_generate_raises(llava):
    """On the dynamic W8A8 trunk the port's tokens equal the JAX loop over
    LlamaForCausalLM(quant='dynamic') with the same merged embeddings;
    JAX's llava_greedy_generate rebuilds an unquantised LM and cannot
    find its float kernels in the int8 tree."""
    model, params, port, ids, px = llava
    jq = jquantize(params)
    lm = jllama.LlamaForCausalLM(model.cfg.llama, attn_impl="reference",
                                 quant="dynamic")
    want, _ = jax_cached_decode(lm, jq["language_model"],
                                _jax_embeds(model, jq, ids, px), STEPS)
    qport = quantize_llava_trunk(port)
    got = pgen.llava_greedy_generate(qport, _t(ids), _t(px), STEPS).numpy()
    np.testing.assert_array_equal(got, want)
    qmodel = jllava.Llava(model.cfg, attn_impl="reference",
                          quant_llm="dynamic")
    with pytest.raises(flax.errors.ScopeParamNotFoundError,
                       match="q_proj"):
        jgen.llava_greedy_generate(qmodel, jq, jnp.asarray(ids),
                                   jnp.asarray(px), STEPS)


# -- logits processors ---------------------------------------------------------


def _logits_with_ties(seed, b=3, v=12):
    """Random logits of coarse values (0.5 steps), so rows hold ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-6, 7, (b, v)) * 0.5).astype(np.float32)


def test_min_length_process_matches_jax():
    x = _logits_with_ties(0)
    for cur_len in (2, 5, 6):
        want = jgen.min_length_process(jnp.asarray(x), cur_len, 5, 3)
        got = pgen.min_length_process(_t(x), cur_len, 5, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("penalty", [1.0, 1.3, 0.7])
def test_repetition_penalty_matches_jax(penalty):
    x = _logits_with_ties(1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 12, (3, 6)).astype(np.int32)
    tokens[0, :3] = 4  # repeated, and beside invalid slots of the same id
    tokens[0, 5] = 4
    valid = np.arange(6)[None, :] < 4
    want = jgen.repetition_penalty_process(
        jnp.asarray(x), jnp.asarray(tokens), jnp.asarray(valid), penalty)
    got = pgen.repetition_penalty_process(_t(x), _t(tokens), _t(valid),
                                          penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3, 12])
def test_top_k_warp_matches_jax_with_ties(k):
    x = _logits_with_ties(3)
    want = jgen.top_k_warp(jnp.asarray(x), k)
    got = pgen.top_k_warp(_t(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 1.0])
def test_top_p_warp_matches_jax_with_ties(p):
    x = _logits_with_ties(4)
    x[1] = 1.0  # a row of one value: every order is a tie
    want = jgen.top_p_warp(jnp.asarray(x), p)
    got = pgen.top_p_warp(_t(x), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
