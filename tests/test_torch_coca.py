"""The port's CoCa (``clip_embeds_tpu_torch/models/coca.py``, its loss, train
step, registry entries, factory route, weights and generation) against the
JAX package's, on the CPU in fp32 at a tiny size (a 2-layer 32-px tower,
2-layer text tower and decoder of width 32, 8 pooler queries): both
packages read one open_clip state dict (the JAX side through its own
``convert_coca_state_dict``); and ``cli/train.py`` with CoCa, with the
flags that CoCa's step and distillation would drop exiting in the port
beside the JAX CLI's silent run."""

import functools
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clip_embeds_tpu.core.factory as jax_factory
import clip_embeds_tpu.train.steps as jax_steps
from clip_embeds_tpu.cli.train import main as jax_main
from clip_embeds_tpu.core import openclip_registry as jax_registry
from clip_embeds_tpu.core.config import TextConfig as JText
from clip_embeds_tpu.core.config import VisionConfig as JVision
from clip_embeds_tpu.core.torch_convert import (
    convert_coca_state_dict as jax_convert)
from clip_embeds_tpu.losses.coca import coca_loss as jax_coca_loss
from clip_embeds_tpu.models import coca as jcoca
from clip_embeds_tpu.models import generate as jgen
from clip_embeds_tpu.train.optim import adamw as jax_adamw

from clip_embeds_tpu_torch.cli import train as port_train
from clip_embeds_tpu_torch.core import factory as port_factory
from clip_embeds_tpu_torch.core import openclip_registry as port_registry
from clip_embeds_tpu_torch.core.config import TextConfig, VisionConfig
from clip_embeds_tpu_torch.core.convert import coca_state_dict_from_flax
from clip_embeds_tpu_torch.losses.coca import coca_loss
from clip_embeds_tpu_torch.models import coca as pcoca
from clip_embeds_tpu_torch.models import generate as pgen
from clip_embeds_tpu_torch.train.optim import adamw
from clip_embeds_tpu_torch.train.schedules import const_lr
from clip_embeds_tpu_torch.train.steps import TrainState, make_coca_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
SOT, EOS, VOCAB = 126, 127, 128

# the tiny CoCa of tests/test_train_features.py (a 2-layer 32-px tower at
# patch 8 and width 32, 2-layer text and decoder towers of width 32)
_TINY = dict(
    embed_dim=32,
    vision=dict(image_size=32, patch_size=8, width=32, layers=2,
                head_width=16),
    text=dict(context_length=15, vocab_size=VOCAB, width=32, heads=2,
              layers=2),
    multimodal=dict(context_length=15, width=32, heads=2, layers=2),
    attn_pooler_queries=8, attn_pooler_heads=2)


def jax_cfg(**kw):
    t = dict(_TINY, **kw)
    return jcoca.CoCaConfig(
        embed_dim=t["embed_dim"], vision=JVision(**t["vision"]),
        text=JText(**t["text"]),
        multimodal=jcoca.MultimodalConfig(**t["multimodal"]),
        attn_pooler_queries=t["attn_pooler_queries"],
        attn_pooler_heads=t["attn_pooler_heads"])


def port_cfg(**kw):
    t = dict(_TINY, **kw)
    return pcoca.CoCaConfig(
        embed_dim=t["embed_dim"], vision=VisionConfig(**t["vision"]),
        text=TextConfig(**t["text"]),
        multimodal=pcoca.MultimodalConfig(**t["multimodal"]),
        attn_pooler_queries=t["attn_pooler_queries"],
        attn_pooler_heads=t["attn_pooler_heads"])


def open_clip_state_dict(cfg, seed):
    """A seeded open_clip CoCa state dict: the port's init, every entry
    then moved by N(0, 0.05) (norms, biases and the scale off their init
    values, so a dropped one shows)."""
    with torch.device("meta"):
        model = pcoca.CoCa(cfg)
    model.to_empty(device="cpu")
    port_factory.init_coca(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return {k: v + torch.from_numpy(np.asarray(
        0.05 * rng.standard_normal(v.shape), np.float32))
        for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def tiny():
    """(JAX CoCa, its params, the port's CoCa) from one open_clip state
    dict."""
    sd = open_clip_state_dict(port_cfg(), 0)
    port = pcoca.CoCa(port_cfg()).eval()
    port.load_state_dict(sd)
    return jcoca.CoCa(jax_cfg(), attn_impl="reference"), jax_convert(sd), port


def _batch(seed, b=3):
    """Images, and texts with SOT, a few tokens, EOT, then pads."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    texts = np.zeros((b, 15), np.int64)
    for i, n in enumerate(rng.integers(4, 14, b)):
        texts[i, 0] = SOT
        texts[i, 1:n] = rng.integers(1, 120, n - 1)
        texts[i, n] = EOS
    return images, texts


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype in (torch.int32, torch.int64) else t


def _apply(model, params, *args, **kw):
    return jax.tree.map(np.asarray, model.apply({"params": params}, *args,
                                                **kw))


def _k_bias(path) -> bool:
    """A key projection's bias: it shifts all of a query's logits alike,
    so its true gradient is 0, and Adam scales each package's rounding
    noise in it (~1e-8) to updates of the learning rate's order."""
    keys = [getattr(p, "key", "") for p in path]
    return keys[-2:] in (["in_proj", "bias"], ["k_proj", "bias"]) or \
        keys[-1] == "in_proj_bias"


def assert_params_close(port_model, jax_params, **tol):
    """The port's parameters (as a flax tree) against JAX's, leaf by leaf;
    of a key bias only the query and value thirds of a packed one."""
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jax_params))
    got = jax.tree.leaves(jax_convert(port_model.state_dict()))
    for (path, b), a in zip(want, got):
        if _k_bias(path):
            packed = "in_proj" in str(path)
            d = len(a) // 3
            a, b = (np.concatenate([x[:d], x[2 * d:]]) if packed else x[:0]
                    for x in (a, b))
        np.testing.assert_allclose(a, b, err_msg=str(path), **tol)


def test_towers_pooler_and_forward_match_jax(tiny):
    """Every tower, the pooler alone, caption_logits, forward and
    coca_loss against JAX's (one jitted JAX function computes them all)."""
    model, params, port = tiny
    images, texts = _batch(1)
    rows = images.reshape(3, 96, 32)

    @jax.jit
    def jax_outputs(p, im, ids, rows):
        def run(method, *a):
            return model.apply({"params": p}, *a, method=method)

        _, embs = run("image_tokens", im)
        out = model.apply({"params": p}, im, ids)
        return {
            "image_tokens": run("image_tokens", im),
            "text": run(lambda m, x: m.text(x), ids),
            "pooler": jcoca.AttentionalPooler(32, 32, 2, 8).apply(
                {"params": p["visual"]["attn_pool"]}, rows),
            "encode_image": run("encode_image", im),
            "encode_text": run("encode_text", ids),
            "caption_logits": run("caption_logits", embs, ids),
            "forward": out,
            "loss": jax_coca_loss(out, 2.0, 1.0),
        }

    want = jax.tree.map(np.asarray, jax_outputs(
        params, jnp.asarray(images), jnp.asarray(texts, jnp.int32),
        jnp.asarray(rows)))
    with torch.no_grad():
        im, ids = _t(images), _t(texts)
        out = port(im, ids)
        got = {
            "image_tokens": port.image_tokens(im),
            "text": port.text(ids),
            "pooler": port.visual.attn_pool(_t(rows)),
            "encode_image": port.encode_image(im),
            "encode_text": port.encode_text(ids),
            "caption_logits": port.caption_logits(port.image_tokens(im)[1],
                                                  ids),
            "forward": out,
            "loss": coca_loss(out, 2.0, 1.0),
        }
    assert set(got["forward"]) == set(want["forward"])
    for name in want:
        for (path, w), g in zip(
                jax.tree_util.tree_leaves_with_path(want[name]),
                jax.tree.leaves(got[name])):
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"{name} {path}",
                                       **TOL)


def test_text_mask_hides_pads_from_the_cls_row_only():
    ids = torch.tensor([[5, 6, 0, 0]])
    mask = pcoca.text_attention_mask(ids, 0)[0, 0]
    torch.testing.assert_close(mask[:-1], torch.ones(4, 5).tril().bool())
    assert mask[-1].tolist() == [True, True, True, False, False]


def test_weights_carry_both_ways(tiny):
    """JAX's convert_coca_state_dict reads the port's state dict; a flax
    tree (JAX's own init shapes, filled from a seed) carries into the port
    through coca_state_dict_from_flax and back unchanged, and the port
    then gives the JAX model's outputs."""
    model, params, port = tiny
    sd = port.state_dict()
    mine = jax_convert(sd)
    assert jax.tree.structure(mine) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    images, texts = _batch(2)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.asarray(images), jnp.asarray(texts, jnp.int32)),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)
                                   ).astype(np.float32), shapes)
    other = pcoca.CoCa(port_cfg()).eval()
    other.load_state_dict(coca_state_dict_from_flax(tree))
    for a, b in zip(jax.tree.leaves(jax_convert(other.state_dict())),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        got = other(_t(images), _t(texts))
    want = jax.tree.map(np.asarray, jax.jit(
        lambda p, im, ids: model.apply({"params": p}, im, ids))(
            tree, jnp.asarray(images), jnp.asarray(texts, jnp.int32)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)


def test_factory_routes_coca_names(coca_tiny):
    """create_model routes a registry CoCa name to create_coca_model: the
    config resolved from the entry, seeded weights that one seed repeats,
    and an open_clip state dict loaded from a path."""
    model = port_factory.create_model("coca_tiny", seed=0, device="cpu")
    assert type(model).__name__ == "CoCa" and not model.training
    assert model.cfg == port_registry.resolve_coca_config("coca_tiny")
    again = port_factory.create_coca_model("coca_tiny", seed=0)
    other = port_factory.create_coca_model("coca_tiny", seed=1)
    loaded = port_factory.create_model("coca_tiny", coca_tiny, train=True)
    assert loaded.training
    saved = torch.load(coca_tiny, weights_only=True)
    for k, a in model.state_dict().items():
        assert torch.equal(a, again.state_dict()[k]), k
        assert torch.equal(loaded.state_dict()[k], saved[k]), k
    assert not torch.equal(model.text.cls_emb, other.text.cls_emb)


def test_train_step_matches_jax(tiny):
    """One AdamW step of the port's make_coca_train_step against JAX's:
    the losses and every updated parameter within 1e-5 (of the key biases
    the query and value thirds, :func:`_k_bias`)."""
    model, params, port = tiny
    images, texts = _batch(4, b=4)
    step = jax.jit(jax_steps.make_coca_train_step(model, 2.0, 1.0))
    jstate = jax_steps.TrainState.create(params,
                                         jax_adamw(1e-3, weight_decay=0.1))
    jstate, jmetrics = step(jstate, {"images": jnp.asarray(images),
                                     "texts": jnp.asarray(texts, jnp.int32)})
    student = pcoca.CoCa(port_cfg())
    student.load_state_dict(port.state_dict())
    state = TrainState(student, adamw(student, 1e-3, weight_decay=0.1),
                       const_lr(1e-3, 0))
    metrics = make_coca_train_step(student, 2.0, 1.0)(
        state, {"images": _t(images), "texts": _t(texts)})
    for k in ("loss", "contrastive_loss", "caption_loss", "logit_scale"):
        np.testing.assert_allclose(metrics[k].numpy(),
                                   np.asarray(jmetrics[k]), err_msg=k, **TOL)
    assert_params_close(student, jstate.params, **TOL)


# -- generation ----------------------------------------------------------------


_GEN = dict(seq_len=10, sot_token_id=SOT, eos_token_id=EOS, pad_token_id=0,
            min_seq_len=3)


def test_top_k_1_and_beam_tokens_match_jax(tiny):
    """With the repetition penalty on (1.5), so every processor runs."""
    model, params, port = tiny
    penalty = 1.5
    images = _batch(5, b=3)[0]
    want = np.asarray(jgen.coca_sample_generate(
        model, params, jnp.asarray(images), jax.random.PRNGKey(0),
        generation_type="top_k", top_k=1, repetition_penalty=penalty,
        **_GEN))
    got = pgen.coca_sample_generate(port, _t(images), None,
                                    generation_type="top_k", top_k=1,
                                    repetition_penalty=penalty, **_GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jgen.coca_beam_generate(
        model, params, jnp.asarray(images), num_beams=4,
        repetition_penalty=penalty, **_GEN))
    got = pgen.coca_beam_generate(port, _t(images), num_beams=4,
                                  repetition_penalty=penalty, **_GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_p_tokens_are_well_formed_and_repeat(tiny):
    _, _, port = tiny
    images = _t(_batch(6, b=4)[0])

    def run(seed):
        return pgen.coca_sample_generate(
            port, images, torch.Generator().manual_seed(seed), top_p=0.9,
            **_GEN).numpy()

    out = run(7)
    np.testing.assert_array_equal(out, run(7))
    assert out.shape == (4, 10) and (out[:, 0] == SOT).all()
    assert ((out >= 0) & (out < VOCAB)).all()
    assert not (out[:, 1:3] == EOS).any()  # min length
    for row in out:
        (stop,) = np.flatnonzero(row == EOS)[:1]  # eos, at the end at last
        assert (row[stop + 1:] == 0).all()


# -- the training CLI ----------------------------------------------------------


_CLI_CFG = {
    "embed_dim": 32, "custom_text": True,
    "multimodal_cfg": {"context_length": 15, "width": 32, "heads": 2,
                       "layers": 2, "vocab_size": 49408},
    "text_cfg": {"context_length": 15, "vocab_size": 49408, "width": 32,
                 "heads": 2, "layers": 2, "embed_cls": True},
    "vision_cfg": {"image_size": 32, "patch_size": 8, "width": 32,
                   "layers": 2, "head_width": 16, "attn_pooler_queries": 8,
                   "attn_pooler_heads": 2},
}
CLI = ["--model", "coca_tiny", "--dataset-type", "synthetic",
       "--precision", "fp32", "--batch-size", "8", "--train-num-samples",
       "16", "--lr", "1e-3", "--warmup", "1", "--log-every", "1"]


@pytest.fixture()
def coca_tiny(monkeypatch, tmp_path):
    """'coca_tiny' in both packages' registries, and a seeded open_clip
    state dict of it on disk, which both CLIs read."""
    for reg in (jax_registry, port_registry):
        monkeypatch.setitem(reg._registry()["model_configs"], "coca_tiny",
                            _CLI_CFG)
    cfg = port_registry.resolve_coca_config("coca_tiny")
    path = tmp_path / "coca_tiny.pt"
    torch.save(open_clip_state_dict(cfg, 9), path)
    return str(path)


def _losses(text):
    return [float(x) for x in re.findall(r"step \d+ loss (\S+)", text)]


def test_cli_runs_coca_as_jax(coca_tiny, caplog):
    """Both CLIs, one step with both loss weights: the logged losses
    within 1e-4, and every parameter as in test_torch_train_cli (of the
    key biases the query and value thirds)."""
    argv = CLI + ["--pretrained", coca_tiny, "--train-num-samples", "8",
                  "--coca-caption-loss-weight", "1.5",
                  "--coca-contrastive-loss-weight", "0.5"]
    with caplog.at_level(logging.INFO):
        state = port_train.main(argv + ["--device", "cpu"])
    port_losses = _losses(caplog.text)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        jstate = jax_main(argv)
    jax_losses = _losses(caplog.text)
    assert type(state.model).__name__ == "CoCa"
    assert state.step == int(jstate.step) == 1 and len(port_losses) == 1
    # within 1e-4, as the CLIs log them (4 decimals): two roundings of
    # values 1e-6 apart may land one unit of the last place apart
    np.testing.assert_allclose(port_losses, jax_losses, rtol=0,
                               atol=1.0001e-4)
    assert_params_close(state.model, jstate.params, rtol=1e-4, atol=2e-5)


# (flags, the route) that the port refuses where JAX runs on without them
_DROPPED = {
    "coca --force-patch-dropout": (["--force-patch-dropout", "0.5"], "coca"),
    "coca --fused-train-blocks": (["--fused-train-blocks"], "coca"),
    "coca --grad-checkpointing": (["--grad-checkpointing"], "coca"),
    "coca --siglip": (["--siglip"], "coca"),
    "coca --usehardtext": (["--usehardtext"], "coca"),
    "coca --grad-cache-chunks": (["--grad-cache-chunks", "2"], "coca"),
    "coca --accum-freq": (["--accum-freq", "2"], "coca"),
    "distill --siglip": (["--siglip"], "distill"),
    "distill --usehardtext": (["--usehardtext"], "distill"),
    "distill --grad-cache-chunks": (["--grad-cache-chunks", "2"], "distill"),
    "distill --accum-freq": (["--accum-freq", "2"], "distill"),
}


@functools.lru_cache(maxsize=1)
def _jax_tiny_clip_shapes():
    from clip_embeds_tpu.core.config import get_model_config
    from clip_embeds_tpu.models.clip import CLIP

    cfg = get_model_config("test-tiny")
    model = CLIP(cfg)
    return model, jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, cfg.text.context_length), jnp.int32)),
        jax.random.PRNGKey(0))["params"]


def jax_tiny_clip():
    """The JAX test-tiny CLIP and zero params of its shapes (from
    ``jax.eval_shape``: nothing compiles), fresh for each call (the CLI
    donates them): the stubbed CLI's student and teacher."""
    model, shapes = _jax_tiny_clip_shapes()
    return model, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                               shapes)


@pytest.mark.parametrize("name", sorted(_DROPPED))
def test_dropped_flags_exit_beside_jax_silent_run(name, coca_tiny,
                                                  monkeypatch):
    """The JAX CLI runs its CoCa or distillation step with the flag and
    never hands it on: its factory and step factory are recorded (and
    stubbed, so nothing compiles) and take none of it. The port exits
    before the first step, naming the flag."""
    flags, route = _DROPPED[name]
    calls = []

    def stub_step(*args, **kw):
        calls.append(kw)
        return lambda state, *rest: (state.replace(step=state.step + 1),
                                     {"loss": jnp.zeros(())})

    if route == "coca":
        # batch 32: --usehardtext's 8 hard rows shard over JAX's 8 devices
        argv = CLI + ["--pretrained", coca_tiny, "--batch-size", "32",
                      "--train-num-samples", "32"] + flags
        real = jax_factory.create_coca_model

        def recorded(*args, **kw):
            calls.append(kw)
            return real(*args, **kw)

        monkeypatch.setattr(jax_factory, "create_coca_model", recorded)
        monkeypatch.setattr(jax_steps, "make_coca_train_step", stub_step)
        want_kw = [{"dtype", "seed", "force_quick_gelu"},
                   {"caption_loss_weight", "clip_loss_weight"}]
    else:
        argv = ["--model", "test-tiny", "--dataset-type", "synthetic",
                "--precision", "fp32", "--batch-size", "32",
                "--train-num-samples", "32", "--distill-model", "test-tiny",
                "--distill-pretrained", "openai"] + flags
        monkeypatch.setattr(jax_steps, "make_distill_train_step", stub_step)
        monkeypatch.setattr(jax_factory, "create_model",
                            lambda *a, **kw: jax_tiny_clip())
        want_kw = [set()]
    state = jax_main(argv)
    assert int(state.step) == 1
    assert [set(kw) for kw in calls] == want_kw
    with pytest.raises(SystemExit, match=re.escape(flags[0])):
        port_train.main(argv + ["--device", "cpu"])
