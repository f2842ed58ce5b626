"""The SigLIP slice of the port against the JAX package, fp32 on the CPU, at
a tiny config whose head dim is not a power of two (width 144, 2 heads:
72, as ViT-SO400M-14-SigLIP-384) and whose MLP width is not a multiple of
32 (208): the composable model, the weights carried across, the seven
serving functions (the JAX ones with their Pallas kernels in interpret
mode), the sigmoid loss and the ``--siglip`` train step, the tokenizer,
the registry, ``SiglipScorer`` and both CLIs; and the kernel gate, which
must take every shape the JAX package's gate takes."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli import eval as jax_eval
from clip_embeds_tpu.core import openclip_registry as jax_registry
from clip_embeds_tpu.losses.siglip import siglip_loss as jax_siglip_loss
from clip_embeds_tpu.models import serving as jax_serving
from clip_embeds_tpu.models import siglip as jax_siglip
from clip_embeds_tpu.ops.fused_block import (
    fused_block_supported as jax_gate,
)
from clip_embeds_tpu.scores.scorers import SiglipScorer as JaxSiglipScorer
from clip_embeds_tpu.text import tokenizer as jax_tokenizer
from clip_embeds_tpu.text import unigram as jax_unigram
from clip_embeds_tpu_torch.cli import eval as port_eval
from clip_embeds_tpu_torch.cli import train as port_train
from clip_embeds_tpu_torch.core import config as port_config
from clip_embeds_tpu_torch.core import openclip_registry as port_registry
from clip_embeds_tpu_torch.core.convert import (
    siglip_state_dict_from_hf,
    state_dict_from_flax,
)
from clip_embeds_tpu_torch.losses.siglip import siglip_loss
from clip_embeds_tpu_torch.models import serving
from clip_embeds_tpu_torch.models import siglip as port_siglip
from clip_embeds_tpu_torch.ops.fused_block import fused_block_supported
from clip_embeds_tpu_torch.scores.scorers import SiglipScorer
from clip_embeds_tpu_torch.text import tokenizer as port_tokenizer
from clip_embeds_tpu_torch.text import unigram as port_unigram
from test_torch_ops import _pallas_interpret

VISION = dict(image_size=42, patch_size=14, width=144, layers=2, heads=2,
              intermediate_size=208)
TEXT = dict(vocab_size=64, width=144, layers=2, heads=2,
            intermediate_size=208, max_position_embeddings=16)


def _configs(mod):
    return mod.SiglipConfig(mod.SiglipVisionConfig(**VISION),
                            mod.SiglipTextConfig(**TEXT))


@pytest.fixture(scope="module")
def models():
    """JAX and port tiny Siglips on one set of weights: a flax init with
    every parameter moved by noise (biases non-zero, LayerNorms off 1)."""
    jm = jax_siglip.Siglip(_configs(jax_siglip), attn_impl="reference")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 42, 42, 3)),
                     jnp.zeros((1, 16), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)
    tm = port_siglip.Siglip(_configs(port_siglip))
    tm.load_state_dict(state_dict_from_flax(params, packed_in_proj=False))
    return jm, params, tm.eval()


def _inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 42, 42, 3)).astype(np.float32),
            rng.integers(0, 64, (b, 16)).astype(np.int32))


def test_composable_model_matches_jax(models):
    jm, params, tm = models
    images, ids = _inputs(1)
    want = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(ids))
        img = tm.encode_image(torch.from_numpy(images), normalize=False)
        txt = tm.encode_text(torch.from_numpy(ids), normalize=False)
    for k in ("image_features", "text_features", "logits_per_text",
              "logit_scale", "logit_bias"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(img.numpy(), np.asarray(jm.apply(
        {"params": params}, jnp.asarray(images), normalize=False,
        method="encode_image")), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jm.apply(
        {"params": params}, jnp.asarray(ids), normalize=False,
        method="encode_text")), rtol=1e-5, atol=1e-5)


def _hf_state_dict(rng):
    """A random HF SiglipModel state dict of the tiny config's shapes."""
    w, mlp, p = 144, 208, 14
    sd = {}

    def put(key, *shape):
        sd[key] = torch.from_numpy(
            0.1 * rng.standard_normal(shape).astype(np.float32))

    for tower in ("vision_model", "text_model"):
        for i in range(2):
            pre = f"{tower}.encoder.layers.{i}"
            for x in "qkv":
                put(f"{pre}.self_attn.{x}_proj.weight", w, w)
                put(f"{pre}.self_attn.{x}_proj.bias", w)
            put(f"{pre}.self_attn.out_proj.weight", w, w)
            put(f"{pre}.self_attn.out_proj.bias", w)
            for ln in ("layer_norm1", "layer_norm2"):
                put(f"{pre}.{ln}.weight", w)
                put(f"{pre}.{ln}.bias", w)
            put(f"{pre}.mlp.fc1.weight", mlp, w)
            put(f"{pre}.mlp.fc1.bias", mlp)
            put(f"{pre}.mlp.fc2.weight", w, mlp)
            put(f"{pre}.mlp.fc2.bias", w)
    put("vision_model.embeddings.patch_embedding.weight", w, 3, p, p)
    put("vision_model.embeddings.patch_embedding.bias", w)
    put("vision_model.embeddings.position_embedding.weight", 9, w)
    sd["vision_model.embeddings.position_ids"] = torch.arange(9)[None]
    for key in ("vision_model.post_layernorm", "vision_model.head.layernorm",
                "text_model.final_layer_norm"):
        put(key + ".weight", w)
        put(key + ".bias", w)
    put("vision_model.head.probe", 1, 1, w)
    put("vision_model.head.attention.in_proj_weight", 3 * w, w)
    put("vision_model.head.attention.in_proj_bias", 3 * w)
    put("vision_model.head.attention.out_proj.weight", w, w)
    put("vision_model.head.attention.out_proj.bias", w)
    put("vision_model.head.mlp.fc1.weight", mlp, w)
    put("vision_model.head.mlp.fc1.bias", mlp)
    put("vision_model.head.mlp.fc2.weight", w, mlp)
    put("vision_model.head.mlp.fc2.bias", w)
    put("text_model.embeddings.token_embedding.weight", 64, w)
    put("text_model.embeddings.position_embedding.weight", 16, w)
    put("text_model.head.weight", w, w)
    put("text_model.head.bias", w)
    put("logit_scale", 1)
    put("logit_bias", 1)
    return sd


def test_hf_loader_matches_jax_converter():
    """One random HF state dict through the port's loader and through JAX's
    convert_siglip_state_dict (then across): the same tensors, and a model
    that loads them strictly."""
    sd = _hf_state_dict(np.random.default_rng(2))
    got = siglip_state_dict_from_hf(sd)
    want = state_dict_from_flax(jax_siglip.convert_siglip_state_dict(sd),
                                packed_in_proj=False)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    port_siglip.Siglip(_configs(port_siglip)).load_state_dict(got)


# -- serving -------------------------------------------------------------


def test_fused_encode_siglip_matches_jax(monkeypatch, models):
    _pallas_interpret(monkeypatch)
    jm, params, tm = models
    images, ids = _inputs(3)
    with torch.no_grad():
        got_img = serving.fused_encode_image_siglip(
            tm, torch.from_numpy(images), dtype=torch.float32)
        got_txt = serving.fused_encode_text_siglip(
            tm, torch.from_numpy(ids), dtype=torch.float32)
    want_img = jax_serving.fused_encode_image_siglip(
        jm, params, jnp.asarray(images), dtype=jnp.float32, interpret=True)
    want_txt = jax_serving.fused_encode_text_siglip(
        jm, params, jnp.asarray(ids), dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt),
                               rtol=1e-4, atol=1e-4)
    # and the composable towers: the fused chain is the same function
    with torch.no_grad():
        np.testing.assert_allclose(
            got_img.numpy(), tm.encode_image(torch.from_numpy(images)).numpy(),
            rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def int8_towers(models):
    """Both packages' int8 SigLIP towers, calibrated on the same inputs."""
    jm, params, tm = models
    images, ids = _inputs(4, b=4)
    return {
        "image": (jax_serving.prepare_int8_siglip_tower(
                      jm, params, jnp.asarray(images)),
                  serving.prepare_int8_siglip_tower(
                      tm, torch.from_numpy(images))),
        "text": (jax_serving.prepare_int8_siglip_text_tower(
                     jm, params, jnp.asarray(ids)),
                 serving.prepare_int8_siglip_text_tower(
                     tm, torch.from_numpy(ids))),
    }


@pytest.mark.parametrize("tower", ["image", "text"])
def test_prepared_siglip_towers_match_jax(int8_towers, tower):
    jq, tq = int8_towers[tower]
    assert len(jq["blocks"]) == len(tq["blocks"]) == 2
    for jb, tb in zip(jq["blocks"], tq["blocks"]):
        for name in ("wqkv_q", "wo_q", "w1_q", "w2_q"):
            assert tb[name].dtype == torch.int8
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]).T)
        for name in ("sqkv", "so", "s1", "s2", "bqkv", "bo", "b1", "b2",
                     "ln1", "ln2"):
            np.testing.assert_array_equal(tb[name].float().numpy(),
                                          np.asarray(jb[name]), err_msg=name)
        # the same activations up to fp32 summation order
        np.testing.assert_allclose(tb["act_scales"].numpy(),
                                   np.asarray(jb["act_scales"]), rtol=1e-5)


def test_fused_encode_siglip_int8_matches_jax(monkeypatch, models,
                                              int8_towers):
    _pallas_interpret(monkeypatch)
    jm, params, tm = models
    images, ids = _inputs(5)
    (jq_img, tq_img), (jq_txt, tq_txt) = (int8_towers["image"],
                                          int8_towers["text"])
    with torch.no_grad():
        got_img = serving.fused_encode_image_siglip_int8(
            tm, tq_img, torch.from_numpy(images), dtype=torch.float32)
        got_txt = serving.fused_encode_text_siglip_int8(
            tm, tq_txt, torch.from_numpy(ids), dtype=torch.float32)
    want_img = jax_serving.fused_encode_image_siglip_int8(
        jm, params, jq_img, jnp.asarray(images), dtype=jnp.float32,
        interpret=True)
    want_txt = jax_serving.fused_encode_text_siglip_int8(
        jm, params, jq_txt, jnp.asarray(ids), dtype=jnp.float32,
        interpret=True)
    # same int8 weights, act scales equal to rtol 1e-5: fp32 order only; a
    # moved int8 code would show as ~1e-3
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got_img.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_siglip_fused_available_where_jax_is():
    """Wherever the JAX gate takes a registry SigLIP tower, the port's does
    (JAX's VMEM budget also turns down the 1024-token towers at 512)."""
    for name in port_registry.list_siglip_models():
        if port_registry.classify_model(name)[0] != "siglip":
            continue
        v = port_registry.resolve_siglip_config(name).vision
        if jax_serving.siglip_fused_available(
                jax_registry.resolve_siglip_config(name).vision):
            assert serving.siglip_fused_available(v), name
    so400m = port_registry.resolve_siglip_config("ViT-SO400M-14-SigLIP-384")
    assert serving.siglip_fused_available(so400m.vision)


# -- the kernel gate -------------------------------------------------------


def _towers_of_clip(cfg):
    """(rows, width, heads, mlp ratio) of a CLIP config's two towers, as
    the serving path pads them."""
    v, t = cfg.vision, cfg.text
    return [(serving._round_up(v.num_patches + 1, 16), v.width, v.heads,
             v.mlp_ratio),
            (serving._round_up(t.context_length, 16), t.width, t.heads,
             t.mlp_ratio)]


def _towers_of_siglip(cfg):
    v, t = cfg.vision, cfg.text
    return [(serving._round_up(v.num_patches, 16), v.width, v.heads,
             v.intermediate_size / v.width),
            (serving._round_up(t.max_position_embeddings, 16), t.width,
             t.heads, t.intermediate_size / t.width)]


def _gate_cases():
    cases = []
    for name, cfg in port_config.MODEL_CONFIGS.items():
        if cfg.vision.tower == "vit":
            cases += [(name, s) for s in _towers_of_clip(cfg)]
    for name in port_registry.list_siglip_models():
        if port_registry.classify_model(name)[0] == "siglip":
            cfg = port_registry.resolve_siglip_config(name)
            cases += [(name, s) for s in _towers_of_siglip(cfg)]
    return cases


def test_port_gate_takes_what_the_jax_gate_takes():
    """Wherever the JAX package's fused_block_supported takes a tower's
    shape (its VMEM budget is the TPU's: the port may take more), the
    port's takes it too, in bf16 and in int8; and so does the port's
    fused_path_available where the JAX one holds. ViT-H-14 (head dim 80)
    and SO400M (72, MLP 4304) among them."""
    taken = set()
    for name, shape in _gate_cases():
        if jax_gate(*shape):
            assert fused_block_supported(*shape), (name, shape)
            assert fused_block_supported(*shape, int8=True), (name, shape)
            taken.add(name)
    assert {"ViT-H-14", "ViT-SO400M-14-SigLIP-384", "ViT-L-14-336"} <= taken
    for name, cfg in port_config.MODEL_CONFIGS.items():
        if jax_serving.fused_path_available(types.SimpleNamespace(cfg=cfg)):
            assert serving.fused_path_available(
                types.SimpleNamespace(cfg=cfg)), name


# -- loss and train step ----------------------------------------------------


@pytest.mark.parametrize("with_bias", [False, True])
def test_siglip_loss_and_gradients_match_jax(with_bias):
    rng = np.random.default_rng(6)
    img, txt = (rng.standard_normal((6, 32)).astype(np.float32)
                for _ in range(2))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    scale, bias = np.float32(10.0), np.float32(-3.0)

    def jloss(i, t, s, b):
        return jax_siglip_loss(i, t, s, b if with_bias else None)

    want, wgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale),
        jnp.asarray(bias))
    ts = [torch.tensor(a, requires_grad=True) for a in (img, txt, scale, bias)]
    got = siglip_loss(ts[0], ts[1], ts[2], ts[3] if with_bias else None)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    for t, w in zip(ts, wgrads):
        g = np.zeros_like(t.detach().numpy()) if t.grad is None \
            else t.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_siglip_train_step_matches_jax():
    """One --siglip step of make_clip_train_step on test-tiny: the loss and
    every gradient against JAX's (one batch, fp32); then the port's step
    applies them."""
    from clip_embeds_tpu.core.factory import create_model as jax_create
    from clip_embeds_tpu_torch.core.convert import (
        load_open_clip_state_dict,
        state_dict_from_jax_params,
    )
    from clip_embeds_tpu_torch.core.factory import create_model
    from clip_embeds_tpu_torch.data.synthetic import synthetic_batches
    from clip_embeds_tpu_torch.train.optim import adamw
    from clip_embeds_tpu_torch.train.schedules import const_lr
    from clip_embeds_tpu_torch.train.steps import (
        TrainState, clip_train_loss, make_clip_train_step)

    jm, jp = jax_create("test-tiny", seed=3, attn_impl="reference")
    jp = jax.tree.map(np.asarray, jp)
    tm = create_model("test-tiny")
    load_open_clip_state_dict(tm, state_dict_from_jax_params(jp))
    batch = next(synthetic_batches(8, 32, tm.cfg.text.context_length,
                                   seed=4))

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(batch["images"]),
                       jnp.asarray(batch["texts"]))
        return jax_siglip_loss(out["image_features"], out["text_features"],
                               out["logit_scale"], out.get("logit_bias"))

    want, wgrads = jax.value_and_grad(jloss)(jp)
    wgrads = state_dict_from_jax_params(jax.tree.map(np.asarray, wgrads))
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = clip_train_loss(tm, tb, use_siglip=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), wgrads[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    tm.zero_grad(set_to_none=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    state = TrainState(tm, adamw(tm, 1e-3), const_lr(1e-3))
    metrics = make_clip_train_step(tm, use_siglip=True)(state, tb)
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               rtol=1e-5)
    assert state.step == 1
    assert all(not torch.equal(before[k], v)
               for k, v in tm.state_dict().items())
    with pytest.raises(ValueError, match="InfoNCE"):
        make_clip_train_step(tm, use_siglip=True, grad_cache_chunks=2)


def test_train_cli_siglip_runs_and_refuses_grad_cache(caplog):
    import logging

    args = ["--model", "test-tiny", "--precision", "fp32", "--batch-size",
            "8", "--train-num-samples", "16", "--lr", "1e-3", "--warmup",
            "1", "--log-every", "1", "--device", "cpu", "--siglip"]
    with caplog.at_level(logging.INFO):
        state = port_train.main(args)
    assert state.step == 2
    losses = [float(r.args[2]) for r in caplog.records
              if str(r.msg).startswith("epoch %d step %d loss")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    with pytest.raises(SystemExit, match="--siglip"):
        port_train.main(args + ["--grad-cache-chunks", "2"])
    with pytest.raises(SystemExit, match="--siglip"):
        port_train.main(args + ["--accum-freq", "2"])


# -- tokenizer, registry, scorer, eval CLI -----------------------------------


def _write_vocab(path, unigram):
    pieces = [("<pad>", 0.0, unigram.CONTROL), ("</s>", 0.0, unigram.CONTROL),
              ("<unk>", 0.0, unigram.UNKNOWN)]
    words = ["▁a", "▁photo", "▁of", "▁cat", "▁dog", "▁mug", "▁left",
             "▁right", "▁on", "▁under", "▁the", "▁table", "▁is", "▁"]
    pieces += [(w, -2.0 - 0.1 * i, unigram.NORMAL)
               for i, w in enumerate(words)]
    pieces += [(c, -6.0, unigram.NORMAL) for c in "abcdefghijklmnopqrstuvwxyz"]
    path.write_bytes(unigram.write_model_proto(pieces))
    return str(path)


def test_unigram_copy_and_tokenizer_match_jax(tmp_path):
    port_path = _write_vocab(tmp_path / "port.model", port_unigram)
    jax_path = _write_vocab(tmp_path / "jax.model", jax_unigram)
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    texts = ["A photo of a cat.", "the MUG is left of the table",
             "Zebra_under   the table!!", "", "x" * 80]
    got = port_tokenizer.SigLipTokenizer(port_path, context_length=16)(texts)
    want = jax_tokenizer.SigLipTokenizer(port_path, context_length=16)(texts)
    assert got.dtype == np.int32 and got.shape == (5, 16)
    np.testing.assert_array_equal(got, want)
    for t in texts:
        assert port_tokenizer.canonicalize_text(t) == \
            jax_tokenizer.canonicalize_text(t)
    with pytest.raises(FileNotFoundError):
        port_tokenizer.SigLipTokenizer(str(tmp_path / "missing.model"))


def test_registry_copy_matches_jax():
    names = port_registry.list_siglip_models()
    assert "ViT-SO400M-14-SigLIP-384" in names and len(names) == 28
    for name in names:
        assert port_registry.get_raw_model_config(name) == \
            jax_registry.get_raw_model_config(name), name
        assert port_registry.classify_model(name) == \
            jax_registry.classify_model(name), name
        if port_registry.classify_model(name)[0] != "siglip":
            with pytest.raises(NotImplementedError):
                port_registry.resolve_siglip_config(name)
            continue
        assert dataclasses.asdict(port_registry.resolve_siglip_config(
            name)) == dataclasses.asdict(
                jax_registry.resolve_siglip_config(name)), name
    # every SigLIP tower of the JAX registry is in the copy
    for name in jax_registry.list_openclip_models():
        if jax_registry.classify_model(name)[0] == "siglip":
            assert name in names
    cfg = port_registry.resolve_siglip_config("ViT-SO400M-14-SigLIP-384")
    assert (cfg.vision.width, cfg.vision.layers, cfg.vision.heads,
            cfg.vision.intermediate_size, cfg.vision.num_patches,
            cfg.text.intermediate_size, cfg.text.max_position_embeddings) \
        == (1152, 27, 16, 4304, 729, 4304, 64)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (50, 60, 3), np.uint8))
            for _ in range(n)]


def test_siglip_scorer_matches_jax(models, tmp_path):
    jm, params, tm = models
    vocab = _write_vocab(tmp_path / "c4.model", port_unigram)
    port = SiglipScorer(tm, port_tokenizer.SigLipTokenizer(vocab, 16),
                        batch_size=4)
    ref = JaxSiglipScorer(jm, params,
                          jax_tokenizer.SigLipTokenizer(vocab, 16),
                          batch_size=4)
    assert port.route == "composable"
    images = _images(5, 7)
    texts = ["a photo of a cat", "a mug left of the table",
             "a mug right of the table", "the dog is under the table",
             "a cat on the table"]
    np.testing.assert_allclose(port.sigmoid_scores(images, texts),
                               ref.sigmoid_scores(images, texts),
                               rtol=1e-4, atol=1e-4)
    samples = [(images[i], texts[i:i + 2 + i % 3]) for i in range(4)]
    for g, w in zip(port.score_batch(samples), ref.score_batch(samples),
                    strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.pair_score(images[:2], texts[:2]),
                               ref.pair_score(images[:2], texts[:2]),
                               rtol=1e-4, atol=1e-4)


def _tiny_registry(monkeypatch):
    """Both registries resolve the SO400M name to the tiny config, so the
    CLIs reach their tokenizer without building 880 M parameters."""
    monkeypatch.setattr(jax_registry, "resolve_siglip_config",
                        lambda name: _configs(jax_siglip))
    monkeypatch.setattr(port_registry, "resolve_siglip_config",
                        lambda name: _configs(port_siglip))


def test_eval_cli_siglip_exits_in_both_packages(monkeypatch, tmp_path):
    """JAX's --scorer siglip calls SigLipTokenizer() without the .model path
    it needs and exits; the port keeps that (ROADMAP queue 3)."""
    _tiny_registry(monkeypatch)
    argv = ["--scorer", "siglip", "--model", "ViT-SO400M-14-SigLIP-384",
            "--root-dir", str(tmp_path), "--precision", "fp32"]
    msg = "SigLIP tokenizer needs sentencepiece"
    with pytest.raises(SystemExit, match=msg):
        jax_eval.build_scorer(jax_eval.parse_args(argv))
    with pytest.raises(SystemExit, match=msg):
        port_eval.build_scorer(port_eval.parse_args(argv + ["--device",
                                                            "cpu"]))


def test_eval_cli_siglip_builds_its_scorer_given_a_tokenizer(
        monkeypatch, tmp_path):
    """Past the tokenizer the branch builds the scorer: seeded weights, or
    an HF state dict from --pretrained."""
    _tiny_registry(monkeypatch)
    vocab = _write_vocab(tmp_path / "c4.model", port_unigram)
    real = port_tokenizer.SigLipTokenizer
    monkeypatch.setattr(port_tokenizer, "SigLipTokenizer",
                        lambda: real(vocab, 16))
    hf = tmp_path / "siglip.pt"
    torch.save(_hf_state_dict(np.random.default_rng(8)), hf)
    argv = ["--scorer", "siglip", "--model", "ViT-SO400M-14-SigLIP-384",
            "--root-dir", str(tmp_path), "--device", "cpu"]
    seeded = port_eval.build_scorer(port_eval.parse_args(
        argv + ["--precision", "bf16"]))
    assert isinstance(seeded, SiglipScorer) and seeded.route == "composable"
    assert seeded.dtype == torch.bfloat16
    assert seeded.model.logit_scale.dtype == torch.float32
    assert seeded._scale == pytest.approx(10.0)
    loaded = port_eval.build_scorer(port_eval.parse_args(
        argv + ["--precision", "fp32", "--pretrained", str(hf)]))
    want = siglip_state_dict_from_hf(torch.load(hf))
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, want[k]), k
