"""FLIP patch dropout and the positional-embedding helpers of the port's
vision tower (models/vit.py) against the JAX package, fp32 on the CPU.

torch cannot reproduce ``jax.random``'s bits, so the JAX parity tests
record the indices JAX's ``jax.lax.top_k`` returns inside the tower (the
function is wrapped for the test; no JAX file changes) and feed them to the
port as ``keep_idx``. Tolerances: features rtol 1e-4 / atol 1e-5, losses
rel 1e-5 and gradients rtol 1e-4 / atol 1e-6, those of
tests/test_torch_train.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from clip_embeds_tpu.core.config import get_model_config as jax_config
from clip_embeds_tpu.core.torch_convert import convert_clip_state_dict
from clip_embeds_tpu.models import vit as jvit
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu.train import steps as jax_steps
from clip_embeds_tpu_torch.core.config import get_model_config
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.data.synthetic import synthetic_batches
from clip_embeds_tpu_torch.models import vit
from clip_embeds_tpu_torch.models.clip import CLIP
from clip_embeds_tpu_torch.train.schedules import const_lr
from clip_embeds_tpu_torch.train.steps import (
    TrainState,
    make_clip_train_step,
    patch_dropout_generator,
)

# test-tiny's widths at 64 px in patches of 8: 64 patch tokens
SIZE, PATCH = 64, 8


def _cfg(config, drop):
    cfg = config("test-tiny")
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_size=SIZE, patch_size=PATCH, patch_dropout=drop))


def _random_sd(cfg, seed=0, std=0.05):
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in CLIP(cfg).state_dict().items():
        a = std * rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith("weight") and ".ln" in "." + k and v.ndim == 1:
            a += 1.0
        sd[k] = torch.from_numpy(np.asarray(a, np.float32))
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


def _models(drop, seed=0):
    cfg = _cfg(get_model_config, drop)
    sd = _random_sd(cfg, seed)
    model = CLIP(cfg).train()
    model.load_state_dict(sd)
    params = jax.tree.map(jnp.asarray, convert_clip_state_dict(sd))
    return model, JaxCLIP(_cfg(jax_config, drop)), params


def _batch(n=8, hard=0):
    return next(synthetic_batches(n, SIZE, 77, hard_negatives=hard, seed=3))


@pytest.fixture
def jax_top_k(monkeypatch):
    """The indices of every jax.lax.top_k call, as numpy, in call order."""
    seen, real = [], jax.lax.top_k

    def recording(x, k):
        out = real(x, k)
        seen.append(np.array(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    return seen


def _tower_input(model):
    """Collects the shape and CLS row of what the blocks receive."""
    seen = []
    model.visual.transformer.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
    return seen


@pytest.mark.parametrize("drop,keep", [(0.5, 32), (0.25, 48), (0.99, 1),
                                       (0.0, 64)])
def test_keep_count_and_cls(drop, keep):
    model = CLIP(_cfg(get_model_config, drop))
    model.load_state_dict(_random_sd(model.cfg))
    assert vit.patches_kept(64, drop) == keep
    x = torch.from_numpy(_batch(4)["images"])
    seen = _tower_input(model)
    model.visual(x, deterministic=False,
                 generator=torch.Generator().manual_seed(0))
    assert seen[0].shape == (4, 1 + keep, 64)
    # the CLS row is ln_pre(class_embedding + pos[0]) in every sample
    v = model.visual
    cls = v.ln_pre(v.class_embedding + v.positional_embedding[0])
    torch.testing.assert_close(seen[0][:, 0], cls.expand(4, -1).detach())


def test_draws_follow_the_generator_and_eval_keeps_every_patch():
    model = CLIP(_cfg(get_model_config, 0.5))
    model.load_state_dict(_random_sd(model.cfg))
    x = torch.from_numpy(_batch(4)["images"])

    def feats(seed):
        return model.encode_image(x, deterministic=False,
                                  generator=torch.Generator().manual_seed(
                                      seed)).detach()

    torch.testing.assert_close(feats(1), feats(1), rtol=0, atol=0)
    assert not torch.equal(feats(1), feats(2))
    # eval (and serving): byte-stable, as with patch dropout off
    plain = CLIP(_cfg(get_model_config, 0.0))
    plain.load_state_dict(model.state_dict())
    assert torch.equal(model.encode_image(x), plain.encode_image(x))
    # the step's generator is a function of (seed, step)
    a, b, c = (patch_dropout_generator(s, t, torch.device("cpu"))
               for s, t in ((0, 3), (0, 3), (0, 4)))
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    assert not torch.equal(torch.rand(8, generator=a),
                           torch.rand(8, generator=c))


def test_step_without_patch_dropout_config_draws_nothing(monkeypatch):
    model = create_model("test-tiny", train=True)
    calls = []
    monkeypatch.setattr(
        "clip_embeds_tpu_torch.train.steps.patch_dropout_generator",
        lambda *a: calls.append(a))
    state = TrainState(model, torch.optim.SGD(model.parameters(), 0.0),
                       const_lr(0.0))
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v)
             for k, v in next(synthetic_batches(4, 32, 77)).items()}
    make_clip_train_step(model)(state, batch)
    assert calls == []


def test_pooled_features_with_jax_indices_match_jax(jax_top_k):
    model, jmodel, params = _models(0.5)
    images = _batch(6)["images"]
    want, want_tokens = jmodel.apply(
        {"params": params}, jnp.asarray(images), deterministic=False,
        output_tokens=True, method="encode_image",
        rngs={"patch_dropout": jax.random.PRNGKey(4)})
    (idx,) = jax_top_k
    assert idx.shape == (6, 32)
    got = model.encode_image(torch.from_numpy(images), deterministic=False)
    # the generator's own draw differs from JAX's
    assert not np.allclose(got.detach().numpy(), np.asarray(want), atol=1e-3)
    pooled, tokens = model.visual(torch.from_numpy(images),
                                  deterministic=False,
                                  keep_idx=torch.from_numpy(idx).long())
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    # the kept tokens stay in top-k order, not sorted by position
    assert not (np.diff(idx, axis=1) > 0).all()
    np.testing.assert_allclose(tokens.detach().numpy(),
                               np.asarray(want_tokens), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hard", [0, 2], ids=["infonce", "hardtext"])
def test_train_step_with_jax_indices_matches_jax(jax_top_k, monkeypatch,
                                                 hard):
    """One step of SGD at lr 1 from one state dict: the loss, and the
    gradients (parameters before less after) of every tensor."""
    model, jmodel, params = _models(0.5, seed=1)
    batch = _batch(8, hard)
    jstep = jax_steps.make_clip_train_step(jmodel, use_hard_text=bool(hard),
                                           seed=9)
    jstate, jm = jstep(jax_steps.TrainState.create(params, optax.sgd(1.0)),
                       jax.tree.map(jnp.asarray, batch))
    (idx,) = jax_top_k

    real = model.visual.forward
    monkeypatch.setattr(model.visual, "forward", lambda *a, **kw: real(
        *a, **dict(kw, keep_idx=torch.from_numpy(idx).long())))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, torch.optim.SGD(model.parameters(), 1.0),
                       const_lr(1.0))
    metrics = make_clip_train_step(model, use_hard_text=bool(hard), seed=9)(
        state, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v) for k, v in batch.items()})
    assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]),
                                                   rel=1e-5)
    from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params

    after = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                    jstate.params))
    for k, v in model.state_dict().items():
        if k == "logit_scale":
            continue  # clamped after the step on both sides
        torch.testing.assert_close(before[k] - v, before[k] - after[k],
                                   rtol=1e-4, atol=1e-6, msg=k)


@pytest.mark.parametrize("old,new", [(14, 25), (24, 16), (7, 7), (5, 2),
                                     (3, 8)], ids=lambda v: str(v))
def test_interpolate_pos_embed_matches_jax(old, new):
    pos = np.random.default_rng(old * 100 + new).standard_normal(
        (1 + old * old, 24)).astype(np.float32)
    got = vit.interpolate_pos_embed(torch.from_numpy(pos), old, new)
    want = np.asarray(jvit.interpolate_pos_embed(jnp.asarray(pos), old, new))
    assert got.shape == (1 + new * new, 24)
    np.testing.assert_array_equal(got[0].numpy(), pos[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if new >= old:  # up: the same as F.interpolate's bilinear
        grid = torch.from_numpy(pos[1:]).reshape(old, old, 24).permute(
            2, 0, 1)[None]
        up = F.interpolate(grid, size=(new, new), mode="bilinear",
                           align_corners=False)[0].permute(1, 2, 0)
        np.testing.assert_allclose(got[1:].numpy(),
                                   up.reshape(-1, 24).numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_interpolate_pos_embed_down_is_not_plain_bilinear():
    """Down, JAX's kernel spans more than the two nearest cells, so the
    plain bilinear shrink (F.interpolate without antialias) is far off."""
    pos = np.random.default_rng(0).standard_normal((1 + 24 * 24, 8)).astype(
        np.float32)
    got = vit.interpolate_pos_embed(torch.from_numpy(pos), 24, 16)[1:]
    grid = torch.from_numpy(pos[1:]).reshape(24, 24, 8).permute(2, 0, 1)[None]
    plain = F.interpolate(grid, size=(16, 16), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0)
    assert (got - plain.reshape(-1, 8)).abs().max() > 0.1


@pytest.mark.parametrize("width,grid,cls", [(64, 7, True), (1024, 24, True),
                                            (16, 3, False)])
def test_sincos_2d_pos_embed_matches_jax(width, grid, cls):
    got = vit.sincos_2d_pos_embed(width, grid, cls)
    want = np.asarray(jvit.sincos_2d_pos_embed(width, grid, cls))
    assert got.shape == want.shape == (grid * grid + cls, width)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # MoCo-v3 layout: the first half encodes the column, then the row
    rows = got[int(cls):].reshape(grid, grid, width)
    torch.testing.assert_close(rows[0, :, : width // 2],
                               rows[1, :, : width // 2])
    torch.testing.assert_close(rows[:, 0, width // 2:],
                               rows[:, 1, width // 2:])
