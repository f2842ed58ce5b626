"""The port's training modules against the JAX package (fp32, CPU): the
losses, the weight-decay split, the freeze labels, the schedules, the train
step with AdamW (InfoNCE and hard-text), grad-cache, the remat policies and
the checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.core.torch_convert import convert_clip_state_dict
from clip_embeds_tpu.losses import clip_loss as jax_losses
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu.core.config import get_model_config as jax_config
from clip_embeds_tpu.train import freeze as jax_freeze
from clip_embeds_tpu.train import optim as jax_optim
from clip_embeds_tpu.train import schedules as jax_sched
from clip_embeds_tpu.train import steps as jax_steps
from clip_embeds_tpu_torch.core import checkpoint as ckpt
from clip_embeds_tpu_torch.core.config import get_model_config as port_config
from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params
from clip_embeds_tpu_torch.core.factory import create_model
from clip_embeds_tpu_torch.data.synthetic import synthetic_batches
from clip_embeds_tpu_torch.losses import clip_loss as losses
from clip_embeds_tpu_torch.models.clip import CLIP
from clip_embeds_tpu_torch.train import freeze, optim, schedules
from clip_embeds_tpu_torch.train.grad_cache import cache_grad_step
from clip_embeds_tpu_torch.train.steps import (
    TrainState,
    clip_train_loss,
    make_clip_train_step,
)


def _feats(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


_LOSSES = {
    "clip_loss": lambda m, f: m.clip_loss(f[0], f[1], 14.0),
    "clip_loss_bias": lambda m, f: m.clip_loss(f[0], f[1], 10.0, -2.5),
    "clip_loss_hard_text": lambda m, f, mask=np.array([1, 0, 1], bool):
        m.clip_loss_hard_text(f[0], f[1], f[2], 14.0, hard_valid=mask),
    "clip_loss_hard_text_all": lambda m, f:
        m.clip_loss_hard_text(f[0], f[1], f[2], 14.0),
    "distill_clip_loss": lambda m, f: m.distill_clip_loss(
        f[0], f[1], 14.0, f[3], f[4], 20.0),
    "pacl_clip_loss": lambda m, f: m.pacl_clip_loss(f[0], f[1]),
    "embedding_contrastive_loss": lambda m, f:
        m.embedding_contrastive_loss(f[0], f[1]),
    "clip_metrics": lambda m, f: m.clip_metrics(f[0], f[1], 14.0),
    "softmax_cross_entropy": lambda m, f: m.softmax_cross_entropy(
        f[0] @ f[1].T, np.array([2, 0, 1, 5, 3, 4])),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_matches_jax(name):
    rng = np.random.default_rng(0)
    f = [_feats(rng, 6, 16), _feats(rng, 6, 16), _feats(rng, 3, 16),
         _feats(rng, 6, 16), _feats(rng, 6, 16)]

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [v for item in x for v in flat(item)]
        return np.asarray(x, np.float64).ravel().tolist()

    class Torch:  # the port's losses on tensors made from the same numpy
        def __getattr__(self, attr):
            fn = getattr(losses, attr)

            def call(*args, **kw):
                conv = lambda a: (torch.from_numpy(a) if isinstance(
                    a, np.ndarray) else torch.tensor(a) if isinstance(
                        a, float) else a)
                return fn(*map(conv, args),
                          **{k: conv(v) for k, v in kw.items()})
            return call

    want = flat(_LOSSES[name](jax_losses, f))
    got = flat(_LOSSES[name](Torch(), f))
    # fp32 both sides
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _random_sd(name="test-tiny", seed=0, std=0.05):
    """An open_clip state dict with every entry random (LN gains near 1)."""
    model = CLIP(port_config(name))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = std * rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith("weight") and ".ln" in "." + k and v.ndim == 1:
            a += 1.0
        sd[k] = torch.from_numpy(np.asarray(a, np.float32))
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


def _port_names(jax_tree, params):
    """A JAX leaf-per-parameter tree of scalars -> {port name: value}, by
    filling each parameter's shape and mapping through the converter."""
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                        jax_tree, params)
    return {k: float(v.flatten()[0]) if v.numel() else None
            for k, v in state_dict_from_jax_params(full).items()}


def _jax_params(sd):
    return jax.tree.map(jnp.asarray, convert_clip_state_dict(sd))


def test_decay_mask_matches_jax():
    sd = _random_sd()
    params = _jax_params(sd)
    want = _port_names(jax_optim.decay_mask(params), params)
    model = CLIP(port_config("test-tiny"))
    got = optim.decay_mask(model)
    assert sorted(got) == sorted(want)
    assert {k: float(v) for k, v in got.items()} == want
    opt = optim.adamw(model, weight_decay=0.2)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.2, 0.0]
    assert sum(len(g["params"]) for g in opt.param_groups) == len(got)


@pytest.mark.parametrize("kw", [
    dict(lock_image=True),
    dict(lock_image=True, lock_image_unlocked_groups=2),
    dict(lock_text=True),
    dict(lock_text=True, lock_text_unlocked_layers=1),
    dict(lock_text=True, lock_text_freeze_layer_norm=True),
    dict(lock_image=True, lock_text=True, lock_text_unlocked_layers=1,
         lock_text_freeze_layer_norm=True),
], ids=["image", "image_unlocked2", "text", "text_unlocked1", "text_ln",
        "both"])
def test_tower_freeze_labels_match_jax(kw):
    sd = _random_sd()
    params = _jax_params(sd)
    labels = jax_freeze.tower_freeze_labels(params, jax_config("test-tiny"),
                                            **kw)
    want = _port_names(jax.tree.map(lambda l: float(l == "train"), labels),
                       params)
    model = CLIP(port_config("test-tiny"))
    got = freeze.tower_freeze_labels(model, model.cfg, **kw)
    assert {k: float(v == "train") for k, v in got.items()} == want
    n_frozen = freeze.apply_freeze(model, got)
    assert n_frozen == sum(v == "freeze" for v in got.values()) > 0
    trainable = {k for k, p in model.named_parameters() if p.requires_grad}
    assert trainable == {k for k, v in got.items() if v == "train"}


_SCHEDULES = {
    "const": lambda m: m.const_lr(1e-3, 3),
    "const_no_warmup": lambda m: m.const_lr(1e-3),
    "cosine": lambda m: m.cosine_lr(1e-3, 3, 12),
    "linear": lambda m: m.linear_lr(1e-3, 3, 12),
    "const_cooldown": lambda m: m.const_lr_cooldown(1e-3, 2, 12, 5, 1.5,
                                                    1e-5),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_matches_jax(name):
    ours, theirs = _SCHEDULES[name](schedules), _SCHEDULES[name](jax_sched)
    for step in range(13):  # through the last of 12 steps
        # the JAX schedules compute in fp32, the port's in float64
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-5,
                                           abs=1e-12), (name, step)


def _batches(n, hard):
    return list(synthetic_batches(8, 32, 77, num_batches=n,
                                  hard_negatives=2 if hard else 0, seed=1))


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _port_state(sd, lr=1e-3, clip=None):
    model = create_model("test-tiny", train=True)
    model.load_state_dict(sd)
    opt = optim.adamw(model, lr, weight_decay=0.1)
    return model, TrainState(model, opt, schedules.const_lr(lr), clip)


def _assert_params_close(model, jax_params, atol):
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("hard", [False, True], ids=["infonce", "hardtext"])
def test_train_steps_match_jax(hard):
    """Three steps of lr 1e-3 (AdamW, wd 0.1, clip at norm 1.0) from one
    state dict: losses and parameters as the JAX step's."""
    sd = _random_sd(seed=2)
    model, state = _port_state(sd, clip=1.0)
    step = make_clip_train_step(model, use_hard_text=hard)
    jmodel = JaxCLIP(jax_config("test-tiny"))
    tx = jax_optim.adamw(1e-3, weight_decay=0.1, max_grad_norm=1.0)
    jstate = jax_steps.TrainState.create(_jax_params(sd), tx)
    jstep = jax.jit(jax_steps.make_clip_train_step(jmodel,
                                                   use_hard_text=hard))
    for batch in _batches(3, hard):
        loss = float(step(state, _to_torch(batch))["loss"])
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        assert loss == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert state.step == int(jstate.step) == 3
    # fp32 both sides: Adam divides each gradient by its own running
    # magnitude, so summation-order noise moves an update by ~1e-6 of lr
    _assert_params_close(model, jstate.params, atol=2e-5)


def test_grad_cache_gradients_match_plain_and_jax():
    sd = _random_sd(seed=3)
    batch = _to_torch(_batches(1, False)[0])
    model, _ = _port_state(sd)
    loss, _ = clip_train_loss(model, batch)
    loss.backward()
    plain = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    def encode(chunk):
        out = model(chunk["images"], chunk["texts"])
        return {"img": out["image_features"], "txt": out["text_features"]}

    scale = model.logit_scale.detach().exp()
    cached_loss = cache_grad_step(
        encode, lambda r: losses.clip_loss(r["img"], r["txt"], scale),
        batch, 4)
    assert float(cached_loss) == pytest.approx(loss.item(), rel=1e-6)
    # as in JAX, the logit scale is a constant of the grad-cache loss
    assert model.logit_scale.grad is None
    for k, p in model.named_parameters():
        if k != "logit_scale":
            torch.testing.assert_close(p.grad, plain[k], rtol=1e-4,
                                       atol=1e-6, msg=k)

    # one grad-cache step against the JAX grad-cache step
    model, state = _port_state(sd)
    make_clip_train_step(model, grad_cache_chunks=4)(state, batch)
    jmodel = JaxCLIP(jax_config("test-tiny"))
    jstate = jax_steps.TrainState.create(
        _jax_params(sd), jax_optim.adamw(1e-3, weight_decay=0.1))
    jstate, _ = jax.jit(jax_steps.make_clip_train_step(
        jmodel, grad_cache_chunks=4))(
            jstate, jax.tree.map(jnp.asarray, _batches(1, False)[0]))
    _assert_params_close(model, jstate.params, atol=2e-5)


@pytest.mark.parametrize("remat", [True, "dots", "attn"])
def test_remat_gradients_equal_no_remat(remat):
    sd = _random_sd(seed=4)
    batch = _to_torch(_batches(1, False)[0])
    grads = []
    for r in (False, remat):
        model = create_model("test-tiny", remat=r, train=True)
        model.load_state_dict(sd)
        loss, _ = clip_train_loss(model, batch)
        loss.backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        # recomputing the same fp32 ops gives the same gradients
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0,
                                   atol=1e-7, msg=k)


def test_compute_dtype_keeps_fp32_masters():
    """bf16 compute over fp32 parameters: the towers run in bf16, the
    gradients land on the fp32 masters; serving models are unchanged."""
    sd = _random_sd(seed=5)
    model = create_model("test-tiny", compute_dtype=torch.bfloat16,
                         train=True)
    model.load_state_dict(sd)
    assert model.training and model.visual.proj.dtype == torch.float32
    batch = _to_torch(_batches(1, False)[0])
    out = model(batch["images"], batch["texts"])
    assert out["image_features"].dtype == torch.bfloat16
    assert out["logit_scale"].dtype == torch.float32
    loss = losses.clip_loss(out["image_features"], out["text_features"],
                            out["logit_scale"])
    loss.backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    ref = create_model("test-tiny", train=True)
    ref.load_state_dict(sd)
    want = ref(batch["images"], batch["texts"])["image_features"]
    cos = torch.nn.functional.cosine_similarity(
        out["image_features"].float(), want, dim=-1)
    assert cos.min() > 0.999


def test_checkpoint_save_latest_resume_prune(tmp_path):
    d = str(tmp_path / "ckpts")
    assert ckpt.latest_checkpoint(d) is None and ckpt.resume(d) is None
    sd = {"w": torch.arange(4.0)}
    for step in (1, 3, 2, 10):
        path = ckpt.save(d, {"state_dict": sd, "step": step}, step=step)
        assert path.endswith(f"epoch_{step}.pt")
    assert ckpt.step_of(ckpt.latest_checkpoint(d)) == 10  # 10 > 3 > 2
    restored = ckpt.resume(d)
    assert restored["step"] == 10 and torch.equal(restored["state_dict"]["w"],
                                                  sd["w"])
    ckpt.save(d, {"state_dict": sd, "step": 11}, step=11, keep=2)
    import os

    assert sorted(os.listdir(d)) == ["epoch_10.pt", "epoch_11.pt"]
    # the port's --pretrained loads a checkpoint as it is
    model = create_model("test-tiny", seed=7)
    path = ckpt.save(d, {"state_dict": model.state_dict(), "step": 1}, 1)
    back = create_model("test-tiny", pretrained=path)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
