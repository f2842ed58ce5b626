"""Training on the zoo towers, beside the steps of
``test_torch_zoo_train.py``: the freeze labels and the weight-decay mask of
every tower family, leaf by leaf against JAX's through JAX's converter;
every family computing in bf16 over fp32 masters; the ModifiedResNet
statistics, which JAX's AdamW moves and the port keeps frozen; and their
values after the factory's meta-device build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu.train import freeze as jax_freeze
from clip_embeds_tpu.train import optim as jax_optim
from clip_embeds_tpu.train import steps as jax_steps
from clip_embeds_tpu_torch.train import freeze, optim, schedules
from clip_embeds_tpu_torch.train.steps import (
    TrainState,
    clip_train_loss,
    make_clip_train_step,
)
from torch_zoo_fixtures import (  # noqa: F401 - fixture
    one_torch_thread,
    LR,
    TOWERS,
    flat,
    indicator,
    is_stat,
    jax_config_of,
    make_batch,
    setup,
    to_torch,
    tree_of,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_resnet_statistics_stay_frozen():
    """A reference fault not copied: JAX's FrozenBatchNorm keeps its
    statistics as parameters, so AdamW moves all of them although the
    docstring calls them frozen; the port keeps them as buffers (open_clip's
    locked towers, JAX's stated semantics). Every other weight agrees."""
    cfg, model, params = setup("resnet")
    batch = make_batch(cfg)
    jmodel = JaxCLIP(jax_config_of(cfg), attn_impl="reference")
    jstate = jax_steps.TrainState.create(
        params, jax_optim.adamw(LR, weight_decay=0.1))
    jstate, _ = jax.jit(jax_steps.make_clip_train_step(jmodel))(
        jstate, jax.tree.map(jnp.asarray, batch))
    before = {k: b.clone() for k, b in model.named_buffers()}
    state = TrainState(model, optim.adamw(model, LR, weight_decay=0.1),
                       schedules.const_lr(LR))
    make_clip_train_step(model)(state, to_torch(batch))

    stats = [p for p in flat(params) if is_stat("resnet", p)]
    assert len(stats) == 2 * sum(
        isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    new = flat(jstate.params)
    assert all(not np.array_equal(new[p], flat(params)[p]) for p in stats)
    for k, b in model.named_buffers():
        assert torch.equal(b, before[k]), k
    updated = tree_of("resnet", cfg, model)
    for path in stats:
        np.testing.assert_array_equal(updated[path], flat(params)[path])
    for path, p in new.items():
        if path not in stats:
            np.testing.assert_allclose(updated[path], p, rtol=0, atol=1e-5,
                                       err_msg=path)


@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_decay_mask_matches_jax(kind):
    """rank < 2, biases and flax ``scale`` leaves get no weight decay in
    JAX; the port's mask, mapped through the converter, says the same of
    every leaf it holds."""
    cfg, model, params = setup(kind)
    want = flat(jax_optim.decay_mask(params))
    got = tree_of(kind, cfg, model, indicator(model,
                                                optim.decay_mask(model)))
    assert sorted(got) == sorted(want)
    for path, decay in want.items():
        if not is_stat(kind, path):
            assert bool(np.any(got[path] != 0)) == bool(decay), path


_LOCKS = {
    "image": dict(lock_image=True),
    # JAX's labels look for the ViT's resblocks / ln_post / proj: on a zoo
    # tower every leaf is an 'embedding', so two unlocked groups still
    # freeze the tower whole (cli/train.py exits on the flag)
    "image_unlocked2": dict(lock_image=True, lock_image_unlocked_groups=2),
    "text_unlocked1": dict(lock_text=True, lock_text_unlocked_layers=1,
                           lock_text_freeze_layer_norm=True),
}


@pytest.mark.parametrize("lock", sorted(_LOCKS))
@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_freeze_labels_match_jax(kind, lock):
    cfg, model, params = setup(kind)
    kw = _LOCKS[lock]
    want = flat(jax.tree.map(
        lambda label: float(label == "train"),
        jax_freeze.tower_freeze_labels(params, jax_config_of(cfg), **kw)))
    labels = freeze.tower_freeze_labels(model, cfg, **kw)
    got = tree_of(kind, cfg, model, indicator(
        model, {k: v == "train" for k, v in labels.items()}))
    for path, train in want.items():
        if not is_stat(kind, path):
            assert bool(np.any(got[path] != 0)) == bool(train), path
    vision = {k: v for k, v in labels.items() if k.startswith("visual.")}
    if lock == "image" or (lock == "image_unlocked2"
                           and cfg.vision.tower != "convnext"):
        assert set(vision.values()) == {"freeze"}
    elif lock == "image_unlocked2":  # JAX's 'proj': the last group
        assert {k for k, v in vision.items() if v == "train"} == \
            {"visual.head.proj.weight"} & set(vision)


@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_bf16_compute_over_fp32_masters(kind):
    """``compute_dtype=bf16``: every projection, conv and norm of the tower
    takes bf16 inputs, the parameters and their gradients stay fp32, and
    the features agree with fp32's; remat gives the same gradients."""
    cfg, ref, _ = setup(kind)
    batch = to_torch(make_batch(cfg))
    seen = set()

    def record(module, args):
        if args and torch.is_tensor(args[0]):
            seen.add(args[0].dtype)

    grads = []
    for remat in (False, True):
        _, model, _ = setup(kind, remat, compute_dtype=torch.bfloat16)
        hooks = [m.register_forward_pre_hook(record)
                 for m in model.visual.modules()
                 if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d,
                                   torch.nn.LayerNorm, torch.nn.BatchNorm2d))]
        out = model(batch["images"], batch["texts"])
        for h in hooks:
            h.remove()
        assert out["image_features"].dtype == torch.bfloat16
        loss, _ = clip_train_loss(model, batch)
        loss.backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
    assert seen == {torch.bfloat16}
    with torch.no_grad():
        want = ref(batch["images"], batch["texts"])["image_features"]
    cos = torch.nn.functional.cosine_similarity(
        out["image_features"].float(), want, dim=-1)
    assert cos.min() > 0.999
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0,
                                   atol=0, msg=k)


def test_meta_build_sets_the_resnet_statistics(tmp_path, monkeypatch):
    """``create_model`` builds on the meta device and gives the
    FrozenBatchNorm statistics storage: a loaded state dict's values land,
    and the seeded init leaves them at mean 0 / var 1, where no draw sets
    them."""
    from clip_embeds_tpu_torch.core import config as port_config
    from clip_embeds_tpu_torch.core.factory import create_model
    from torch_zoo_fixtures import open_clip_state_dict, tiny_config

    monkeypatch.setitem(port_config.MODEL_CONFIGS, "tiny-resnet",
                        tiny_config("resnet"))
    seeded = create_model("tiny-resnet", seed=0, train=True)
    bns = [m for m in seeded.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(torch.equal(m.running_mean, torch.zeros_like(
        m.running_mean)) and torch.equal(m.running_var, torch.ones_like(
            m.running_var)) for m in bns)
    sd = open_clip_state_dict("resnet", seeded)
    torch.save(sd, tmp_path / "rn.pt")
    loaded = create_model("tiny-resnet", str(tmp_path / "rn.pt"), train=True)
    got = loaded.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
