"""Shared fixtures of the zoo tests (``tests/test_torch_zoo*.py``): tiny
configs of every zoo tower, numpy-seeded open_clip state dicts (timm's
unfolded training layout for FastViT and MCi-ViT's stem), the JAX
package's params of them, the port's folded FastViT state dict mapped
onto JAX's tree, one train step on both packages (``check_train_step``),
the training CLIs' helpers, and torch on one thread
(``one_torch_thread``). Files cannot share pytest fixtures under ``--dist
loadfile``, so they import these."""

import contextlib
import copy
import dataclasses
import logging
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_embeds_tpu.core import config as jax_config
from clip_embeds_tpu.core.torch_convert import (
    _layernorm,
    _np,
    _transformer,
    convert_clip_state_dict,
)
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu.train import optim as jax_optim
from clip_embeds_tpu.train import steps as jax_steps
from clip_embeds_tpu_torch.core import config as port_config
from clip_embeds_tpu_torch.core.config import (
    CLIPConfig,
    TextConfig,
    VisionConfig,
)
from clip_embeds_tpu_torch.core.convert import load_open_clip_state_dict
from clip_embeds_tpu_torch.core.factory import save_params_npz
from clip_embeds_tpu_torch.models.clip import CLIP
from clip_embeds_tpu_torch.train import optim, schedules
from clip_embeds_tpu_torch.train.steps import (
    TrainState,
    clip_train_loss,
    make_clip_train_step,
)

TOL = 1e-4

TOWERS = {
    "resnet": dict(tower="resnet", image_size=64, width=16,
                   resnet_layers=(1, 1, 2, 1)),
    "eva": dict(tower="eva", image_size=32, patch_size=16, width=64,
                layers=2, head_width=16, mlp_ratio=2.0),
    "eva02-swiglu": dict(tower="eva02", image_size=48, patch_size=16,
                         width=64, layers=2, head_width=16, mlp_ratio=8 / 3,
                         eva_rope=True, eva_swiglu=True,
                         eva_attn_inner_norm=True,
                         eva_ref_feat_shape=(16, 16)),
    "eva02-post": dict(tower="eva02", image_size=32, patch_size=16,
                       width=64, layers=2, head_width=16, mlp_ratio=2.0,
                       eva_post_norm=True),
    "timm-vit": dict(tower="timm-vit", image_size=32, patch_size=16,
                     width=64, layers=2, head_width=16, pool_type="avg",
                     final_ln_after_pool=True),
    "relpos-vit": dict(tower="relpos-vit", image_size=48, patch_size=16,
                       width=64, layers=2, head_width=16),
    "mci-vit": dict(tower="mci-vit", image_size=64, patch_size=16, width=64,
                    layers=2, head_width=16),
    "swin": dict(tower="swin", image_size=64, patch_size=4, width=16,
                 swin_depths=(2, 2, 2, 2), swin_heads=(2, 2, 4, 4),
                 swin_window=2),
    "vitamin": dict(tower="vitamin", image_size=64, patch_size=16, width=64,
                    layers=2, head_width=16, mlp_ratio=2.0,
                    vitamin_mbconv_dims=(16, 32),
                    vitamin_mbconv_depths=(1, 2)),
    "fastvit": dict(tower="fastvit", image_size=64, patch_size=32, width=64,
                    fastvit_layers=(1, 2, 1, 1), fastvit_dims=(8, 16, 32, 64),
                    mlp_ratio=3.0),
    "convnext-linear": dict(tower="convnext", image_size=64, width=16,
                            convnext_depths=(1, 1, 2, 1),
                            convnext_dims=(16, 32, 64, 128)),
    "convnext-mlp": dict(tower="convnext", image_size=64, width=16,
                         convnext_depths=(1, 1, 2, 1),
                         convnext_dims=(16, 32, 64, 128), head_proj="mlp"),
}
TEXT = dict(context_length=16, width=32, heads=2, layers=1)
# the train-step files' halves of TOWERS, each about half the JAX compile
# time (tests/test_torch_zoo_train{,_2,_remat,_remat_2}.py)
STEP_HALVES = (sorted(TOWERS)[:6], sorted(TOWERS)[6:])


def tiny_config(kind: str) -> CLIPConfig:
    return CLIPConfig(embed_dim=32, vision=VisionConfig(**TOWERS[kind]),
                      text=TextConfig(**TEXT))


def jax_config_of(cfg: CLIPConfig):
    return jax_config.CLIPConfig(
        embed_dim=cfg.embed_dim, quick_gelu=cfg.quick_gelu,
        vision=jax_config.VisionConfig(**dataclasses.asdict(cfg.vision)),
        text=jax_config.TextConfig(**dataclasses.asdict(cfg.text)))


def _value(rng, key: str, shape) -> np.ndarray:
    """Seeded values for one entry: norms near one (BatchNorm variances in
    [0.5, 1.5]), matrices and kernels at fan-in^-1/2, the rest at 0.1."""
    if key.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if len(shape) == 1 and key.endswith("weight"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if len(shape) >= 2 and key.endswith("weight"):
        return rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
    return 0.1 * rng.standard_normal(shape)


def seeded_state_dict(model: torch.nn.Module, seed: int = 0):
    """Every float entry of ``model.state_dict()`` (open_clip's layout)
    drawn from numpy; integer buffers as they are."""
    rng = np.random.default_rng(seed)
    return {k: (torch.from_numpy(np.asarray(_value(
                rng, k, tuple(v.shape)), np.float32))
                if v.is_floating_point() else v.clone())
            for k, v in model.state_dict().items()}


def _mobileone(sd, rng, pre, cin, cout, k, groups, stride):
    """timm's training-layout MobileOneBlock: a kxk conv + BN, a 1x1 scale
    conv + BN where k > 1, and an identity BN where the shape allows."""
    put = _put_fn(sd, rng)
    put(f"{pre}.conv_kxk.0.conv.weight", (cout, cin // groups, k, k))
    put_bn(sd, rng, f"{pre}.conv_kxk.0.bn", cout)
    if k > 1:
        put(f"{pre}.conv_scale.conv.weight", (cout, cin // groups, 1, 1))
        put_bn(sd, rng, f"{pre}.conv_scale.bn", cout)
    if cin == cout and stride == 1:
        put_bn(sd, rng, f"{pre}.identity", cout)


def _put_fn(sd, rng):
    def put(key, shape):
        sd[key] = torch.from_numpy(_value(rng, key, shape).astype(np.float32))
    return put


def put_bn(sd, rng, pre, c):
    put = _put_fn(sd, rng)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        put(f"{pre}.{leaf}", (c,))


def fastvit_train_layout(model: CLIP, seed: int = 0):
    """The port model's text tower and logit scale, and a FastViT trunk in
    timm's unfolded training layout (MobileOne branches with BatchNorms,
    layer scales, the attention pre-BN, RepCPE, SE), as an open_clip
    MobileCLIP-S checkpoint holds it."""
    from clip_embeds_tpu_torch.models.fastvit import SE_RD_RATIO

    rng = np.random.default_rng(seed)
    sd = {k: v for k, v in seeded_state_dict(model, seed).items()
          if not k.startswith("visual.")}
    cfg = model.visual.cfg
    put = _put_fn(sd, rng)
    t = "visual.trunk"
    d0 = cfg.dims[0]
    for i, (ci, co, k, g, s) in enumerate(((3, d0, 3, 1, 2),
                                           (d0, d0, 3, d0, 2),
                                           (d0, d0, 1, 1, 1))):
        _mobileone(sd, rng, f"{t}.stem.{i}", ci, co, k, g, s)

    def se(pre, c):
        rd = max(1, int(c * SE_RD_RATIO))
        put(f"{pre}.fc1.weight", (rd, c, 1, 1))
        put(f"{pre}.fc1.bias", (rd,))
        put(f"{pre}.fc2.weight", (c, rd, 1, 1))
        put(f"{pre}.fc2.bias", (c,))

    for si, (depth, dim) in enumerate(zip(cfg.layers, cfg.dims)):
        sp = f"{t}.stages.{si}"
        if si > 0:
            lk = f"{sp}.downsample.proj.0"
            put(f"{lk}.large_conv.conv.weight", (dim, 1, 7, 7))
            put_bn(sd, rng, f"{lk}.large_conv.bn", dim)
            put(f"{lk}.small_conv.conv.weight", (dim, 1, 3, 3))
            put_bn(sd, rng, f"{lk}.small_conv.bn", dim)
            if cfg.se_downsamples[si]:
                se(f"{lk}.se", dim)
            _mobileone(sd, rng, f"{sp}.downsample.proj.1", dim, dim, 1, 1, 1)
        if si in cfg.pos_embed_stages:
            put(f"{sp}.pos_emb.pos_enc.weight", (dim, 1, 7, 7))
            put(f"{sp}.pos_emb.pos_enc.bias", (dim,))
        hidden = int(dim * cfg.mlp_ratio)
        for bi in range(depth):
            bp = f"{sp}.blocks.{bi}"
            if cfg.token_mixers[si] == "attention":
                put_bn(sd, rng, f"{bp}.norm", dim)
                put(f"{bp}.token_mixer.qkv.weight", (3 * dim, dim))
                put(f"{bp}.token_mixer.proj.weight", (dim, dim))
                put(f"{bp}.token_mixer.proj.bias", (dim,))
                put(f"{bp}.layer_scale_1.gamma", (dim, 1, 1))
                put(f"{bp}.layer_scale_2.gamma", (dim, 1, 1))
            else:
                mix = f"{bp}.token_mixer"
                _mobileone(sd, rng, f"{mix}.mixer", dim, dim, 3, dim, 1)
                put_bn(sd, rng, f"{mix}.norm.identity", dim)
                put(f"{mix}.layer_scale.gamma", (dim, 1, 1))
                put(f"{bp}.layer_scale.gamma", (dim, 1, 1))
            put(f"{bp}.mlp.conv.conv.weight", (dim, 1, 7, 7))
            put_bn(sd, rng, f"{bp}.mlp.conv.bn", dim)
            put(f"{bp}.mlp.fc1.weight", (hidden, dim, 1, 1))
            put(f"{bp}.mlp.fc1.bias", (hidden,))
            put(f"{bp}.mlp.fc2.weight", (dim, hidden, 1, 1))
            put(f"{bp}.mlp.fc2.bias", (dim,))
    _mobileone(sd, rng, f"{t}.final_conv", cfg.dims[-1], cfg.final_dim, 3,
               cfg.dims[-1], 1)
    se(f"{t}.final_conv.se", cfg.final_dim)
    put(f"{t}.head.fc.weight", (cfg.embed_dim, cfg.final_dim))
    put(f"{t}.head.fc.bias", (cfg.embed_dim,))
    return sd


def open_clip_state_dict(kind: str, model: CLIP):
    if kind == "fastvit":
        return fastvit_train_layout(model)
    sd = seeded_state_dict(model)
    if kind == "mci-vit":  # timm's stem: conv (no bias) + BatchNorm
        rng = np.random.default_rng(1)
        for i in range(2):
            pre = f"visual.trunk.patch_embed.backbone.{i}"
            c = sd.pop(f"{pre}.conv.bias").shape[0]
            put_bn(sd, rng, f"{pre}.bn", c)
            sd[f"{pre}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


# the port's folded FastViT modules (under visual.trunk.) -> JAX's paths
_FASTVIT_PATHS = (
    (r"stem\.(\d+)\.reparam_conv", r"stem_\1/conv"),
    (r"stages\.(\d+)\.downsample\.proj\.0\.reparam_conv",
     r"down_\1_lk/conv"),
    (r"stages\.(\d+)\.downsample\.proj\.0\.se\.(fc\d)",
     r"down_\1_lk/se/\2"),
    (r"stages\.(\d+)\.downsample\.proj\.1\.reparam_conv",
     r"down_\1_pw/conv"),
    (r"stages\.(\d+)\.pos_emb\.reparam_conv", r"pos_emb_\1/conv"),
    (r"stages\.(\d+)\.blocks\.(\d+)\.token_mixer\.reparam_conv",
     r"stage_\1_block_\2/mixer/conv"),
    (r"stages\.(\d+)\.blocks\.(\d+)\.token_mixer\.(qkv|proj)",
     r"stage_\1_block_\2/\3"),
    (r"stages\.(\d+)\.blocks\.(\d+)\.mlp\.(conv|fc1|fc2)",
     r"stage_\1_block_\2/ffn/\3"),
    (r"final_conv\.reparam_conv", "final_conv/conv"),
    (r"final_conv\.se\.(fc\d)", r"final_conv/se/\1"),
    (r"head\.fc", "head"),
)


def fastvit_flax_visual(sd):
    """The port's folded FastViT tower (``visual.trunk.*`` of its
    ``state_dict``) -> JAX's FastViTTower params: conv kernels to HWIO, the
    SE 1x1 convs and the linears to [in, out] Dense kernels."""
    out = {}
    for key, value in sd.items():
        if not key.startswith("visual.trunk."):
            continue
        mod, leaf = key[len("visual.trunk."):].rsplit(".", 1)
        pat, rep = next((p, r) for p, r in _FASTVIT_PATHS
                        if re.fullmatch(p, mod))
        path = re.sub(pat, rep, mod).split("/")
        a = _np(value)
        if leaf == "weight":
            leaf = "kernel"
            if a.ndim == 4:
                a = a[:, :, 0, 0].T if "se" in path else \
                    a.transpose(2, 3, 1, 0)
            else:
                a = a.T
        node = out
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = a
    return out


def jax_params(kind: str, cfg: CLIPConfig, sd):
    """JAX's CLIP params of an open_clip state dict (FastViT's folded or
    training layout; ConvNeXt, which JAX's converter does not dispatch,
    through ``convert_convnext_tower``)."""
    sdn = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    folded = "visual.trunk.stem.0.reparam_conv.weight" in sdn
    if cfg.vision.tower != "convnext" and not folded:
        return convert_clip_state_dict(sdn, vision_tower=cfg.vision.tower)
    if folded:
        visual = fastvit_flax_visual(sdn)
    else:
        from clip_embeds_tpu.models.convnext import (
            ConvNeXtConfig,
            convert_convnext_tower,
        )

        v = cfg.vision
        visual = convert_convnext_tower(sdn, ConvNeXtConfig(
            depths=v.convnext_depths, dims=v.convnext_dims,
            embed_dim=cfg.embed_dim, proj=v.head_proj,
            image_size=v.image_size))
    text = {"token_embedding": {
                "embedding": _np(sdn["token_embedding.weight"])},
            "positional_embedding": _np(sdn["positional_embedding"]),
            "transformer": _transformer(sdn, "transformer", cfg.text.layers),
            "ln_final": _layernorm(sdn, "ln_final"),
            "text_projection": _np(sdn["text_projection"])}
    return {"visual": visual, "text": text,
            "logit_scale": _np(sdn["logit_scale"]).reshape(())}


def inputs(cfg: CLIPConfig, seed: int = 0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.standard_normal((2, s, s, 3)).astype(np.float32)
    ids = rng.integers(1, 1000, (2, cfg.text.context_length))
    ids[:, 5] = 49407  # EOT: the argmax pool's position
    return images, ids.astype(np.int32)


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module: these tiny models' ops gain
    nothing from more, and under the suite's workers a thread a core each
    oversubscribes the host several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- one train step on both packages (tests/test_torch_zoo_train*.py) --

LR = 1e-4
# JAX's FrozenBatchNorm holds its statistics as parameters; the port's are
# buffers (test_resnet_statistics_stay_frozen)
_STATS = ("mean", "var")


def recording(tx):
    """``tx``, whose state also keeps the last gradients it was given
    (``opt_state[0]``), so one JAX step gives both."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def jit_safe(kind: str):
    """The context to trace JAX's ``kind`` tower in. JAX's Swin builds its
    shift mask with ``np.asarray`` on a jnp array (``models/swin.py:86``),
    which fails under ``jax.jit`` (so JAX's train CLI cannot train it):
    here JAX's own mask function runs under ``ensure_compile_time_eval``."""
    if kind != "swin":
        return contextlib.nullcontext()
    from clip_embeds_tpu.models import swin as jax_swin

    real = jax_swin._shift_attn_mask

    def eager(*args):
        with jax.ensure_compile_time_eval():
            return real(*args)

    return mock.patch.object(jax_swin, "_shift_attn_mask", eager)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree, np.float64)}


def is_stat(kind: str, path: str) -> bool:
    return kind == "resnet" and path.rsplit("/", 1)[-1] in _STATS


def setup(kind: str, remat=False, **kw):
    cfg = tiny_config(kind)
    model = CLIP(cfg, remat=remat, **kw).train()
    sd = open_clip_state_dict(kind, model)
    load_open_clip_state_dict(model, dict(sd))
    return cfg, model, jax_params(kind, cfg, sd)


def make_batch(cfg, n: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    ids = rng.integers(1, 1000, (n, cfg.text.context_length))
    ids[:, 5 + np.arange(n) % 4] = 49407  # EOT: the argmax pool's position
    return {"images": rng.standard_normal((n, s, s, 3)).astype(np.float32),
            "texts": ids.astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def tree_of(kind, cfg, model, values=None):
    """JAX's tree of the port model's state dict, through the converter;
    ``values`` (parameter name -> tensor) replaces the parameters first
    (gradients, labels)."""
    if values is not None:
        model = copy.deepcopy(model)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(values[name])
    return flat(jax_params(kind, cfg, model.state_dict()))


def indicator(model, flags):
    return {name: torch.full_like(p, float(flags[name]))
            for name, p in model.named_parameters()}


def check_train_step(kind: str, remat) -> None:
    """One step of the tiny ``kind`` CLIP on the port and on JAX's
    ``make_clip_train_step`` with ``adamw`` (lr ``LR``, weight decay 0.1),
    fp32: the loss within 1e-5, the gradients within 1e-4 of JAX's largest
    |gradient|, the updated weights within 1e-5, over 90% of them moved.
    ModifiedResNet's statistics are left out
    (``test_resnet_statistics_stay_frozen``)."""
    cfg, model, params = setup(kind, remat)
    batch = make_batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jmodel = JaxCLIP(jax_config_of(cfg), attn_impl="reference", remat=remat)

    # the optimiser keeps the step's gradients in its state
    jstate = jax_steps.TrainState.create(
        params, recording(jax_optim.adamw(LR, weight_decay=0.1)))
    with jit_safe(kind):
        jstate, jm = jax.jit(jax_steps.make_clip_train_step(jmodel))(
            jstate, jbatch)
    jgrads = flat(jstate.opt_state[0])

    loss, _ = clip_train_loss(model, to_torch(batch))
    loss.backward()
    grads = tree_of(kind, cfg, model,
                    {k: p.grad for k, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    state = TrainState(model, optim.adamw(model, LR, weight_decay=0.1),
                       schedules.const_lr(LR))
    metrics = make_clip_train_step(model)(state, to_torch(batch))

    assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]),
                                                   abs=1e-5)
    assert loss.item() == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert sorted(grads) == sorted(jgrads)
    top = max(np.abs(g).max() for g in jgrads.values())
    for path, g in jgrads.items():
        if not is_stat(kind, path):
            np.testing.assert_allclose(grads[path], g, rtol=0,
                                       atol=1e-4 * top, err_msg=path)
    updated = tree_of(kind, cfg, model)
    new = {k: v for k, v in flat(jstate.params).items()
           if not is_stat(kind, k)}
    for path, p in new.items():
        np.testing.assert_allclose(updated[path], p, rtol=0, atol=1e-5,
                                   err_msg=path)
    moved = sum(not np.array_equal(p, flat(params)[k])
                for k, p in new.items())
    assert moved > 0.9 * len(new)


# -- the training CLIs on tiny zoo models (tests/test_torch_zoo_train_cli*)

# lr 1e-4 and warmup 1: the second step's loss reads the first update
CLI_COMMON = ["--dataset-type", "synthetic", "--precision", "fp32",
              "--batch-size", "8", "--train-num-samples", "16", "--lr",
              "1e-4", "--warmup", "1", "--wd", "0.1", "--log-every", "1"]


def register_tiny(monkeypatch, kind):
    """The tiny ``kind`` config registered in both packages for a test;
    (its name, the port's config)."""
    name = f"tiny-zoo-{kind}"
    cfg = tiny_config(kind)
    monkeypatch.setitem(port_config.MODEL_CONFIGS, name, cfg)
    monkeypatch.setitem(jax_config.MODEL_CONFIGS, name, jax_config_of(cfg))
    return name, cfg


def cli_checkpoints(tmp_path, kind, cfg):
    """(the port's file, JAX's): one seeded open_clip state dict as a .pt
    for both, or for ConvNeXt, which JAX's converter does not dispatch,
    its JAX params as an .npz for the JAX CLI."""
    sd = open_clip_state_dict(kind, CLIP(cfg))
    pt = tmp_path / "ckpt.pt"
    torch.save(sd, pt)
    if cfg.vision.tower != "convnext":
        return str(pt), str(pt), sd
    npz = tmp_path / "ckpt.npz"
    save_params_npz(jax_params(kind, cfg, sd), str(npz))
    return str(pt), str(npz), sd


def step_losses(caplog):
    """The full-precision loss of each step's log line (both CLIPs log
    'epoch %d step %d loss %.4f ...' with the loss as the third
    argument)."""
    return [r.args[2] for r in caplog.records if isinstance(r.msg, str)
            and r.msg.startswith("epoch %d step %d loss")]


def run_logged(caplog, fn, argv):
    """(``fn(argv)``, the losses its log lines gave)."""
    caplog.clear()
    with caplog.at_level(logging.INFO):
        state = fn(argv)
    return state, step_losses(caplog)
