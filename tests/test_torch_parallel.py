"""parallel/ and the global-batch losses against the JAX package (fp32,
CPU): the gathered losses at 2 and 4 gloo ranks against JAX's functions on
the global batch, value and gradient; ``siglip_loss_ring`` against JAX's
ring on the conftest's 8-device mesh; ``fsdp_param_specs`` and
``clip_param_specs`` against JAX's name by name; the tensor-parallel Llama
forward at 2 ranks against JAX's replicated forward (JAX
tests/test_llama.py's case); ZeRO-1 AdamW against plain AdamW; the batch
split; and ``cli/embed.py``'s data-parallel serving over two CPU replicas.

The ranks run in spawned processes (tests/torch_dist_fixtures.py), one
spawn a world size. A rank's feature gradient is DDP's, the gradient of
the sum over the ranks' losses: over the ranks, divided by their number,
it is JAX's gradient of the global loss. Tolerances: values rtol 1e-5 /
atol 1e-6, gradients rtol 1e-4 / atol 1e-6 (fp32, summation order), the
logits 2e-5 (JAX's own TP test)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch.distributed.tensor import Replicate, Shard

import torch_dist_fixtures as dfx
from clip_embeds_tpu.core.config import get_model_config as jax_config
from clip_embeds_tpu.core.torch_convert import convert_clip_state_dict
from clip_embeds_tpu.losses import clip_loss as JL
from clip_embeds_tpu.losses import coca as JC
from clip_embeds_tpu.losses import siglip as JS
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.parallel import mesh as jmesh
from clip_embeds_tpu.parallel import sharding_rules as jrules
from clip_embeds_tpu_torch.cli import embed as embed_cli
from clip_embeds_tpu_torch.core.config import get_model_config
from clip_embeds_tpu_torch.core.convert import (
    state_dict_from_flax, state_dict_from_jax_params)
from clip_embeds_tpu_torch.models import llama as pllama
from clip_embeds_tpu_torch.models.clip import CLIP
from clip_embeds_tpu_torch.parallel import mesh as pmesh
from clip_embeds_tpu_torch.parallel import sharding_rules as rules
from clip_embeds_tpu_torch.scores.build import config_from_dict, \
    config_to_dict

# the JAX side of each loss case, over the global batch
_JAX = {
    "clip_loss": lambda f: JL.clip_loss(f["img"], f["txt"], 14.0),
    "clip_loss_hard_text": lambda f: JL.clip_loss_hard_text(
        f["img"], f["txt"], f["hard"], 14.0, hard_valid=f["valid"]),
    "distill_clip_loss": lambda f: JL.distill_clip_loss(
        f["img"], f["txt"], 14.0, f["t_img"], f["t_txt"], 20.0),
    "embedding_contrastive_loss": lambda f: JL.embedding_contrastive_loss(
        f["img"], f["txt"]),
    "pacl_clip_loss": lambda f: JL.pacl_clip_loss(f["img"], f["txt"]),
    "siglip_loss_ring": lambda f: JS.siglip_loss(
        f["img"], f["txt"], jnp.asarray(10.0), jnp.asarray(-10.0)),
    "clip_metrics": lambda f: JL.clip_metrics(f["img"], f["txt"], 14.0),
    "caption_loss": lambda f: JC.caption_loss(f["logits"], f["labels"]),
}


def _llama_cfg():
    return jllama.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=8, num_kv_heads=2,
        max_position_embeddings=32)


@pytest.fixture(scope="module")
def llama():
    cfg = _llama_cfg()
    model = jllama.LlamaForCausalLM(cfg, attn_impl="reference")
    ids = np.random.default_rng(5).integers(0, 128, (2, 8)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids)))
    port_cfg = config_from_dict(pllama.LlamaConfig, config_to_dict(cfg))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    return port_cfg, sd, ids, want, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, llama):
    """world -> each rank's results, one spawn a world size."""
    inputs = dfx.loss_inputs()
    port_cfg, sd, ids = llama[:3]
    return inputs, {
        2: dfx.run_ranks(dfx.parallel_rank, 2, tmp_path_factory.mktemp("w2"),
                         inputs, (port_cfg, sd, ids)),
        4: dfx.run_ranks(dfx.parallel_rank, 4, tmp_path_factory.mktemp("w4"),
                         inputs)}


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    return [float(x)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(_JAX))
def test_gathered_loss_matches_jax_global_batch(ranks, name, world):
    inputs, by_world = ranks
    f = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = _flat(_JAX[name](f))
    results = [r["losses"][name] for r in by_world[world]]
    for r in results:  # every rank computes the whole loss
        np.testing.assert_allclose(r["values"], want, rtol=1e-5, atol=1e-6)
    keys = sorted(results[0]["grads"])
    if not keys:
        return
    diff = ("img", "txt", "hard", "logits")
    assert set(keys) <= set(diff)

    def total(*xs):
        return sum(_flat_jax(_JAX[name](dict(f, **dict(zip(diff, xs))))))

    grads = jax.grad(total, argnums=(0, 1, 2, 3))(*(f[k] for k in diff))
    for k in keys:
        got = np.concatenate([r["grads"][k] for r in results]) / world
        np.testing.assert_allclose(got, np.asarray(grads[diff.index(k)]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _flat_jax(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat_jax(item)]
    return [x]


def test_siglip_ring_matches_jax_ring_on_the_mesh(ranks):
    """The port's ring at 4 ranks against JAX's shard_map ring over 8
    devices, both against the global batch's values."""
    inputs, by_world = ranks
    img, txt = jnp.asarray(inputs["img"]), jnp.asarray(inputs["txt"])
    mesh = jmesh.create_mesh(8, 1)
    scale, bias = jnp.asarray(10.0), jnp.asarray(-10.0)
    value, grads = jax.value_and_grad(
        lambda i, t: JS.siglip_loss_ring(i, t, scale, bias, mesh),
        argnums=(0, 1))(img, txt)
    results = [r["losses"]["siglip_loss_ring"] for r in by_world[4]]
    for r in results:
        np.testing.assert_allclose(r["values"], [float(value)], rtol=1e-5)
    for k, g in zip(("img", "txt"), grads):
        got = np.concatenate([r["grads"][k] for r in results]) / 4
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _varying_dims(t: torch.Tensor):
    """The dims along which ``t``'s values vary."""
    return {d for d in range(t.ndim) if t.shape[d] > 1 and not torch.equal(
        t, t.narrow(d, 0, 1).expand_as(t))}


def _indicator(params, axis_of):
    """Each leaf an arange along the dims ``axis_of(path, leaf)`` names
    (zeros where none), so that the port's layout shows which of its dims
    they became."""
    def leaf(path, x):
        dims = axis_of(path, x)
        out = np.zeros(np.shape(x), np.float32)
        for d in dims:
            shape = [1] * np.ndim(x)
            shape[d] = np.shape(x)[d]
            out = out + np.arange(np.shape(x)[d], dtype=np.float32).reshape(
                shape) * (1 + d)
        return out
    return jax.tree_util.tree_map_with_path(leaf, params)


def _tiny_clip():
    sd = dfx.random_state_dict(get_model_config("test-tiny"), seed=3)
    model = CLIP(get_model_config("test-tiny"))
    model.load_state_dict(sd)
    return model, jax.tree.map(np.asarray, convert_clip_state_dict(sd))


@pytest.mark.parametrize("world,min_size", [(2, 64), (4, 64), (2, 2 ** 14)])
def test_fsdp_param_specs_match_jax(world, min_size):
    model, params = _tiny_clip()
    jspecs = jrules.fsdp_param_specs(
        params, jmesh.create_mesh(world, 1, jax.devices()[:world]),
        min_size=min_size)
    flat = {tuple(getattr(k, "key", k) for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))[0]}
    ind = _indicator(params, lambda path, x: [
        d for d, a in enumerate(flat[tuple(getattr(k, "key", k)
                                           for k in path)]) if a == "data"])
    want = {k: _varying_dims(v) for k, v in
            state_dict_from_jax_params(ind).items()}
    # the patchify kernel: JAX's [p * p * 3, W] leaf split on its flattened
    # (kh, kw, c) dim is the port's [W, 3, p, p] kernel split on kh
    if want["visual.conv1.weight"] == {1, 2, 3}:
        want["visual.conv1.weight"] = {2}
    got = rules.fsdp_param_specs(model, world, min_size)
    assert sorted(got) == sorted(want)
    for name, dim in got.items():
        assert want[name] == (set() if dim is None else {dim}), name
    assert sum(d is not None for d in got.values()) > 0


def _model_dims(spec):
    return [d for d, a in enumerate(spec) if a == "model"]


def test_clip_param_specs_match_jax(llama):
    """CLIP's names (the packed in_proj, c_fc, out_proj, c_proj) and the
    Llama trunk's (q/k/v/o, gate/up/down, lm_head), each leaf's
    model-sharded dims in the port's layout."""
    model, params = _tiny_clip()
    jspecs = jrules.clip_param_specs(params)
    ind = jax.tree.map(
        lambda x, s: _indicator({"x": x}, lambda p, y: _model_dims(s))["x"],
        params, jspecs, is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))
    want = {k: _varying_dims(v) for k, v in
            state_dict_from_jax_params(ind).items()}
    got = rules.clip_param_specs(model)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert set(_model_dims(spec)) == want[name], name
    assert sum(bool(_model_dims(s)) for s in got.values()) == \
        6 * (model.cfg.vision.layers + model.cfg.text.layers)

    port_cfg, sd, _, _, lparams = llama
    lm = pllama.LlamaForCausalLM(port_cfg)
    jl = jrules.clip_param_specs(lparams)
    ind = jax.tree.map(
        lambda x, s: _indicator({"x": x}, lambda p, y: _model_dims(s))["x"],
        jax.tree.map(np.asarray, lparams), jl,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    want = {k: _varying_dims(v) for k, v in state_dict_from_flax(ind).items()}
    got = rules.clip_param_specs(lm)
    for name, spec in got.items():
        assert set(_model_dims(spec)) == want[name], name
    assert sum(bool(_model_dims(s)) for s in got.values()) == \
        7 * port_cfg.num_layers + 1


def test_tensor_parallel_llama_matches_jax_replicated(ranks, llama):
    want = llama[3]
    for r in ranks[1][2]:
        np.testing.assert_allclose(r["tp_llama"]["logits"], want,
                                   rtol=2e-5, atol=2e-5)
        sharded = r["tp_llama"]["sharded"]
        # q/k/v/o and gate/up/down of both layers, and lm_head
        assert len(sharded) == 7 * 2 + 1
        assert "lm_head.weight" in sharded
        # JAX's P('data') and P() on the (data, model) mesh
        assert r["tp_llama"]["placements"] == (
            (Shard(0), Replicate()), (Replicate(), Replicate()))


def test_zero1_adamw_matches_plain_adamw(ranks):
    """ZeRO-1 at 2 ranks, each holding the moments of its own share of the
    parameters, against AdamW in one process on the whole batch."""
    results = [r["zero1"] for r in ranks[1][2]]
    after, _, x = results[0]
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                                torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    from clip_embeds_tpu_torch.train.optim import decay_groups

    opt = torch.optim.AdamW(decay_groups(model, 0.1), lr=1e-2,
                            betas=(0.9, 0.98), eps=1e-6)
    for _ in range(2):
        model(x).square().mean().backward()
        opt.step()
        opt.zero_grad()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(after[k], v, rtol=1e-5, atol=1e-6,
                                   msg=k)
        torch.testing.assert_close(results[1][0][k], v, rtol=1e-5,
                                   atol=1e-6, msg=k)
    # the four tensors' moments split over the two ranks
    assert sorted(r[1] for r in results) != [4, 4]
    assert sum(r[1] for r in results) == 4


def test_shard_batch_keeps_contiguous_rows():
    batch = {"a": np.arange(12).reshape(6, 2), "b": np.arange(6)}
    parts = [pmesh.shard_batch(batch, r, 3) for r in range(3)]
    for k, v in batch.items():
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]),
                                      v)
    with pytest.raises(SystemExit, match="--batch-size"):
        pmesh.shard_batch(batch, 0, 4)
    assert not pmesh.distributed() and pmesh.data_world() == 1


def _images(root, n, size=40, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(
            os.path.join(root, f"{i:02d}.png"))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_embed_helpers_over_two_replicas_equal_one(int8):
    from clip_embeds_tpu_torch.core.factory import create_model

    model = create_model("test-tiny", seed=0)
    rng = np.random.default_rng(1)
    size = model.cfg.vision.image_size
    batches = [rng.standard_normal((4, size, size, 3)).astype(np.float32),
               rng.standard_normal((3, size, size, 3)).astype(np.float32)]
    ids = [rng.integers(1, 1000, (4, 77)).astype(np.int32)]
    two = [torch.device("cpu")] * 2
    one = embed_cli.embed_image_batches(model, batches, 4, int8=int8)
    got = embed_cli.embed_image_batches(model, batches, 4, int8=int8,
                                        devices=two)
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)
    assert got.shape == (7, model.cfg.embed_dim)
    t1 = embed_cli.embed_text_batches(model, ids, 4, int8=int8)
    t2 = embed_cli.embed_text_batches(model, ids, 4, int8=int8, devices=two)
    np.testing.assert_allclose(t2, t1, rtol=1e-5, atol=1e-6)


def test_embed_cli_data_parallel_rounds_the_batch(tmp_path, monkeypatch,
                                                  capsys):
    """With two devices visible the CLI serves data-parallel by default,
    rounds --batch-size down to a multiple of them with JAX's line, and
    writes what --no-data-parallel writes."""
    _images(str(tmp_path / "img"), 7)
    monkeypatch.setattr(embed_cli, "visible_devices",
                        lambda device: [device, device])
    common = ["--model", "test-tiny", "--input", str(tmp_path / "img"),
              "--device", "cpu", "--fp32", "--batch-size", "5"]
    assert embed_cli.main(common + ["--output", str(tmp_path / "dp.npy")]) \
        == 0
    out, err = capsys.readouterr()
    assert "batch size rounded to 4 (2-device data parallel)" in err
    assert json.loads(out.strip().splitlines()[-1])["devices"] == 2
    assert embed_cli.main(common + ["--output", str(tmp_path / "one.npy"),
                                    "--no-data-parallel"]) == 0
    out, err = capsys.readouterr()
    assert "rounded" not in err
    assert json.loads(out.strip().splitlines()[-1])["devices"] == 1
    np.testing.assert_allclose(np.load(tmp_path / "dp.npy"),
                               np.load(tmp_path / "one.npy"), rtol=1e-5,
                               atol=1e-6)
