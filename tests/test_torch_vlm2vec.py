"""The port's VLM2Vec modules against the JAX package's on the CPU at a tiny
size (a 2-layer Llama trunk of width 64 with 4 heads, a 32-px tower;
fp32; seeded numpy inputs; JAX params carried across by
``core/convert.py``): last-token and mixed pooling, the LoRA tree
functions and adapter files both ways, the side-path over fp and int8
bases, the int8 base's gradient against ``jax.grad``, the MMEB batches
and the dataclass arguments (the train steps: test_torch_vlm2vec_train.py;
the CLIs and the scorer: test_torch_vlm2vec_cli.py). Tolerances: rtol 1e-5 / atol 1e-5 on embeddings,
1e-4 on adapter gradients and updated parameters, unless stated."""

import json
import os

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds_tpu.core.config import VisionConfig as JVisionConfig
from clip_embeds_tpu.data import mmeb as jmmeb
from clip_embeds_tpu.models import llama as jllama
from clip_embeds_tpu.models import llava as jllava
from clip_embeds_tpu.models import lora as jlora
from clip_embeds_tpu.models import quant as jquant
from clip_embeds_tpu.scores.build import config_to_dict
from clip_embeds_tpu.train import arguments as jargs
from clip_embeds_tpu.train import vlm2vec as jv2v
from clip_embeds_tpu.train.steps import TrainState as JTrainState

from clip_embeds_tpu_torch.core.convert import (jax_params_from_module,
                                                lora_targets_by_key)
from clip_embeds_tpu_torch.core.factory import flatten_params
from clip_embeds_tpu_torch.data import mmeb
from clip_embeds_tpu_torch.models import llava as pllava
from clip_embeds_tpu_torch.models import lora
from clip_embeds_tpu_torch.models.quant import QuantLinear
from clip_embeds_tpu_torch.scores.build import (config_from_dict,
                                                llava_from_params)
from clip_embeds_tpu_torch.train import arguments
from clip_embeds_tpu_torch.train.vlm2vec import make_vlm2vec_train_step

IMG = jllava.IMAGE_TOKEN_INDEX
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
RANK, ALPHA = 4, 8.0


def jax_cfg():
    return jllava.LlavaConfig(
        llama=jllama.LlamaConfig(vocab_size=256, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=4, max_position_embeddings=256),
        vision=JVisionConfig(image_size=32, patch_size=16, width=64,
                             layers=2, head_width=32))


def jmodel(**kw):
    return jllava.Llava(jax_cfg(), attn_impl="reference", **kw)


_JIT = {}


def japply(variables, *args, method, **kw):
    """``jmodel(**kw).apply(variables, *args, method=method)``, jitted once
    per model and method (eager flax dispatches op by op)."""
    key = (method, tuple(sorted(kw.items())))
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda v, *a: jmodel(**kw).apply(
            v, *a, method=method))
    return _JIT[key](variables, *args)


@pytest.fixture(scope="module")
def base():
    """(JAX params with every float leaf moved off its init, the port's
    LlavaConfig)."""
    params = jax.jit(jmodel().init)(
        jax.random.PRNGKey(0), jnp.asarray([[1, IMG, 5, 6]], jnp.int32),
        jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), jax.device_get(params))
    return params, config_from_dict(pllava.LlavaConfig,
                                    config_to_dict(jax_cfg()))


def port(base, quant=False, **kw):
    params, cfg = base
    return llava_from_params(params, cfg, "cpu", torch.float32, quant=quant,
                             **kw)


def jax_adapters(params, seed=3, targets=jlora.DEFAULT_TARGETS):
    """JAX init_lora with b moved off zero, as numpy."""
    tree = jlora.init_lora(params, rank=RANK, rng=jax.random.PRNGKey(seed),
                           targets=targets)
    rng = np.random.default_rng(seed)
    return {k: {"a": np.asarray(v["a"]),
                "b": (0.05 * rng.standard_normal(v["b"].shape)
                      ).astype(np.float32)} for k, v in tree.items()}


def torch_adapters(tree, grad=True):
    return {k: {n: torch.tensor(v).requires_grad_(grad)
                for n, v in ab.items()} for k, ab in tree.items()}


def _t(a):
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def pair_batch(n=4, length=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {k: np.zeros((n, length), t) for k, t in (
        ("qry_ids", np.int32), ("qry_mask", bool), ("tgt_ids", np.int32),
        ("tgt_mask", bool))}
    for i in range(n):
        nq, nt = rng.integers(6, length), rng.integers(4, length)
        out["qry_ids"][i, :nq] = rng.integers(1, 250, nq)
        out["qry_ids"][i, 2] = IMG
        out["qry_mask"][i, :nq] = True
        out["tgt_ids"][i, :nt] = rng.integers(1, 250, nt)
        out["tgt_mask"][i, :nt] = True
    out["qry_pixels"] = rng.standard_normal((n, 32, 32, 3)).astype("f4")
    return out


def mixed_batch(n=4, seed=0):
    from clip_embeds_tpu_torch.cli.train_vlm2vec import (
        _synthetic_mixed_batches)

    return next(_synthetic_mixed_batches(n, 32, seed))


# -- pooling ------------------------------------------------------------------


@pytest.mark.parametrize("with_pixels", [True, False],
                         ids=["image", "text"])
def test_embed_last_token_matches_jax(base, with_pixels):
    b = pair_batch()
    side = "qry" if with_pixels else "tgt"
    ids, mask = b[f"{side}_ids"], b[f"{side}_mask"]
    px = b["qry_pixels"] if with_pixels else None
    want = japply({"params": base[0]}, ids, px, mask,
                  method="embed_last_token")
    with torch.no_grad():
        got = port(base).embed_last_token(
            _t(ids), None if px is None else _t(px), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1,
                               rtol=1e-5)


def test_embed_mixed_matches_jax_and_the_split_paths(base):
    b = mixed_batch()
    args = [b["qry_ids"], b["qry_pixels"], b["qry_image_valid"],
            b["qry_mask"]]
    want = japply({"params": base[0]}, *args, method="embed_mixed")
    model = port(base)
    with torch.no_grad():
        got = model.embed_mixed(*map(_t, args)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        # each row on its own path: image rows as they are, text rows on
        # their real tokens alone (JAX tests/test_vlm2vec.py, 2e-5 there)
        for i, has_image in enumerate(b["qry_image_valid"]):
            n = int(b["qry_mask"][i].sum())
            ids, mask = b["qry_ids"][i:i + 1], b["qry_mask"][i:i + 1]
            if has_image:
                one = model.embed_last_token(_t(ids), _t(b["qry_pixels"][
                    i:i + 1]), _t(mask))
            else:
                one = model.embed_last_token(_t(ids[:, :n]), None,
                                             _t(mask[:, :n]))
            np.testing.assert_allclose(got[i], one[0].numpy(), rtol=2e-5,
                                       atol=2e-5)


# -- the LoRA tree ------------------------------------------------------------


def test_lora_tree_functions_match_jax(base):
    params, _ = base
    model = port(base)
    for targets in (jlora.DEFAULT_TARGETS, ("q_proj", "down_proj")):
        want = jlora.init_lora(params, rank=RANK, targets=targets)
        got = lora.init_lora(model, rank=RANK, targets=targets)
        assert sorted(got) == sorted(want)
        for k in want:
            for n in "ab":
                assert tuple(got[k][n].shape) == want[k][n].shape
            assert not got[k]["b"].any()
        # N(0, 1) / rank
        a = torch.cat([got[k]["a"].flatten() for k in got])
        assert abs(float(a.std()) * RANK - 1) < 0.1
    tree = jax_adapters(params)
    flat = flatten_params(tree)
    nested = {}
    for key, v in flat.items():
        node = nested
        for p in key.split("/")[:-1]:
            node = node.setdefault(p, {})
        node[key.split("/")[-1]] = v
    for layout in (tree, flat, nested):
        got, want = lora.normalize_lora(layout), jlora.normalize_lora(layout)
        assert sorted(got) == sorted(want)
    for bad in ({"x/kernel/c": np.zeros(1)}, {"x/kernel/a": np.zeros(1)}):
        for fn in (lora.normalize_lora, jlora.normalize_lora):
            with pytest.raises(ValueError):
                fn(bad)
    col, jcol = lora.to_collection(tree), jlora.to_collection(tree)
    got = flatten_params({k: v for k, v in col.items()})
    want = flatten_params(jax.device_get(jcol))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    # materialize / merge_lora: the port's merged weights are JAX's
    want = jlora.merge_lora(params, tree, alpha=ALPHA)
    merged = lora.merge_lora(model, tree, alpha=ALPHA)
    got = flatten_params(jax_params_from_module(merged))
    want = flatten_params(jax.device_get(want))
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    sd = lora.materialize(model, tree, ALPHA, rank=2 * RANK)
    key = "language_model.model.layers.0.self_attn.q_proj.weight"
    jk = "language_model/model/layers_0/self_attn/q_proj/kernel"
    want = jlora.materialize(params, tree, ALPHA, rank=2 * RANK)
    np.testing.assert_allclose(
        sd[key].numpy().T, np.asarray(want["language_model"]["model"][
            "layers_0"]["self_attn"]["q_proj"]["kernel"]), **TOL)
    assert merged.language_model.embed_tokens.weight.data_ptr() == \
        model.language_model.embed_tokens.weight.data_ptr()
    # keys that match nothing, and an int8 base, are errors in both
    stray = dict(tree, **{"language_model/nowhere/kernel": tree[jk]})
    with pytest.raises(ValueError, match="matched no param path"):
        jlora.materialize(params, stray)
    with pytest.raises(ValueError, match="matched no param path"):
        lora.materialize(model, stray)
    with pytest.raises(ValueError, match="matched no param path"):
        lora.materialize(port(base, quant=True), tree)


def test_adapter_npz_round_trip_both_ways(base, tmp_path):
    """An adapter file written by either package, as its trainer writes it
    (np.savez of the flattened tree), loads in the other and merges to the
    same weights."""
    from clip_embeds_tpu.core.factory import flatten_params as jflatten
    from clip_embeds_tpu_torch.core.factory import save_params_npz

    params, _ = base
    model = port(base)
    tree = jax_adapters(params)
    jpath = tmp_path / "jax.npz"
    np.savez(jpath, **jflatten(tree))
    ppath = tmp_path / "port.npz"
    save_params_npz({k: {n: v.numpy() for n, v in ab.items()}
                     for k, ab in torch_adapters(tree, False).items()},
                    str(ppath))
    want = flatten_params(jax.device_get(
        jlora.merge_lora(params, dict(np.load(ppath)), alpha=ALPHA)))
    got = flatten_params(jax_params_from_module(
        lora.merge_lora(model, dict(np.load(jpath)), alpha=ALPHA)))
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_side_path_matches_jax_and_materialize(base, quant):
    """The unmaterialized side-path over an fp or W8A8 base against JAX's
    ``lora`` collection; over fp, against ``materialize`` too. A layer
    without an adapter adds nothing."""
    params, _ = base
    tree = jax_adapters(params, targets=("q_proj", "v_proj", "down_proj"))
    b = pair_batch(n=2)
    args = (b["qry_ids"], b["qry_pixels"], b["qry_mask"])
    jparams = jquant.quantize_llava_trunk(params) if quant else params
    q = "dynamic" if quant else ""
    want = japply({"params": jparams, "lora": jlora.to_collection(tree)},
                  *args, method="embed_last_token", quant_llm=q,
                  lora_rank=RANK, lora_alpha=ALPHA)
    model = port(base, quant=quant, lora_rank=RANK, lora_alpha=ALPHA)
    lora.attach_lora(model, tree)
    n_adapted = sum(m.lora is not None
                    for m in lora_targets_by_key(model).values())
    assert n_adapted == len(tree)
    with torch.no_grad():
        got = model.embed_last_token(*map(_t, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        if not quant:
            merged = lora.merge_lora(port(base), tree, alpha=ALPHA)
            mat = merged.embed_last_token(*map(_t, args))
            np.testing.assert_allclose(got.numpy(), mat.numpy(),
                                       rtol=2e-4, atol=2e-5)
        lora.detach_lora(model)
        bare = model.embed_last_token(*map(_t, args))
    want0 = japply({"params": jparams}, *args, method="embed_last_token",
                   quant_llm=q)
    np.testing.assert_allclose(bare.numpy(), np.asarray(want0), **TOL)


def test_side_path_refuses_what_jax_serves_silently(base):
    """Deliberate differences (ROADMAP.md queue 3): where JAX serves an
    adapter tree silently in a way the other adapter mode would not, the
    port raises. JAX's results are shown beside each refusal."""
    params, _ = base
    tree = jax_adapters(params, targets=("q_proj",))
    b = pair_batch(n=2)
    args = (b["qry_ids"], b["qry_pixels"], b["qry_mask"])
    model = port(base, lora_rank=RANK, lora_alpha=ALPHA)

    def jrun(t, rank=RANK):
        return np.asarray(japply(
            {"params": params, "lora": jlora.to_collection(t)}, *args,
            method="embed_last_token", lora_rank=rank, lora_alpha=ALPHA))

    # 1. keys that match no layer: JAX serves them as zero deltas
    stray = {"language_model/model/nowhere/q_proj/kernel":
             next(iter(tree.values()))}
    bare = np.asarray(japply({"params": params}, *args,
                             method="embed_last_token"))
    np.testing.assert_allclose(jrun(stray), bare, **TOL)
    with pytest.raises(ValueError, match="match no layer"):
        lora.attach_lora(model, stray)
    # 2. an adapter of another rank: JAX scales it by the model's rank
    # (alpha / 2r here), materialize by its own (alpha / r)
    twice = jrun(tree, rank=2 * RANK)
    half = {k: {"a": v["a"] / 2, "b": v["b"]} for k, v in tree.items()}
    np.testing.assert_allclose(twice, np.asarray(japply(
        {"params": jlora.materialize(params, half, ALPHA, train=False)},
        *args, method="embed_last_token")), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="has rank"):
        lora.attach_lora(port(base, lora_rank=2 * RANK, lora_alpha=ALPHA),
                         tree)
    # 3. a model without the side-path ignores adapters in JAX
    with pytest.raises(ValueError, match="lora_rank > 0"):
        lora.attach_lora(port(base), tree)
    # 4. the step's lora_alpha: JAX's unmaterialized step ignores it
    state = JTrainState.create(tree, optax.sgd(0.0))
    losses = [float(jax.jit(jv2v.make_vlm2vec_train_step(
        jmodel(lora_rank=RANK, lora_alpha=ALPHA), params, lora_alpha=a))(
        state, pair_batch(n=2))[1]["loss"]) for a in (99.0, ALPHA)]
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="not the step's"):
        make_vlm2vec_train_step(model, lora_alpha=99.0)


# -- the int8 base's gradient ---------------------------------------------------


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_base_gradient_matches_jax_grad(mode):
    """QuantDense(8, use_bias=False, lora_rank=2) over [3, 16]: the codes
    pass no gradient; in dynamic mode the scale max|x| / 127 passes one to
    the abs-max entry of x (the only nonzero entry with zero adapters); in
    static mode the base passes none. With adapters, the side-path's
    gradient adds to it. JAX's gradient, kept for parity (ROADMAP.md
    queue 3: QLoRA proper passes the dequantised base's)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    q, s = jquant.quantize_weight(w)
    jlayer = jquant.QuantDense(8, use_bias=False, mode=mode, lora_rank=2)
    jp = {"kernel_q": q, "scale": s}
    if mode == "static":
        jp["act_scale"] = np.float32(np.abs(x).max() / 127.0)
    layer = QuantLinear(16, 8, mode, bias=False, lora_rank=2)
    layer.weight_q.copy_(torch.from_numpy(q.T.copy()))
    layer.scale.copy_(torch.from_numpy(s))
    if mode == "static":
        layer.act_scale.fill_(float(jp["act_scale"]))
    for ab in ("zero", "random"):
        a = rng.standard_normal((16, 2)).astype(np.float32)
        b = (np.zeros((2, 8)) if ab == "zero" else
             rng.standard_normal((2, 8))).astype(np.float32)
        g = rng.standard_normal((3, 8)).astype(np.float32)

        def f(xx):
            y = jlayer.apply({"params": jp, "lora": {"a": a, "b": b}}, xx)
            return jnp.sum(y * g)

        want = np.asarray(jax.grad(f)(jnp.asarray(x)))
        xt = torch.tensor(x, requires_grad=True)
        layer.lora = (torch.tensor(a), torch.tensor(b))
        (layer(xt) * torch.tensor(g)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), want, **GRAD_TOL)
        if ab == "zero":
            nonzero = np.flatnonzero(want)
            assert len(nonzero) == (1 if mode == "dynamic" else 0)
            if mode == "dynamic":
                assert nonzero[0] == np.abs(x).argmax()


# -- data and arguments -----------------------------------------------------


def write_mmeb_fixture(root, seed=0):
    """Two MMEB-train subsets (rows with and without images on either side)
    and a Combined-route pretrain + instruct pair, images as PNGs."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (20 + 4 * i, 28, 3),
                                     np.uint8)).save(
            os.path.join(root, "img", f"{i}.png"))
    sub_a = [{"qry": f"<|image_1|> find thing {i}",
              "qry_image_path": f"img/{i % 4}.png",
              "pos_text": f"a thing number {i}", "pos_image_path": ""}
             for i in range(5)]
    sub_b = [{"qry": f"which picture shows {i} apples", "qry_image_path": "",
              "pos_text": "<|image_1|> this one",
              "pos_image_path": f"img/{(i + 1) % 4}.png"} for i in range(4)]
    for name, rows in (("A", sub_a), ("B", sub_b)):
        with open(os.path.join(root, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)
    pre = [{"image": f"img/{i}.png", "conversations": [
        {"value": f"<image>\nwhat is {i}"}, {"value": f"it is {i}"}]}
        for i in range(4)]
    ins = [{"image": "img/1.png", "conversations": [
        {"value": "q one"}, {"value": "a one"}, {"value": "q two"},
        {"value": "a two"}]}, {"conversations": [
            {"value": "text only"}, {"value": "answer"}]}]
    for name, rows in (("pre", pre), ("ins", ins)):
        with open(os.path.join(root, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)


def toy_tokenize(text):
    from clip_embeds_tpu_torch.cli.train_vlm2vec import _toy_tokenize

    return _toy_tokenize(text)


def test_mmeb_batches_match_jax(tmp_path):
    write_mmeb_fixture(str(tmp_path))
    rows = {n: json.load(open(tmp_path / f"{n}.json")) for n in "AB"}
    kw = dict(bos_token_id=1, pad_token_id=0, max_len=40, image_size=32,
              seed=3, num_workers=2)
    got = list(mmeb.mixed_pair_batches(mmeb.MMEBTrainDataset(
        rows, str(tmp_path), num_sample_per_subset=4), toy_tokenize, 3,
        **kw))
    want = list(jmmeb.mixed_pair_batches(jmmeb.MMEBTrainDataset(
        rows, str(tmp_path), num_sample_per_subset=4), toy_tokenize, 3,
        **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert any(b["tgt_image_valid"].any() for b in got)
    got = list(mmeb.pair_batches(mmeb.CombinedPairDataset(
        str(tmp_path / "pre.json"), str(tmp_path / "ins.json"),
        str(tmp_path), seed=5), toy_tokenize, 2, **kw))
    want = list(jmmeb.pair_batches(jmmeb.CombinedPairDataset(
        str(tmp_path / "pre.json"), str(tmp_path / "ins.json"),
        str(tmp_path), seed=5), toy_tokenize, 2, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    for ids, has in ((list(range(5)), False), ([1, IMG, 3], True)):
        assert mmeb._place_sentinel(ids, has, 4) == \
            jmmeb._place_sentinel(ids, has, 4)


def test_arguments_match_jax():
    import dataclasses

    classes = ("ModelArguments", "DataArguments", "TrainingArguments",
               "MTEBArguments")
    for name in classes:
        ours, theirs = getattr(arguments, name), getattr(jargs, name)
        assert [(f.name, f.type, f.default) for f in
                dataclasses.fields(ours)] == [
            (f.name, f.type, f.default) for f in dataclasses.fields(theirs)]
    argv = ["--lora", "--lora_r", "8", "--subset_name", "A", "B",
            "--no_bf16", "--gc_q_chunk_size", "4", "--learning_rate", "1e-3",
            "--lora_target_modules", "q_proj,v_proj"]
    got = arguments.parse_dataclasses(
        [getattr(arguments, n) for n in classes[:3]], argv)
    want = jargs.parse_dataclasses(
        [getattr(jargs, n) for n in classes[:3]], argv)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]
    assert got[0].lora_targets == want[0].lora_targets == ("q_proj",
                                                            "v_proj")
