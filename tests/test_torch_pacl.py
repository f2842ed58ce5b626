"""The port's PACL/SPARC slice against the JAX package's (CPU, fp32): the
heads (models/heads.py), their weights across packages (core/convert.py,
the .npz of core/factory.py), the SPARC losses, the frozen-tower train step
with Adam, the caption data and the head trainer's CLI. The same seeded
numpy inputs go through both; tolerances are stated per test (1e-5 for the
heads, losses, gradients and Adam steps)."""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.core.factory import load_params as jax_load_params
from clip_embeds_tpu.core.factory import save_params_npz as jax_save_npz
from clip_embeds_tpu.data import pacl_data as jax_pacl_data
from clip_embeds_tpu.losses import sparc as jax_sparc
from clip_embeds_tpu.losses.clip_loss import pacl_clip_loss as jax_pacl_loss
from clip_embeds_tpu.models import heads as jax_heads
from clip_embeds_tpu.models.clip import l2_normalize as jax_l2n
from clip_embeds_tpu.text.tokenizer import simple_pos_tagger as jax_tagger
from clip_embeds_tpu.train.steps import TrainState as JaxTrainState
from clip_embeds_tpu.train.steps import (
    make_frozen_tower_train_step as jax_make_step,
)
from clip_embeds_tpu_torch.cli import train_pacl
from clip_embeds_tpu_torch.core.convert import (
    head_state_dict_from_jax_params,
    jax_params_from_head,
)
from clip_embeds_tpu_torch.core.factory import (
    load_params_npz,
    save_params_npz,
)
from clip_embeds_tpu_torch.data import pacl_data
from clip_embeds_tpu_torch.losses import sparc
from clip_embeds_tpu_torch.models import heads
from clip_embeds_tpu_torch.text.tokenizer import simple_pos_tagger
from clip_embeds_tpu_torch.train.optim import adam
from clip_embeds_tpu_torch.train.schedules import const_lr
from clip_embeds_tpu_torch.train.steps import (
    TrainState,
    make_frozen_tower_train_step,
)

B, P, DV, DT, T, D = 3, 6, 16, 12, 7, 8  # batch, patches, widths, tokens


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


def _close(got, want, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _text_ids(seed=0):
    """[B, T] ids with the EOT (the largest id) at varied positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (B, T)).astype(np.int32)
    for row, eot in zip(ids, (2, T - 1, 4)):
        row[eot] = 49407
        row[eot + 1:] = 0
    return ids


def _jax_head(kind, **kw):
    if kind == "pacl":
        return jax_heads.PACLHead(proj_dim=D, **kw), (B, DT)
    return jax_heads.SPARCHead(proj_dim=D, **kw), (B, T, DT)


def _port_head(kind, **kw):
    cls = heads.PACLHead if kind == "pacl" else heads.SPARCHead
    return cls(DV, DT, D, **kw)


def _both_heads(kind, seed=0, **kw):
    """A JAX head initialised from PRNGKey(seed) and the port's head loaded
    with the same (converted) params; the JAX params with their inputs."""
    jhead, tshape = _jax_head(kind, **kw)
    patches, text = _rand(B, P, DV, seed=seed + 1), _rand(*tshape,
                                                          seed=seed + 2)
    params = jhead.init(jax.random.PRNGKey(seed), patches, text)["params"]
    # non-trivial LayerNorm params, so a swapped scale/bias would show
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * _rand(*np.shape(a), seed=seed + 3),
        params)
    head = _port_head(kind, **kw)
    head.load_state_dict(head_state_dict_from_jax_params(params))
    return jhead, params, head.eval(), patches, text


def test_apply_rope_matches_jax():
    x = _rand(2, 9, 10)
    _close(heads.apply_rope(torch.from_numpy(x)),
           jax_heads.apply_rope(jnp.asarray(x)))
    with pytest.raises(ValueError, match="even"):
        heads.apply_rope(torch.zeros(1, 3, 5))


def test_patch_alignment_matches_jax():
    v, t = _rand(B, P, D, seed=1), _rand(B, D, seed=2)
    _close(heads.patch_alignment(torch.from_numpy(v), torch.from_numpy(t)),
           jax_heads.patch_alignment(jnp.asarray(v), jnp.asarray(t)))


def test_language_mask_matches_jax():
    ids = _text_ids()
    got = heads.language_mask_from_ids(torch.from_numpy(ids).long())
    want = jax_heads.language_mask_from_ids(jnp.asarray(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum(1).tolist() == [3, T, 5]


@pytest.mark.parametrize("pooling", ["uniform", "weighted"])
@pytest.mark.parametrize("rope", ["none", "before", "after"])
def test_pacl_head_matches_jax(rope, pooling):
    jhead, params, head, patches, text = _both_heads(
        "pacl", rope=rope, pooling=pooling)
    want = jhead.apply({"params": params}, patches, text)
    got = head(torch.from_numpy(patches), torch.from_numpy(text))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, D)
        _close(g, w)


@pytest.mark.parametrize("rope", [False, True])
def test_sparc_head_matches_jax(rope):
    jhead, params, head, patches, text = _both_heads("sparc", rope=rope)
    want = jhead.apply({"params": params}, patches, text)
    got = head(torch.from_numpy(patches), torch.from_numpy(text))
    assert got[0].shape == (B, P, D) and got[1].shape == (B, T, D)
    for g, w in zip(got, want):
        _close(g, w)


def _tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.shape(x) == np.shape(y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["pacl", "sparc"])
def test_head_params_round_trip(kind):
    """JAX params -> the port's head -> JAX params, unchanged; the port's
    fresh init has the JAX layout and flax's statistics."""
    _, params, head, _, _ = _both_heads(kind)
    _tree_equal(jax_params_from_head(head), params)
    fresh = heads.init_head(_port_head(kind), seed=3)
    tree = jax_params_from_head(fresh)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    assert np.array_equal(tree["text_projection"]["ln"]["scale"], np.ones(DT))
    assert not tree["visual_projection"]["proj"]["linear"]["bias"].any()
    k = tree["visual_projection"]["proj"]["mlp_in"]["kernel"]  # [DV, D]
    assert np.abs(k).max() <= 2 / DV ** 0.5 / .87962566103423978
    _tree_equal(jax_params_from_head(heads.init_head(_port_head(kind), 3)),
                tree)


@pytest.mark.parametrize("kind", ["pacl", "sparc"])
def test_npz_heads_read_by_both_packages(tmp_path, kind):
    _, params, head, _, _ = _both_heads(kind)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "jax.npz")
    save_params_npz(jax_params_from_head(head), ours)
    jax_save_npz(params, theirs)
    _tree_equal(jax_load_params(ours), params)
    _tree_equal(load_params_npz(theirs), params)
    assert sorted(np.load(ours).files) == sorted(np.load(theirs).files)


def _grads_close(fn_torch, fn_jax, arrays, atol=1e-5):
    """fn over the arrays and its gradient in each, both packages."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn_torch(*ts)
    out.backward()
    want, wgrads = jax.value_and_grad(fn_jax, argnums=tuple(
        range(len(arrays))))(*map(jnp.asarray, arrays))
    _close(out, want, atol)
    for t, g in zip(ts, wgrads):
        _close(t.grad, g, atol)


@pytest.mark.parametrize("sigma", [1 / P, 0.5])
def test_sparc_group_patches_matches_jax(sigma):
    v, t = _rand(B, P, D, seed=4), _rand(B, T, D, seed=5)
    w = _rand(B, T, D, seed=6)  # a fixed cotangent
    _grads_close(
        lambda a, b: (sparc.sparc_group_patches(a, b, sigma)
                      * torch.from_numpy(w)).sum(),
        lambda a, b: (jax_sparc.sparc_group_patches(a, b, sigma) * w).sum(),
        [v, t])


def test_masked_pairwise_loss_matches_jax():
    a, b = _rand(B, T, D, seed=7), _rand(B, T, D, seed=8)
    mask = heads.language_mask_from_ids(
        torch.from_numpy(_text_ids()).long()).numpy()
    _grads_close(
        lambda x, y: sparc.masked_pairwise_contrastive_loss(
            x, y, torch.from_numpy(mask), 2.0),
        lambda x, y: jax_sparc.masked_pairwise_contrastive_loss(
            x, y, mask, 2.0),
        [a, b])


def test_sparc_loss_matches_jax():
    v = _rand(B, P, D, seed=9)
    t = np.asarray(jax_l2n(_rand(B, T, D, seed=10)))
    g = np.asarray(jax_l2n(_rand(B, T, D, seed=11)))
    mask = heads.language_mask_from_ids(
        torch.from_numpy(_text_ids()).long()).numpy()
    kw = dict(temperature=0.1, global_weight=0.5, local_weight=1.0)
    _grads_close(
        lambda a, b, c: sparc.sparc_loss(a, b, c, torch.from_numpy(mask),
                                         **kw),
        lambda a, b, c: jax_sparc.sparc_loss(a, b, c, mask, **kw),
        [v, t, g])


def _jax_objective(kind, sigma=1 / P, temperature=0.1):
    """The JAX train_pacl's loss of the head's outputs and the ids."""
    def loss(out, ids):
        if kind == "pacl":
            return jax_pacl_loss(*out, temperature)
        vproj, tproj = out
        tnorm = jax_l2n(tproj)
        grouped = jax_l2n(jax_sparc.sparc_group_patches(vproj, tnorm, sigma))
        return jax_sparc.sparc_loss(vproj, tnorm, grouped,
                                    jax_heads.language_mask_from_ids(ids),
                                    temperature=temperature)
    return loss


@pytest.mark.parametrize("kind", ["pacl", "sparc"])
def test_frozen_tower_steps_match_jax(kind):
    """3 steps of the frozen-tower step with Adam (lr 1e-4) at dropout 0,
    from the same head params and features: losses and params equal to
    JAX's within 1e-5."""
    kw = {"pooling": "weighted"} if kind == "pacl" else {}
    jhead, params, head, _, _ = _both_heads(kind, dropout=0.0, **kw)
    head.train()
    jax_loss = _jax_objective(kind)
    ids = _text_ids()
    batches = [(_rand(B, P, DV, seed=20 + s),
                _rand(*((B, DT) if kind == "pacl" else (B, T, DT)),
                      seed=30 + s)) for s in range(3)]
    # the trainer's own loss: temperature 0.1, sigma 1 / P for SPARC
    args = train_pacl.parse_args(["--objective", kind])
    cfg = SimpleNamespace(vision=SimpleNamespace(num_patches=P))
    loss_of_head = train_pacl.make_head_loss(args, cfg, None)

    def loss_of_params(p, feats, batch):
        out = jhead.apply({"params": p}, *feats, train=True)
        return jax_loss(out, batch["texts"]), {}

    state = TrainState(head, adam(head, 1e-4), const_lr(1e-4))
    step = make_frozen_tower_train_step(loss_of_head)
    jstate = JaxTrainState.create(params, optax.adam(1e-4))
    jstep = jax.jit(jax_make_step(loss_of_params))
    for feats in batches:
        got = step(state, tuple(map(torch.from_numpy, feats)),
                   {"texts": torch.from_numpy(ids).long()})
        jstate, want = jstep(jstate, feats, {"texts": jnp.asarray(ids)})
        _close(got["loss"], want["loss"])
    assert state.step == int(jstate.step) == 3
    moved = jax.tree.map(lambda a, b: np.abs(np.asarray(a) - b).max(),
                         jstate.params, params)
    assert min(jax.tree.leaves(moved)) > 1e-5  # every tensor moved
    for got, want in zip(jax.tree.leaves(jax_params_from_head(head)),
                         jax.tree.leaves(jstate.params)):
        _close(got, want)


def test_dropout_masks_follow_the_seed():
    """Dropout draws its masks from the generator: the same seed gives the
    same masks, another seed others; the drop rate is near the rate; eval
    mode and rate 0 drop nothing."""
    x = torch.ones(64, 64, 32)

    def masks(seed, rate=0.25):
        g = torch.Generator().manual_seed(seed)
        return [heads.dropout(x, rate, g) == 0 for _ in range(2)]

    a, b, c = masks(0), masks(0), masks(1)
    assert all(torch.equal(m, n) for m, n in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])
    assert abs(a[0].float().mean().item() - 0.25) < 0.01
    kept = heads.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {
        0.0, float(torch.tensor(1.0) / 0.75)}
    assert heads.dropout(x, 0.0) is x
    head = heads.init_head(_port_head("pacl", dropout=0.5))
    p, t = torch.from_numpy(_rand(B, P, DV)), torch.from_numpy(_rand(B, DT))
    outs = [head.train()(p, t, torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    assert torch.equal(head.eval()(p, t)[0], head(p, t)[0])


def _gold_captions():
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "noun_chunks_gold.json")
    with open(path) as fh:
        return [s["caption"] for s in json.load(fh)["samples"]]


def test_pos_tagger_and_noun_phrases_match_jax():
    captions = _gold_captions()
    assert len(captions) >= 10
    for caption in captions:
        words = caption.split()
        assert simple_pos_tagger(words) == jax_tagger(words)
        assert pacl_data.regex_noun_phrases(caption) == \
            jax_pacl_data.regex_noun_phrases(caption)


def test_prompt_sampler_matches_jax():
    ours = pacl_data.CaptionPromptSampler(seed=3)
    theirs = jax_pacl_data.CaptionPromptSampler(seed=3)
    captions = _gold_captions() * 3
    assert [ours(c) for c in captions] == [theirs(c) for c in captions]


def _write_pacl_data(root, n=7, embed_dim=5):
    """LLaVA-format annotations (one image-less sample, one multi-turn),
    JPEG images and a .npy of text embeddings aligned by row."""
    img_dir = root / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    ann = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)
                        ).save(img_dir / f"{i}.jpg")
        turns = [{"from": "human", "value": "<image>\nDescribe."},
                 {"from": "gpt", "value": f"A small red dog number {i} on "
                  "the wooden table"}]
        if i % 3 == 1:
            turns += [{"from": "human", "value": "More?"},
                      {"from": "gpt", "value": "the old lamp near a cup"}]
        ann.append({"image": f"{i}.jpg", "conversations": turns})
    ann.insert(3, {"conversations": [{"from": "human", "value": "hi"}]})
    (root / "ann.json").write_text(json.dumps(ann))
    embeds = rng.standard_normal((n + 1, embed_dim)).astype(np.float32)
    np.save(root / "embeds.npy", embeds)
    return str(root / "ann.json"), str(img_dir), str(root / "embeds.npy")


@pytest.mark.parametrize("pretraining", [(), (False,)])
def test_pacl_dataset_and_batches_match_jax(tmp_path, pretraining):
    """The same samples, pixels bit for bit, prompts, tokens and embedding
    rows, and the same per-epoch shuffle (one worker: the prompt draws are
    then in sample order in both)."""
    ann, root, embeds = _write_pacl_data(tmp_path)
    kw = dict(image_size=32, embed_paths=[embeds],
              pretraining=pretraining, seed=4)
    ours = pacl_data.PACLCaptionDataset([ann], [root], **kw)
    theirs = jax_pacl_data.PACLCaptionDataset([ann], [root], **kw)
    assert len(ours) == len(theirs) == 7
    for epoch in (0, 1):
        got = list(pacl_data.pacl_batches(ours, 3, seed=2, epoch=epoch,
                                          num_workers=1))
        want = list(jax_pacl_data.pacl_batches(theirs, 3, seed=2,
                                               epoch=epoch, num_workers=1))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["images", "text_embeddings",
                                              "texts"]
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    pixels, prompt, emb = ours.get(0)
    assert pixels.shape == (32, 32, 3) and isinstance(prompt, str)
    np.testing.assert_array_equal(emb, np.load(embeds)[0])


# -- the head trainer's CLI ---------------------------------------------------

_TINY = ["--model", "test-tiny", "--synthetic", "--batch-size", "4",
         "--train-num-samples", "8", "--log-every", "1", "--proj-dim", "16"]


@pytest.mark.parametrize("objective,extra", [
    ("pacl", ["--rope", "after"]), ("sparc", ["--rope", "before"]),
    ("pacl", ["--embed-paths", "x.npy", "--pooling", "uniform"])])
def test_train_pacl_cli_on_cpu(tmp_path, objective, extra, caplog):
    """--device cpu --synthetic trains on the composable route; the saved
    .npz has the keys and shapes of the JAX head's params."""
    out = str(tmp_path / "head.npz")
    with caplog.at_level("INFO"):
        state = train_pacl.main(_TINY + ["--objective", objective,
                                         "--device", "cpu", "--output",
                                         out] + extra)
    assert state.step == 2
    assert "frozen tower route: composable" in caplog.text
    losses = [r.args[2] for r in caplog.records
              if str(r.msg).startswith("epoch %d step %d loss")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert state.report["losses"] == losses
    assert len(state.report["samples_per_s"]) == 2
    assert (state.report["route"], state.report["gate_cos"],
            state.report["peak_gib"]) == ("composable", None, None)
    # test-tiny: vision width, text width and embed_dim are all 64
    dt = 4096 if "--embed-paths" in extra else 64
    jhead = (jax_heads.PACLHead(proj_dim=16) if objective == "pacl"
             else jax_heads.SPARCHead(proj_dim=16))
    text = np.zeros((1, dt) if objective == "pacl" else (1, 77, dt), "f4")
    want = jhead.init(jax.random.PRNGKey(0), np.zeros((1, 4, 64), "f4"),
                      text)["params"]
    got = jax_load_params(out)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32


def test_train_pacl_cli_on_caption_data(tmp_path, caplog):
    """--data / --image-roots / --embed-paths: LLaVA-format captions with
    precomputed text embeddings (the LLM2CLIP-PACL variant) train a head
    whose text side takes the embeddings' width."""
    ann, root, embeds = _write_pacl_data(tmp_path, embed_dim=24)
    out = str(tmp_path / "head.npz")
    with caplog.at_level("INFO"):
        state = train_pacl.main([
            "--model", "test-tiny", "--device", "cpu", "--data", ann,
            "--image-roots", root, "--embed-paths", embeds, "--batch-size",
            "3", "--epochs", "2", "--log-every", "1", "--proj-dim", "16",
            "--output", out])
    assert state.step == 4  # 7 samples: 2 batches of 3 an epoch
    losses = [r.args[2] for r in caplog.records
              if str(r.msg).startswith("epoch %d step %d loss")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    kernel = load_params_npz(out)["text_projection"]["proj"]["kernel"]
    assert kernel.shape == (24, 16)


@pytest.mark.parametrize("requested,device,route", [
    ("auto", "cuda", "fused"), ("auto", "cpu", "composable"),
    ("fused", "cuda", "fused"), ("int8", "cuda", "int8"),
    ("composable", "cuda", "composable"), ("composable", "cpu", "composable"),
    ("fused", "cpu", None), ("int8", "cpu", None)])
def test_frozen_tower_route_rules(requested, device, route):
    """'auto' is the fused kernels on the card and composable elsewhere;
    the kernel routes are refused off the card, never swapped for
    composable."""
    from clip_embeds_tpu_torch.core.factory import create_model

    model = create_model("test-tiny")
    if route is None:
        with pytest.raises(SystemExit, match="need the card"):
            train_pacl.frozen_tower_route(requested, torch.device(device),
                                          model)
    else:
        assert train_pacl.frozen_tower_route(
            requested, torch.device(device), model) == route


@pytest.mark.parametrize("route", ["fused", "int8"])
def test_kernel_routes_are_refused_off_the_card(route):
    with pytest.raises(SystemExit, match="need the card"):
        train_pacl.main(_TINY + ["--device", "cpu", "--frozen-tower",
                                 route])


def test_default_device_is_the_card(monkeypatch):
    assert train_pacl.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_pacl.main(_TINY)


def test_kernel_route_gate(monkeypatch, caplog):
    """The fused route (on the CPU through the kernels' plain versions) is
    held to the composable tower on the first batch: it passes at full
    agreement, and features off by more than the 0.999 cosine are
    refused with the cosine named."""
    from clip_embeds_tpu_torch.models import serving

    monkeypatch.setattr(train_pacl, "frozen_tower_route",
                        lambda requested, device, model: "fused")
    with caplog.at_level("INFO"):
        state = train_pacl.main(_TINY + ["--device", "cpu"])
    assert state.step == 2
    cos = [r.args[1] for r in caplog.records
           if "patch-token cosine" in str(r.msg)]
    assert len(cos) == 1 and cos[0] >= 0.999
    assert state.report["gate_cos"] == cos[0]
    real = serving.fused_encode_image

    def noisy(*a, **kw):
        pooled, tokens = real(*a, **kw)
        return pooled, tokens + 0.1 * torch.randn_like(tokens)

    monkeypatch.setattr(serving, "fused_encode_image", noisy)
    with pytest.raises(SystemExit, match=r"first-batch cosine 0\.9\d+ < "
                                         r"0\.999"):
        train_pacl.main(_TINY + ["--device", "cpu"])
