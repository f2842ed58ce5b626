"""One step of each VLM2Vec train-step mode of the port against the JAX
package's, with and without GradCache, on the CPU at the tiny size of
test_torch_vlm2vec.py (fp32; seeded numpy batches): materialized adapters
and the unmaterialized side-path on image-query pairs; materialized
adapters, the side-path over a W8A8 trunk and full fine-tuning on mixed
batches. Tolerances: the loss rtol 1e-5; the updated tensors rtol 1e-4 /
atol 1e-4 (SGD at lr 1, so they hold the gradients)."""

import jax
import numpy as np
import optax
import pytest
import torch

from clip_embeds_tpu.models import quant as jquant
from clip_embeds_tpu.train import vlm2vec as jv2v
from clip_embeds_tpu.train.steps import TrainState as JTrainState

from clip_embeds_tpu_torch.core.convert import jax_params_from_module
from clip_embeds_tpu_torch.core.factory import flatten_params
from clip_embeds_tpu_torch.models import lora
from clip_embeds_tpu_torch.train.vlm2vec import (
    Vlm2VecState, make_vlm2vec_mixed_train_step, make_vlm2vec_train_step)
from test_torch_vlm2vec import (ALPHA, GRAD_TOL, RANK, _t, base,  # noqa: F401
                                jax_adapters, jmodel, mixed_batch,
                                pair_batch, port, torch_adapters)


# -- train steps ----------------------------------------------------------------


MODES = ["pair-materialized", "pair-side", "mixed-materialized",
         "mixed-side-int8", "mixed-full"]


@pytest.mark.parametrize("chunks", [0, 2], ids=["plain", "gradcache"])
@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(base, mode, chunks):
    """One step of each mode in both packages with SGD at lr 1, so the
    updated tensors hold the gradients: the loss, every trainable tensor
    after the step, and (adapter modes) the base unchanged and given no
    gradient though its parameters require one."""
    params, _ = base
    kind, how = mode.split("-", 1)
    quant, side = how.endswith("int8"), how.startswith("side")
    batch = pair_batch() if kind == "pair" else mixed_batch()
    tree = jax_adapters(params)
    kw = dict(lora_rank=RANK, lora_alpha=ALPHA) if side else {}
    jparams = jquant.quantize_llava_trunk(params) if quant else params
    jm = jmodel(quant_llm="dynamic" if quant else "", **kw)
    step_kw = dict(lora_alpha=ALPHA, grad_cache_chunks=chunks)
    if kind == "pair":
        jstep = jv2v.make_vlm2vec_train_step(jm, jparams, **step_kw)
    else:
        jstep = jv2v.make_vlm2vec_mixed_train_step(
            jm, None if how == "full" else jparams, **step_kw)
    jstate = JTrainState.create(params if how == "full" else tree,
                                optax.sgd(1.0))
    jstate, jmetrics = jax.jit(jstep)(jstate, batch)

    # the base's parameters require grad: the adapter modes must still
    # give it none (JAX's stop_gradient)
    model = port(base, quant=quant, **kw).requires_grad_(True)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if not k.endswith("act_max")}
    if how == "full":
        trainable = model
        tensors = list(model.parameters())
    else:
        trainable = torch_adapters(tree)
        tensors = list(lora.lora_tensors(trainable))
    state = Vlm2VecState(model=model, optimizer=torch.optim.SGD(tensors,
                                                               lr=1.0),
                         schedule=lambda step: 1.0, params=trainable)
    if kind == "pair":
        step = make_vlm2vec_train_step(model, **step_kw)
    else:
        step = make_vlm2vec_mixed_train_step(model, base=how != "full",
                                             **step_kw)
    loss = step(state, {k: _t(v) for k, v in batch.items()})["loss"]
    np.testing.assert_allclose(float(loss), float(jmetrics["loss"]),
                               rtol=1e-5)
    assert state.step == 1
    if how == "full":
        got = flatten_params(jax_params_from_module(model))
        want = flatten_params(jax.device_get(jstate.params))
        assert set(got) <= set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], **GRAD_TOL)
        return
    for k, ab in trainable.items():
        for n in "ab":
            np.testing.assert_allclose(
                ab[n].detach().numpy(), np.asarray(jstate.params[k][n]),
                **GRAD_TOL)
        assert not torch.equal(ab["b"].detach(), torch.tensor(tree[k]["b"]))
    after = model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("quant", [False, True],
                         ids=["materialized", "side-int8"])
def test_remat_gives_the_same_step(base, quant):
    """Recomputing each trunk block in the backward changes no gradient,
    for materialized adapters (their merged weights stay in place through
    the backward and its recompute) and for the side-path over the W8A8
    trunk, with GradCache (fp32; 1e-6)."""
    batch = {k: _t(v) for k, v in mixed_batch().items()}
    tree = jax_adapters(base[0])
    out = []
    for remat in (False, True):
        kw = dict(lora_rank=RANK, lora_alpha=ALPHA) if quant else {}
        model = port(base, quant=quant, remat=remat, **kw)
        params = torch_adapters(tree)
        tensors = list(lora.lora_tensors(params))
        state = Vlm2VecState(model=model,
                             optimizer=torch.optim.SGD(tensors, lr=1.0),
                             schedule=lambda step: 1.0, params=params)
        loss = make_vlm2vec_mixed_train_step(
            model, lora_alpha=ALPHA, grad_cache_chunks=2)(state, batch)
        out.append((float(loss["loss"]),
                    torch.cat([t.detach().flatten() for t in tensors])))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-6, atol=1e-6)
