"""One train step of the port at 2 gloo ranks against JAX's step on the
global batch (fp32, CPU): the gradient of every parameter, read as the
difference before less after one step of SGD at lr 1, for DDP on
composable blocks, FSDP on fused-train-res (their plain versions on the
CPU), grad-cache in 2 chunks, the hard-text loss and patch dropout fed
JAX's indices; and 2 AdamW steps under FSDP against JAX's parameters, so
that the optimiser's sharded state is covered.

The ranks run in spawned processes (tests/torch_dist_fixtures.py), all
cases in one spawn. Tolerances: losses rel 1e-5, gradients rtol 1e-4 /
atol 1e-6, those of tests/test_torch_train.py and
tests/test_torch_patch_dropout.py; parameters after the AdamW steps atol
1e-4, a tenth of the learning rate: Adam divides each gradient by its own
running magnitude, so where a gradient is near 0 the ranks' reduction order
(not JAX's) moves an update by a share of lr (2.9e-5 read once here), while
a moment left on the wrong shard moves it by about lr."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_fixtures as dfx
from clip_embeds_tpu.core.config import get_model_config as jax_config
from clip_embeds_tpu.core.torch_convert import convert_clip_state_dict
from clip_embeds_tpu.models.clip import CLIP as JaxCLIP
from clip_embeds_tpu.train import optim as jax_optim
from clip_embeds_tpu.train import steps as jax_steps
from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params
from clip_embeds_tpu_torch.data.synthetic import synthetic_batches

WORLD = 2
CASES = sorted(dfx.TRAIN_MODES) + ["fsdp_adamw_2_steps"]


def _jax_cfg(drop):
    cfg = jax_config("test-tiny")
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_size=dfx.SIZE, patch_size=dfx.PATCH,
        patch_dropout=drop))


def _jax_run(case, seen):
    """JAX's step on the global batch: (losses, params after, the patch
    indices it drew)."""
    _, _, chunks, hard, drop = dfx.TRAIN_MODES[case["mode"]]
    params = jax.tree.map(jnp.asarray, convert_clip_state_dict(case["sd"]))
    tx = jax_optim.adamw(1e-3, weight_decay=0.1) if case.get("adamw") \
        else optax.sgd(1.0)
    state = jax_steps.TrainState.create(params, tx)
    step = jax_steps.make_clip_train_step(
        JaxCLIP(_jax_cfg(drop)), use_hard_text=hard,
        grad_cache_chunks=chunks, seed=9)
    if not drop:  # the patch indices are recorded outside a trace
        step = jax.jit(step)
    losses = []
    del seen[:]
    for _ in range(case.get("steps", 1)):
        state, m = step(state, jax.tree.map(jnp.asarray, case["batch"]))
        losses.append(float(m["loss"]))
    keep = np.array(seen[0]) if seen else None
    return losses, state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params)), keep


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case, the ranks in one spawn."""
    seen, real = [], jax.lax.top_k

    def recording(x, k):
        out = real(x, k)
        seen.append(np.array(out[1]))
        return out

    cases, want = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", recording)
        for i, label in enumerate(CASES):
            mode = "fsdp_fused_train_res" if label == "fsdp_adamw_2_steps" \
                else label
            _, _, _, hard, drop = dfx.TRAIN_MODES[mode]
            case = {"mode": mode,
                    "sd": dfx.random_state_dict(dfx.tiny_config(drop),
                                                seed=10 + i),
                    "batch": next(synthetic_batches(
                        dfx.TRAIN_B, dfx.SIZE, 77, seed=3,
                        hard_negatives=dfx.TRAIN_B // 4 if hard else 0))}
            if label == "fsdp_adamw_2_steps":
                case.update(steps=2, adamw=True)
            losses, after, keep = _jax_run(case, seen)
            if drop:
                assert keep.shape == (dfx.TRAIN_B, 32)
                case["keep"] = keep
            cases[label] = case
            want[label] = (losses, after)
    got = dfx.run_ranks(dfx.train_rank, WORLD,
                        tmp_path_factory.mktemp("ranks"), cases)
    return cases, want, got


@pytest.mark.parametrize("label", CASES)
def test_step_at_two_ranks_matches_jax_global_batch(runs, label):
    cases, want, got = runs
    jlosses, jafter = want[label]
    for r in range(WORLD):
        # every rank reports the global batch's loss
        assert got[r][label]["losses"] == pytest.approx(jlosses, rel=1e-5)
    if cases[label]["mode"] == "fsdp_fused_train_res":
        assert got[0][label]["sharded"] > 0
    before, after = got[0][label]["before"], got[0][label]["after"]
    assert sorted(after) == sorted(jafter)
    for k, v in after.items():
        if cases[label].get("adamw"):
            np.testing.assert_allclose(v.numpy(), jafter[k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            torch.testing.assert_close(before[k] - v, before[k] - jafter[k],
                                       rtol=1e-4, atol=1e-6, msg=k)
