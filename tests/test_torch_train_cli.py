"""The slice as a whole: the port's training CLI against the JAX package's,
from one random test-tiny checkpoint, on the CPU in fp32; --lock-image,
--resume latest, and the JAX flags that are not ported yet."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from clip_embeds_tpu.cli.train import main as jax_main
from clip_embeds_tpu_torch.cli import train as port_train
from clip_embeds_tpu_torch.core.config import get_model_config
from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params
from clip_embeds_tpu_torch.models.clip import CLIP


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A test-tiny open_clip state dict, every entry random."""
    model = CLIP(get_model_config("test-tiny"))
    rng = np.random.default_rng(11)
    sd = {}
    for k, v in model.state_dict().items():
        a = np.asarray(0.05 * rng.standard_normal(v.shape), np.float32)
        if v.ndim == 1 and k.rsplit(".", 1)[-1] == "weight" and ".ln" in \
                "." + k:
            a = a + 1.0
        sd[k] = torch.from_numpy(a)
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save(sd, path)
    return str(path), sd


# lr 1e-3 and warmup 1 so that two steps move every parameter measurably
COMMON = ["--model", "test-tiny", "--dataset-type", "synthetic",
          "--precision", "fp32", "--batch-size", "8",
          "--train-num-samples", "16", "--lr", "1e-3", "--warmup", "1",
          "--wd", "0.1", "--log-every", "1"]


def _port(args):
    return port_train.main(args + ["--device", "cpu"])


@pytest.mark.parametrize("extra", [
    [],
    # batch 32: its 8 hard negatives shard over JAX's 8 CPU devices too
    ["--usehardtext", "--batch-size", "32", "--train-num-samples", "64"],
    ["--lr-scheduler", "const", "--grad-clip-norm", "1.0"],
], ids=["infonce", "hardtext", "const_clip"])
def test_two_steps_match_jax_cli(checkpoint, extra):
    path, sd = checkpoint
    args = COMMON + ["--pretrained", path] + extra
    state = _port(args)
    # the suite's conftest gives JAX 8 CPU devices; its CLI shards the
    # batch over them
    jstate = jax_main(args)
    assert state.step == int(jstate.step) == 2
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    moved = 0
    for k, v in state.model.state_dict().items():
        # fp32 both sides; Adam divides each gradient by its own running
        # magnitude, so summation-order noise moves an update by ~1e-6 of
        # the learning rate
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
        moved += not torch.equal(v, sd[k])
    assert moved == len(sd)


def test_lock_image_leaves_the_vision_tower(checkpoint):
    path, sd = checkpoint
    state = _port(COMMON + ["--pretrained", path, "--lock-image"])
    after = state.model.state_dict()
    for k, v in sd.items():
        assert torch.equal(after[k], v) == k.startswith("visual."), k


def test_resume_latest_restores_the_step(checkpoint, tmp_path, caplog):
    path, _ = checkpoint
    d = str(tmp_path / "ckpts")
    first = _port(COMMON + ["--pretrained", path, "--checkpoint-dir", d])
    assert sorted(os.listdir(d)) == ["epoch_1.pt"]
    with caplog.at_level(logging.INFO):
        second = _port(COMMON + ["--pretrained", path, "--checkpoint-dir", d,
                                 "--resume", "latest", "--epochs", "3",
                                 "--delete-previous-checkpoint"])
    assert "resumed at epoch 1" in caplog.text
    # two more epochs of 2 steps from the checkpoint; epoch 2's file gives
    # way to epoch 3's (the JAX CLI prunes only what this run saved)
    assert second.step == 4
    assert sorted(os.listdir(d)) == ["epoch_1.pt", "epoch_3.pt"]
    saved = torch.load(os.path.join(d, "epoch_3.pt"), weights_only=True)
    assert saved["step"] == 3
    for k, v in second.model.state_dict().items():
        assert torch.equal(saved["state_dict"][k], v), k
        assert not torch.equal(first.model.state_dict()[k], v), k


@pytest.mark.parametrize("argv", [
    [flag] for flag in sorted(port_train._UNPORTED)] + [
    ["--dataset-type", t] for t in port_train._UNPORTED_DATASETS],
    ids=lambda a: " ".join(a))
def test_unported_flags_exit_with_their_roadmap_item(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        port_train.parse_args(["--model", "test-tiny"] + argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet: ROADMAP.md queue 1 item" in err and argv[0] in err


def test_fused_blocks_off_the_card_keep_composable(checkpoint, caplog):
    path, _ = checkpoint
    with caplog.at_level(logging.WARNING):
        state = _port(COMMON + ["--pretrained", path, "--fused-train-blocks"])
    assert "keeping composable blocks" in caplog.text
    assert state.model.visual.transformer.block_impl == "composable"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        port_train.main(COMMON)
