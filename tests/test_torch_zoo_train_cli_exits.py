"""``cli/train.py`` on the zoo towers where the JAX CLI goes wrong, its
behaviour beside the port's exit, on the CPU in fp32: an hf-text name (the
same NotImplementedError in both), ``--force-patch-dropout`` (JAX drops no
patch), ``--lock-image-unlocked-groups`` (JAX freezes the whole tower) and
Swin (JAX cannot trace it under ``jax.jit``; the port trains it). The
steps against JAX's CLI are ``test_torch_zoo_train_cli.py``."""

import jax
import numpy as np
import pytest

from clip_embeds_tpu.cli.train import main as jax_main
from clip_embeds_tpu_torch.cli import train as port_train
from torch_zoo_fixtures import (  # noqa: F401 - fixture
    CLI_COMMON,
    cli_checkpoints,
    flat,
    jax_params,
    one_torch_thread,
    register_tiny,
    run_logged,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_hf_text_names_raise_as_in_jax():
    argv = CLI_COMMON + ["--model", "xlm-roberta-large-ViT-H-14"]
    with pytest.raises(NotImplementedError) as ours:
        port_train.main(argv + ["--device", "cpu"])
    with pytest.raises(NotImplementedError) as theirs:
        jax_main(argv)
    assert str(ours.value) == str(theirs.value)
    assert "needs backend 'hf-text'" in str(ours.value)


def test_patch_dropout_on_a_zoo_tower_exits(monkeypatch, tmp_path, caplog):
    """JAX's CLI takes --force-patch-dropout on EVA01 and drops nothing:
    its losses are the port's without the flag; the port exits on it."""
    name, cfg = register_tiny(monkeypatch, "eva")
    ours, theirs, _ = cli_checkpoints(tmp_path, "eva", cfg)
    argv = CLI_COMMON + ["--model", name]
    with pytest.raises(SystemExit, match="--force-patch-dropout on the "
                       "'eva' vision tower: the JAX CLI drops no patch"):
        port_train.main(argv + ["--pretrained", ours, "--device", "cpu",
                                "--force-patch-dropout", "0.5"])
    _, got = run_logged(caplog, port_train.main,
                        argv + ["--pretrained", ours, "--device", "cpu"])
    _, want = run_logged(caplog, jax_main, argv + [
        "--pretrained", theirs, "--force-patch-dropout", "0.5"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_unlocked_groups_on_a_zoo_tower_exit(monkeypatch, tmp_path,
                                             caplog):
    """JAX's labels know only the ViT's groups: with --lock-image
    --lock-image-unlocked-groups 2 its CLI leaves every leaf of the EVA01
    tower, the head included, where it was; the port exits on the flag."""
    name, cfg = register_tiny(monkeypatch, "eva")
    ours, theirs, sd = cli_checkpoints(tmp_path, "eva", cfg)
    lock = ["--lock-image", "--lock-image-unlocked-groups", "2"]
    with pytest.raises(SystemExit, match="--lock-image-unlocked-groups on "
                       "the 'eva' vision tower: the JAX CLI freezes the "
                       "whole tower"):
        port_train.main(CLI_COMMON + ["--model", name, "--pretrained",
                                      ours, "--device", "cpu"] + lock)
    jstate, _ = run_logged(caplog, jax_main, CLI_COMMON + [
        "--model", name, "--pretrained", theirs] + lock)
    before = flat(jax_params("eva", cfg, sd)["visual"])
    after = flat(jax.tree.map(np.asarray, jstate.params["visual"]))
    assert sorted(after) == sorted(before)
    assert "head/kernel" in after
    for path, value in after.items():
        np.testing.assert_array_equal(value, before[path], err_msg=path)


def test_swin_trains_where_the_jax_cli_cannot(monkeypatch, tmp_path,
                                              caplog):
    """JAX's Swin builds its shift mask with np.asarray on a jnp array
    (``models/swin.py:86``), which fails under the CLI's ``jax.jit``; the
    port's CLI takes two finite steps."""
    name, cfg = register_tiny(monkeypatch, "swin")
    ours, theirs, _ = cli_checkpoints(tmp_path, "swin", cfg)
    state, got = run_logged(caplog, port_train.main, CLI_COMMON + [
        "--model", name, "--pretrained", ours, "--device", "cpu"])
    assert state.step == 2 and len(got) == 2 and np.isfinite(got).all()
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax_main(CLI_COMMON + ["--model", name, "--pretrained", theirs])
