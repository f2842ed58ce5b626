"""``cli/train.py`` on the zoo towers, the port's CLI against the JAX
package's on the CPU in fp32: two synthetic steps of tiny EVA01, ResNet,
ConvNeXt and FastViT CLIPs from one open_clip checkpoint (the names
registered in both packages for the test), the losses within 1e-5 (ResNet's
second one apart by JAX's moved statistics, a reference fault). Where the
JAX CLI goes wrong on a zoo tower: ``test_torch_zoo_train_cli_exits.py``;
the two files share their helpers through ``torch_zoo_fixtures``."""

import numpy as np
import pytest

from clip_embeds_tpu.cli.train import main as jax_main
from clip_embeds_tpu_torch.cli import train as port_train
from torch_zoo_fixtures import (  # noqa: F401 - fixture
    CLI_COMMON,
    cli_checkpoints,
    one_torch_thread,
    register_tiny,
    run_logged,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kind", ["eva", "resnet", "convnext-linear",
                                  "fastvit"])
def test_two_zoo_steps_match_jax_cli(monkeypatch, tmp_path, caplog, kind):
    name, cfg = register_tiny(monkeypatch, kind)
    ours, theirs, _ = cli_checkpoints(tmp_path, kind, cfg)
    state, got = run_logged(caplog, port_train.main, CLI_COMMON + [
        "--model", name, "--pretrained", ours, "--device", "cpu"])
    # the suite's conftest gives JAX 8 CPU devices; its CLI shards the
    # batch over them
    jstate, want = run_logged(caplog, jax_main, CLI_COMMON + [
        "--model", name, "--pretrained", theirs])
    assert state.step == int(jstate.step) == 2
    assert len(got) == len(want) == 2
    if kind != "resnet":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    # JAX's AdamW also moves the ResNet statistics in step 1 (a reference
    # fault, test_torch_zoo_train_labels.py), which the port keeps frozen:
    # the first loss agrees, the second one reads the moved statistics
    assert got[0] == pytest.approx(want[0], abs=1e-5)
    assert 1e-5 < abs(got[1] - want[1]) < 1e-4
