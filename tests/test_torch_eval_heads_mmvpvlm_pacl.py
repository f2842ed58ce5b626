"""The eval CLI's pacl-rope-after head table on the MMVP-VLM fixture (270
images), the port against JAX's CLI (``torch_eval_fixtures.
check_head_table``): a case of ``test_torch_eval_scorers.py``'s
``test_eval_cli_head_tables_match_jax`` in a file of its own, so that
``--dist loadfile`` runs it on a worker beside the rest."""

import pytest

from torch_eval_fixtures import (  # noqa: F401 - fixtures
    check_head_table,
    checkpoint,
    head_npz,
)


@pytest.mark.parametrize("dataset", ["mmvpvlm"])
@pytest.mark.parametrize("variant", ["pacl-rope-after"])
def test_eval_cli_head_tables_match_jax(tmp_path, checkpoint, head_npz,
                                        variant, dataset, capsys,
                                        monkeypatch):
    check_head_table(tmp_path, checkpoint, head_npz, variant, dataset,
                     capsys, monkeypatch)
