"""The eval CLI's CLIP table on the MMVP-VLM fixture (270 images), the
port against JAX's CLI (``torch_eval_fixtures.check_clip_table``): a case
of ``test_torch_eval_cli.py``'s ``test_eval_cli_tables_match_jax`` in a
file of its own, so that ``--dist loadfile`` runs it on a worker beside
the rest."""

import pytest

from torch_eval_fixtures import (  # noqa: F401 - fixtures
    check_clip_table,
    checkpoint,
)


@pytest.mark.parametrize("dataset", ["mmvpvlm"])
def test_eval_cli_tables_match_jax(tmp_path, checkpoint, dataset, capsys,
                                   monkeypatch):
    check_clip_table(tmp_path, checkpoint, dataset, capsys, monkeypatch)
