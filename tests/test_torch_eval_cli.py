"""The port's eval CLI against the JAX package's (CPU, fp32, the
test-tiny checkpoint made from JAX params and the PACL/SPARC heads saved by
the JAX package): identical CLIP tables and results-file text from both
CLIs on fixtures built as in tests/test_evals.py, the unported scorers'
exits and the card-by-default device. The PACL/SPARC heads' tables are in
tests/test_torch_eval_scorers.py; the MMVP-VLM tables have files of their
own (tests/test_torch_eval_cli_mmvpvlm.py, tests/test_torch_eval_heads_
mmvpvlm_*.py), which ``--dist loadfile`` runs on other workers."""

import pytest
import torch

from clip_embeds_tpu.cli.eval import main as jax_main
from clip_embeds_tpu_torch.cli.eval import build_scorer, main, parse_args
from clip_embeds_tpu_torch.scores.scorers import PACLScorer, SPARCScorer
from torch_eval_fixtures import (  # noqa: F401 - fixtures
    _FIXTURES,
    _make_coco,
    check_clip_table,
    checkpoint,
)


# -- the CLI -----------------------------------------------------------------


# the MMVP-VLM case is tests/test_torch_eval_cli_mmvpvlm.py
@pytest.mark.parametrize("dataset", [d for d in _FIXTURES
                                     if d != "mmvpvlm"])
def test_eval_cli_tables_match_jax(tmp_path, checkpoint, dataset, capsys,
                                   monkeypatch):
    check_clip_table(tmp_path, checkpoint, dataset, capsys, monkeypatch)


@pytest.mark.parametrize("argv,item", [
    (["--scorer", "siglip", "--model", "ViT-SO400M-14-SigLIP-384"], "10"),
    (["--scorer", "pacl"], "9"),
    (["--scorer", "sparc"], "9"), (["--scorer", "embedding"], "12"),
    (["--rope", "after"], "9"), (["--sparc-local"], "9")])
def test_unported_scorers_name_their_roadmap_item(tmp_path, capsys, argv,
                                                  item, checkpoint):
    """The scorers of ported ROADMAP.md items: those of item 9 (PACL/SPARC)
    and their flags parse and build their scorers; item 10's (SigLIP) exits
    as the JAX CLI does, for want of a sentencepiece vocabulary path
    (tests/test_torch_siglip.py holds both packages to it); item 12's
    (VLM2Vec) ``--scorer embedding`` raises the JAX CLI's
    NotImplementedError, the same message from both packages."""
    common = ["--root-dir", str(tmp_path)]
    if item == "10":
        with pytest.raises(SystemExit, match="SigLIP tokenizer needs "
                           "sentencepiece"):
            main(argv + common)
        return
    if item == "12":
        tiny = common + ["--model", "test-tiny", "--results-file",
                         str(tmp_path / "results.txt")]
        with pytest.raises(NotImplementedError) as want:
            jax_main(argv + tiny)
        with pytest.raises(NotImplementedError) as got:
            main(argv + tiny + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
        assert "construct scores.embedding_scorer.EmbeddingScorer" in str(
            got.value)
        return
    if "--scorer" not in argv:  # the head flags, with their scorer
        argv = argv + ["--scorer", "pacl" if "--rope" in argv else "sparc"]
    args = parse_args(argv + common + [
        "--model", "test-tiny", "--pretrained", checkpoint, "--device",
        "cpu", "--precision", "fp32"])
    scorer = build_scorer(args)
    assert isinstance(scorer, PACLScorer if args.scorer == "pacl"
                      else SPARCScorer)
    if args.scorer == "pacl":
        assert scorer.head.rope == args.rope and not scorer.head.training
    else:
        assert scorer.local == ("--sparc-local" in argv)


def test_eval_runs_on_the_card_unless_asked(tmp_path, checkpoint,
                                            monkeypatch):
    """--device defaults to cuda; without a card the command exits with an
    error instead of running on the CPU unasked."""
    assert parse_args(["--root-dir", "x"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _make_coco(tmp_path)
    args = ["--model", "test-tiny", "--pretrained", checkpoint, "--dataset",
            "cocoone", "--root-dir", str(tmp_path), "--results-file",
            str(tmp_path / "r.txt")]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(args)
    assert not (tmp_path / "r.txt").exists()
    assert main(args + ["--device", "cpu", "--precision", "fp32"])[
        "individual_accuracy"] in (0.0, 25.0, 50.0, 75.0, 100.0)
