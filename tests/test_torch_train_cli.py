"""The slice as a whole: the port's training CLI against the JAX package's,
from one random test-tiny checkpoint, on the CPU in fp32; --lock-image,
--resume latest, the real-data loaders (datamix with hard texts, CSV,
WebDataset, auto) through the train augmentations, the flags they bring,
and the JAX flags that are not ported yet."""

import io
import json
import logging
import os
import tarfile

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_embeds_tpu.cli.train import main as jax_main
from clip_embeds_tpu.cli.train import parse_args as jax_parse_args
from clip_embeds_tpu_torch.cli import train as port_train
from clip_embeds_tpu_torch.core.config import get_model_config
from clip_embeds_tpu_torch.core.convert import state_dict_from_jax_params
from clip_embeds_tpu_torch.data.hard_negatives import LEFTRIGHT_SWAPS
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


@pytest.mark.parametrize("argv", [[flag] for flag in
                                  sorted(port_train._UNPORTED)],
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


# the flags that items 5d and 5e ported, one case each (they exited with
# their item before), with the values each sets
_PORTED = {
    "--force-patch-dropout": ["--force-patch-dropout", "0.5"],
    "--train-data": ["--train-data", "a.json", "b.json"],
    "--csv-img-key": ["--csv-img-key", "img"],
    "--csv-caption-key": ["--csv-caption-key", "cap"],
    "--csv-separator": ["--csv-separator", ","],
    "--dataset-resampled": ["--dataset-resampled"],
    "--train-data-upsampling-factors": [
        "--train-data-upsampling-factors", "1::2.5"],
    "--wds-shuffle-buffer": ["--wds-shuffle-buffer", "100"],
    "--augfiles": ["--augfiles", "x.json", "y.json"],
    "--aug-cfg": ["--aug-cfg", "scale=(0.8, 1.0)", "color_jitter_prob=0.8",
                  "use_timm=True", "name=plain"],
    "--no-train-aug": ["--no-train-aug"],
    "--lcs-root": ["--lcs-root", "/data/lcs"],
    "--datamix-root": ["--datamix-root", "/data/dm"],
    **{f"--dataset-type {t}": ["--dataset-type", t]
       for t in ("datamix", "csv", "webdataset", "auto")},
}
_PORTED_DESTS = ("force_patch_dropout", "train_data", "csv_img_key",
                 "csv_caption_key", "csv_separator", "dataset_resampled",
                 "train_data_upsampling_factors", "wds_shuffle_buffer",
                 "augfiles", "aug_cfg", "no_train_aug", "lcs_root",
                 "datamix_root", "dataset_type")


@pytest.mark.parametrize("name", sorted(_PORTED))
def test_ported_flags_parse_as_in_jax(name):
    argv = ["--model", "test-tiny"] + _PORTED[name]
    got, want = port_train.parse_args(argv), jax_parse_args(argv)
    for dest in _PORTED_DESTS:
        assert getattr(got, dest) == getattr(want, dest), dest
    dest = _PORTED[name][0][2:].replace("-", "_")
    assert getattr(got, dest) != getattr(port_train.parse_args([]), dest)


def _write_images(root, n, prefix, seed=0):
    """n images of 32-96 px, PNG and JPEG, named ``prefix`` + index."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        h, w = (int(x) for x in rng.integers(32, 97, 2))
        path = os.path.join(root, f"{prefix}{i:05d}." + ("jpg" if i % 2
                                                         else "png"))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(path)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def real_data(tmp_path_factory):
    """8 images under an LCS-558K root (names from '0') and 8 under a
    DataMix-665K root; a LLaVA annotation JSON naming each twice (one
    answer turn, a third with a left/right phrase, one entry without an
    image); leftright.json; a TSV over the 16; and two tar shards of 10
    samples, one with an undecodable image."""
    root = tmp_path_factory.mktemp("real")
    lcs = _write_images(str(root / "lcs"), 8, "0")
    dm = _write_images(str(root / "dm" / "coco"), 8, "img", seed=1)
    names = [os.path.basename(p) for p in lcs] + [
        "coco/" + os.path.basename(p) for p in dm]
    ann = [{"id": "text", "conversations": []}]
    for r in range(2):
        for i, name in enumerate(names):
            where = ("on the left", "to the right", "")[(i + r) % 3]
            ann.append({"id": f"{r}-{i}", "image": name, "conversations": [
                {"from": "human", "value": "<image>\nDescribe."},
                {"from": "gpt", "value": f"thing {i} {where} of it {r}"}]})
    (root / "ann.json").write_text(json.dumps(ann))
    (root / "leftright.json").write_text(json.dumps(LEFTRIGHT_SWAPS))
    rows = ["filepath\ttitle"] + [f"{p}\ta photo of thing {i}"
                                   for i, p in enumerate(lcs + dm)]
    (root / "data.tsv").write_text("\n".join(rows) + "\n")
    for s in range(2):
        with tarfile.open(root / f"shard-{s:03d}.tar", "w") as tf:
            for i in range(10):
                with open((lcs + dm)[(s * 10 + i) % 16], "rb") as fh:
                    blob = fh.read()
                if (s, i) == (1, 3):
                    blob = b"undecodable"
                for ext, data in (("jpg", blob),
                                  ("txt", f"caption {s} {i}".encode())):
                    info = tarfile.TarInfo(f"{s}{i:04d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return root


# (flags, steps): the recipe (batch 32: its 8 hard negatives shard over
# JAX's 8 CPU devices), the loaders and the augmentation flags
_DATA_RUNS = {
    "datamix_recipe": (["--dataset-type", "datamix", "--lock-image",
                        "--usehardtext", "--augfiles", "{root}/leftright.json",
                        "--train-data", "{root}/ann.json", "--lcs-root",
                        "{root}/lcs", "--datamix-root", "{root}/dm",
                        "--batch-size", "32"], 1),
    "datamix_no_train_aug": (["--dataset-type", "datamix", "--usehardtext",
                              "--no-train-aug", "--train-data",
                              "{root}/ann.json", "--lcs-root", "{root}/lcs",
                              "--datamix-root", "{root}/dm",
                              "--batch-size", "32"], 1),
    "csv_aug_cfg": (["--dataset-type", "csv", "--train-data",
                     "{root}/data.tsv", "--aug-cfg", "scale=(0.5, 1.0)",
                     "color_jitter=(0.4, 0.4, 0.4, 0.1)",
                     "color_jitter_prob=0.8", "gray_scale_prob=0.5"], 2),
    "webdataset": (["--dataset-type", "webdataset", "--lock-image",
                    "--train-data", "{root}/shard-{{000..001}}.tar",
                    "--train-num-samples", "16", "--wds-shuffle-buffer",
                    "8"], 2),
    "auto_tsv": (["--dataset-type", "auto", "--train-data",
                  "{root}/data.tsv", "--no-train-aug"], 2),
    "auto_tar": (["--dataset-type", "auto", "--train-data",
                  "{root}/shard-000.tar", "{root}/shard-001.tar",
                  "--dataset-resampled", "--train-data-upsampling-factors",
                  "1::3", "--no-train-aug", "--train-num-samples", "16"],
                 None),
}


@pytest.mark.parametrize("name", sorted(_DATA_RUNS))
def test_real_data_runs_match_jax_cli(checkpoint, real_data, name):
    """Both CLIs from one checkpoint on the same files: the same batches
    (bit-equal loaders), so the same parameters after each step; the
    vision tower untouched under --lock-image."""
    path, sd = checkpoint
    flags, steps = _DATA_RUNS[name]
    common = [a for a in COMMON if a not in ("--dataset-type", "synthetic")]
    args = common + [a.format(root=real_data) for a in flags] + [
        "--pretrained", path, "--seed", "3"]
    state = _port(args)
    jstate = jax_main(args)
    assert state.step == int(jstate.step) > 0
    if steps is not None:
        assert state.step == steps
    want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   jstate.params))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
        if "--lock-image" in flags:
            assert torch.equal(v, sd[k]) == k.startswith("visual."), k


def test_fused_gate_reads_the_rows_patch_dropout_leaves(monkeypatch):
    """On the card, --fused-train-blocks is gated on the rows the image
    blocks will see: 1 + kept patches under --force-patch-dropout."""
    from clip_embeds_tpu_torch.ops import fused_block

    seen = []
    monkeypatch.setattr(fused_block, "fused_block_supported",
                        lambda n, *a, **kw: seen.append(n) or True)
    cfg = get_model_config("ViT-L-14-336", "openai")
    for drop, rows in ((None, 577), ("0.5", 289), ("0.25", 433)):
        seen.clear()
        argv = ["--fused-train-blocks", "--fused-train-backward", "residual"]
        if drop is not None:
            argv += ["--force-patch-dropout", drop]
        args = port_train.parse_args(argv)
        impl = port_train._block_impl(args, torch.device("cuda"),
                                      torch.bfloat16, cfg)
        assert impl == "fused-train-res" and seen == [rows, 77]


def test_patch_dropout_runs_through_the_cli(checkpoint, real_data):
    path, sd = checkpoint
    args = COMMON + ["--pretrained", path, "--force-patch-dropout", "0.5"]
    first, second = _port(args), _port(args)
    assert first.step == 2
    for k, v in first.model.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[k]), k
        assert not torch.equal(v, sd[k]), k
