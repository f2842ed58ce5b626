"""The port's real-data loaders against the JAX package's, on the same
files and seeds: hard negatives (data/hard_negatives.py), the LLaVA datamix
batches (data/datamix.py), the CSV/TSV batches (data/csv_dataset.py) and
the tar-shard stream and batches (data/wds.py). Every batch is bit-equal
(np.array_equal), over the cases of tests/test_data.py,
test_csv_dataset.py and test_wds.py: shard order per epoch, resampled
weights, a corrupt shard, native against PIL decode, and a corrupt member
that drops while the batch refills."""

import io
import json
import random
import tarfile

import numpy as np
import pytest
from PIL import Image

from clip_embeds_tpu.data import csv_dataset as jcsv
from clip_embeds_tpu.data import datamix as jdm
from clip_embeds_tpu.data import hard_negatives as jhn
from clip_embeds_tpu.data import wds as jwds
from clip_embeds_tpu.image.transform import image_transform as j_transform
from clip_embeds_tpu.text.tokenizer import get_tokenizer as j_tokenizer
from clip_embeds_tpu_torch.data import csv_dataset as pcsv
from clip_embeds_tpu_torch.data import datamix as pdm
from clip_embeds_tpu_torch.data import hard_negatives as phn
from clip_embeds_tpu_torch.data import wds as pwds
from clip_embeds_tpu_torch.image.transform import image_transform as p_transform
from clip_embeds_tpu_torch.text.tokenizer import get_tokenizer as p_tokenizer

CAPTIONS = [
    "a mug on the left of the table", "a dog to the right of a cat",
    "the lamp at the left and the cup at the right",
    "a plain caption with no spatial words", "move Left then up",
    "on the right on the right", "",
]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- hard negatives ------------------------------------------------------------


def test_leftright_table_is_the_reference():
    assert phn.LEFTRIGHT_SWAPS == jhn.LEFTRIGHT_SWAPS


@pytest.mark.parametrize("keywords", [
    None, {"left": ["right"], "up": ["down", "under"]},
    {"on the left": ["on the right", "beside"], "small": ["large"]},
], ids=["leftright", "words", "phrases"])
def test_hard_negatives_match_jax(keywords, tmp_path):
    for seed in range(3):
        if keywords is None:
            got, want = phn.leftright_augmenter(seed), \
                jhn.leftright_augmenter(seed)
        else:
            got = phn.HardNegativeAugmenter(keywords, rng=random.Random(seed))
            want = jhn.HardNegativeAugmenter(keywords,
                                             rng=random.Random(seed))
        assert got.phrases == want.phrases
        assert [got(c) for c in CAPTIONS * 3] == [want(c)
                                                  for c in CAPTIONS * 3]


def test_augfiles_merge_over_keywords(tmp_path):
    first, second = tmp_path / "a.json", tmp_path / "b.json"
    first.write_text(json.dumps(phn.LEFTRIGHT_SWAPS))
    second.write_text(json.dumps({"on the left": ["beneath", "above"]}))
    kw = {"a mug": ["a cup"]}
    files = [str(first), str(second)]
    got = phn.HardNegativeAugmenter(kw, files, random.Random(1))
    want = jhn.HardNegativeAugmenter(kw, files, random.Random(1))
    assert got.keywords == want.keywords
    assert got.keywords["on the left"] == ["beneath", "above"]
    assert [got(c) for c in CAPTIONS * 4] == [want(c) for c in CAPTIONS * 4]


# -- datamix -------------------------------------------------------------------


def write_datamix(root, n_images=12, repeats=2, turns=1, seed=0):
    """JPEGs and PNGs of 32-96 px under lcs/ (names from '0') and dm/,
    and a LLaVA-format annotation JSON that names each ``repeats`` times,
    with ``turns`` answer turns a sample (a third carry a left/right
    phrase), plus two entries without an image."""
    rng = np.random.default_rng(seed)
    (root / "lcs" / "00000").mkdir(parents=True, exist_ok=True)
    (root / "dm" / "coco").mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(n_images):
        h, w = (int(x) for x in rng.integers(32, 97, 2))
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        if i % 2 == 0:
            name, path = f"00000/{i:09d}.jpg", root / "lcs" / "00000"
            Image.fromarray(arr).save(path / f"{i:09d}.jpg", quality=90)
        else:
            name, path = f"coco/{i:06d}.png", root / "dm" / "coco"
            Image.fromarray(arr).save(path / f"{i:06d}.png")
        names.append(name)
    ann = []
    for r in range(repeats):
        for i, name in enumerate(names):
            conv = []
            for t in range(turns):
                where = ("on the left", "to the right", "")[(i + r + t) % 3]
                conv += [{"from": "human", "value": "<image>\nDescribe."},
                         {"from": "gpt",
                          "value": f"object {i} turn {t} {where} here"}]
            ann.append({"id": f"{r}-{i}", "image": name,
                        "conversations": conv})
    ann.insert(3, {"id": "text-only", "conversations": [
        {"from": "human", "value": "hi"}, {"from": "gpt", "value": "hello"}]})
    ann.append({"id": "text-only-2", "conversations": []})
    path = root / "ann.json"
    path.write_text(json.dumps(ann))
    return str(path), {"lcs558k": str(root / "lcs"),
                       "datamix665k": str(root / "dm")}


def _datamix(mod, transform, tokenizer, ann, roots, augment, size=32):
    aug = ((phn if mod is pdm else jhn).leftright_augmenter(3) if augment
           else None)
    return mod.DataMixDataset([ann], roots, image_size=size,
                              tokenizer=tokenizer(), augmenter=aug, seed=3,
                              train_transform=transform)


@pytest.mark.parametrize("train,augment,shuffle,epoch,turns", [
    (False, True, False, 0, 1),
    (True, True, True, 0, 1),
    (True, True, True, 1, 1),
    (True, False, True, 2, 1),
    (True, True, True, 0, 3),
], ids=["eval_noshuffle", "train", "train_epoch1", "train_nohard",
        "three_turns"])
def test_datamix_batches_match_jax(tmp_path, train, augment, shuffle, epoch,
                                   turns):
    ann, roots = write_datamix(tmp_path, turns=turns)
    # one worker: the caption turn and the swap draw from one shared
    # random.Random in fetch order (in both packages)
    workers = 1 if turns > 1 else 4
    out = []
    for mod, tf, tok in ((pdm, p_transform, p_tokenizer),
                         (jdm, j_transform, j_tokenizer)):
        transform = tf(32, is_train=True) if train else None
        ds = _datamix(mod, transform, tok, ann, roots, augment)
        assert len(ds) == 24  # the two entries without an image dropped
        out.append(list(mod.datamix_batches(
            ds, 8, max_hard_per_batch=2 if augment else 0, shuffle=shuffle,
            seed=5, num_workers=workers, epoch=epoch)))
    _assert_batches_equal(*out)
    first = out[0][0]
    assert first["images"].shape == (8, 32, 32, 3)
    assert first["hard_texts"].shape == ((2, 77) if augment else (0, 77))
    if augment:
        assert sum(int(b["hard_valid"].sum()) for b in out[0]) > 0


def test_datamix_dispatches_paths_by_their_first_character(tmp_path):
    ann, roots = write_datamix(tmp_path, n_images=4, repeats=1)
    ds = pdm.DataMixDataset([ann], roots, tokenizer=p_tokenizer())
    paths = [ds._image_path(s) for s in ds.samples]
    assert paths[0].startswith(roots["lcs558k"])
    assert paths[1].startswith(roots["datamix665k"])
    jds = jdm.DataMixDataset([ann], roots, tokenizer=j_tokenizer())
    assert paths == [jds._image_path(s) for s in jds.samples]


# -- CSV -----------------------------------------------------------------------


def write_corpus(tmp_path, n=10, sep="\t", img_key="filepath",
                 caption_key="title"):
    rng = np.random.default_rng(0)
    rows = [sep.join([img_key, caption_key])]
    for i in range(n):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (40 + 3 * i, 60, 3),
                                     dtype=np.uint8)).save(p, quality=90)
        rows.append(sep.join([str(p), f"caption number {i}"]))
    path = tmp_path / ("data.tsv" if sep == "\t" else "data.csv")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_csv_dataset_columns_match_jax(tmp_path):
    path = write_corpus(tmp_path, n=7)
    got, want = pcsv.CsvPairDataset(path), jcsv.CsvPairDataset(path)
    assert len(got) == 7 and [got[i] for i in range(7)] == [
        want[i] for i in range(7)]
    with pytest.raises(ValueError):
        pcsv.CsvPairDataset(path, img_key="nope")
    comma = write_corpus(tmp_path, n=4, sep=",", img_key="image",
                         caption_key="text")
    assert len(pcsv.CsvPairDataset(comma, "image", "text", ",")) == 4


@pytest.mark.parametrize("train,shuffle,epoch,drop_last", [
    (False, False, 0, True), (False, True, 1, False), (True, True, 0, True),
    (True, True, 3, True)],
    ids=["eval", "eval_shuffled_keep_last", "train", "train_epoch3"])
def test_csv_batches_match_jax(tmp_path, train, shuffle, epoch, drop_last):
    path = write_corpus(tmp_path, n=10)
    out = []
    for mod, tf, tok in ((pcsv, p_transform, p_tokenizer),
                         (jcsv, j_transform, j_tokenizer)):
        out.append(list(mod.csv_batches(
            mod.CsvPairDataset(path), 4, 32, tok(), epoch=epoch,
            shuffle=shuffle, seed=1, drop_last=drop_last,
            train_transform=tf(32, is_train=True) if train else None,
            num_workers=3)))
    _assert_batches_equal(*out)
    assert len(out[0]) == (2 if drop_last else 3)


# -- WebDataset ----------------------------------------------------------------


def build_shards(tmp_path, counts=(10, 5), fmt="PNG", corrupt=()):
    """Tar shards of (image, txt) pairs; the samples whose global index is
    in ``corrupt`` carry bytes that decode as no image."""
    paths, rng, idx = [], np.random.default_rng(0), 0
    ext = "png" if fmt == "PNG" else "jpg"
    for si, n in enumerate(counts):
        path = tmp_path / f"shard-{si:03d}.tar"
        with tarfile.open(path, "w") as tf:
            for _ in range(n):
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 255, (20 + idx % 7, 24, 3),
                                             dtype=np.uint8)).save(buf, fmt)
                data = b"not an image" if idx in corrupt else buf.getvalue()
                for e, blob in ((ext, data),
                                ("txt", f"caption {idx}".encode())):
                    info = tarfile.TarInfo(f"{idx:06d}.{e}")
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
                idx += 1
        paths.append(str(path))
    return paths


def test_expand_urls_match_jax():
    for urls in ("s-{000..002}.tar", "plain.tar", "a-{0..1}-{08..10}.tar",
                 ["x.tar", "y.tar"]):
        assert pwds.expand_urls(urls) == jwds.expand_urls(urls)
    assert pwds.expand_urls("s-{000..002}.tar") == [
        "s-000.tar", "s-001.tar", "s-002.tar"]


def test_iter_tar_samples_match_jax(tmp_path):
    path = build_shards(tmp_path, (4,))[0]
    got = list(pwds.iter_tar_samples(path))
    assert got == list(jwds.iter_tar_samples(path))
    assert len(got) == 4 and set(got[0]) == {"png", "txt", "__key__"}


@pytest.mark.parametrize("kw", [
    dict(sample_shuffle_size=8), dict(sample_shuffle_size=0,
                                      shuffle_shards=False),
    dict(resampled=True, weights=[1.0, 0.0], seed=3),
    dict(resampled=True, weights=[0.3, 0.7], seed=4, sample_shuffle_size=4),
], ids=["shuffled", "ordered", "resampled_one_shard", "resampled_weighted"])
def test_shard_stream_matches_jax_per_epoch(tmp_path, kw):
    build_shards(tmp_path, (10, 5))
    url = str(tmp_path / "shard-{000..001}.tar")
    orders = []
    for epoch in (0, 1):
        got = [s["text"] for s in pwds.ShardedTarDataset(
            url, decode=pwds.decode_image_text, **kw)(epoch)]
        want = [s["text"] for s in jwds.ShardedTarDataset(
            url, decode=jwds.decode_image_text, **kw)(epoch)]
        assert got == want
        orders.append(got)
    if kw.get("weights") == [1.0, 0.0]:
        assert all(int(t.split()[-1]) < 10 for t in orders[0])
    if "resampled" not in kw and kw.get("sample_shuffle_size"):
        assert sorted(orders[0]) == sorted(orders[1])
        assert orders[0] != orders[1]


def test_corrupt_shard_is_skipped_as_in_jax(tmp_path):
    good = build_shards(tmp_path, (6,))[0]
    bad = tmp_path / "shard-001.tar"
    bad.write_bytes(b"this is not a tar file")
    got = list(pwds.ShardedTarDataset(
        [good, str(bad)], decode=pwds.decode_image_text,
        shuffle_shards=False)(epoch=0, num_workers=1))
    assert len(got) == 6
    want = list(jwds.ShardedTarDataset(
        [good, str(bad)], decode=jwds.decode_image_text,
        shuffle_shards=False)(epoch=0, num_workers=1))
    assert [s["text"] for s in got] == [s["text"] for s in want]


@pytest.mark.parametrize("decode,fmt,corrupt,train,drop_last", [
    ("pil", "PNG", (), False, True),
    ("raw", "PNG", (), False, True),
    ("raw", "JPEG", (2,), False, True),
    ("raw", "JPEG", (2, 9), True, True),
    ("pil", "JPEG", (4,), False, False),
], ids=["pil", "native", "native_corrupt_refill", "train_corrupt",
        "pil_corrupt_keep_last"])
def test_wds_batches_match_jax(tmp_path, decode, fmt, corrupt, train,
                               drop_last):
    build_shards(tmp_path, (10, 7), fmt=fmt, corrupt=corrupt)
    url = str(tmp_path / "shard-{000..001}.tar")
    out = []
    for mod, tf, tok in ((pwds, p_transform, p_tokenizer),
                         (jwds, j_transform, j_tokenizer)):
        fn = (mod.decode_raw_image_text if decode == "raw"
              else mod.decode_image_text)
        ds = mod.ShardedTarDataset(url, decode=fn, sample_shuffle_size=6,
                                   seed=2)
        out.append(list(mod.wds_batches(
            ds, 4, image_size=16, tokenizer=tok(), epoch=1,
            drop_last=drop_last, seed=2,
            train_transform=tf(16, is_train=True) if train else None)))
    _assert_batches_equal(*out)
    n = 17 - len(corrupt)
    assert sum(len(b["texts"]) for b in out[0]) == (
        n // 4 * 4 if drop_last else n)


def test_native_decode_equals_pil_decode(tmp_path):
    build_shards(tmp_path, (10,), fmt="JPEG", corrupt=(2,))
    url = str(tmp_path / "shard-000.tar")
    kw = dict(shuffle_shards=False, sample_shuffle_size=0)
    raw = list(pwds.wds_batches(pwds.ShardedTarDataset(
        url, decode=pwds.decode_raw_image_text, **kw), 3, image_size=16))
    pil = list(pwds.wds_batches(pwds.ShardedTarDataset(
        url, decode=pwds.decode_image_text, **kw), 3, image_size=16))
    # 9 decodable of 10: the corrupt sample drops and later ones refill
    assert len(raw) == len(pil) == 3
    for r, p in zip(raw, pil):
        np.testing.assert_allclose(r["images"], p["images"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(r["texts"], p["texts"])
