"""The port's train and eval image transforms (image/transform.py) against
the JAX package's, on the same images and generators: every output is
bit-equal (np.array_equal), over the cases of tests/test_transform.py
(RandomResizedCrop geometry and its centre-crop fallback, colour jitter,
grayscale, random erasing, the eval resize modes, the train transform with
aug_cfg, the timm branch and its 'random' interpolation)."""

import numpy as np
import pytest
from PIL import Image

from clip_embeds_tpu.image import transform as jt
from clip_embeds_tpu_torch.image import transform as pt


def _img(h=96, w=128, seed=0):
    arr = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    return Image.fromarray(arr)


# (h, w): landscape, portrait, square, and two strips past 2:1 where the
# ten area draws fail and RandomResizedCrop falls back to a centre crop
SHAPES = ((96, 128), (90, 40), (64, 64), (20, 96), (96, 32))


def test_sample_rng_is_the_same_stream():
    for key in ((0, 0, 0), (3, 1, 7), (2 ** 31 - 1, 5, 123456)):
        a, b = pt.sample_rng(*key), jt.sample_rng(*key)
        np.testing.assert_array_equal(a.random(16), b.random(16))
        np.testing.assert_array_equal(a.integers(0, 1000, 8),
                                      b.integers(0, 1000, 8))


@pytest.mark.parametrize("scale,ratio", [
    ((0.9, 1.0), (3 / 4, 4 / 3)),
    ((0.08, 1.0), (3 / 4, 4 / 3)),
    ((0.5, 1.0), (1.0, 1.0)),
], ids=["default", "imagenet", "square"])
def test_rrc_params_match_jax(scale, ratio):
    for h, w in SHAPES + ((10, 1000), (1000, 10)):
        for seed in range(20):
            got = pt.random_resized_crop_params(
                np.random.default_rng(seed), h, w, scale, ratio)
            want = jt.random_resized_crop_params(
                np.random.default_rng(seed), h, w, scale, ratio)
            assert got == want, (h, w, seed)


def test_rrc_fallback_is_a_centre_crop():
    top, left, h, w = pt.random_resized_crop_params(
        np.random.default_rng(0), 10, 1000, (0.9, 1.0), (3 / 4, 4 / 3))
    assert (top, left, h, w) == (0, (1000 - 13) // 2, 10, 13)


@pytest.mark.parametrize("jitter", [
    (0.0, 0.0, 0.0, 0.0), (0.4, 0.0, 0.0, 0.0), (0.4, 0.4, 0.4, 0.1),
    (0.0, 0.0, 0.0, 0.3)], ids=["none", "brightness", "all", "hue"])
def test_color_jitter_matches_jax(jitter):
    for seed in range(4):
        img = _img(seed=seed)
        got = pt.color_jitter_image(img, np.random.default_rng(seed),
                                    *jitter)
        want = jt.color_jitter_image(img, np.random.default_rng(seed),
                                     *jitter)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_grayscale_and_hue_match_jax():
    img = _img()
    np.testing.assert_array_equal(np.asarray(pt.grayscale3(img)),
                                  np.asarray(jt.grayscale3(img)))
    for shift in (-0.3, 0.0, 0.05, 0.5):
        np.testing.assert_array_equal(np.asarray(pt.adjust_hue(img, shift)),
                                      np.asarray(jt.adjust_hue(img, shift)))


@pytest.mark.parametrize("prob,count", [(1.0, 1), (1.0, 3), (0.5, 2),
                                        (0.0, 1)])
def test_random_erasing_matches_jax(prob, count):
    arr = np.random.default_rng(1).standard_normal((48, 40, 3)).astype(
        np.float32)
    for seed in range(6):
        got = pt.random_erasing(arr, np.random.default_rng(seed), prob, count)
        want = jt.random_erasing(arr, np.random.default_rng(seed), prob,
                                 count)
        np.testing.assert_array_equal(got, want)
    assert pt.random_erasing(arr, np.random.default_rng(0), 0.0) is arr


def test_eval_geometry_matches_jax():
    for h, w in SHAPES:
        img = _img(h, w)
        for size, longest in ((64, 1.0), (64, 0.0), ((48, 64), 1.0),
                              ((48, 64), 0.5)):
            np.testing.assert_array_equal(
                np.asarray(pt.resize_keep_ratio(img, size, longest)),
                np.asarray(jt.resize_keep_ratio(img, size, longest)))
        arr = np.asarray(img)
        for size, fill in ((64, 0), (200, 7), ((30, 150), 3)):
            np.testing.assert_array_equal(
                pt.center_crop_or_pad(arr, size, fill),
                jt.center_crop_or_pad(arr, size, fill))


# (image_transform keyword arguments, is_train); the train cases take a
# sample_rng per image
TRANSFORMS = {
    "eval_shortest": (dict(image_size=64), False),
    "eval_shortest_rect": (dict(image_size=(48, 64)), False),
    "eval_longest": (dict(image_size=64, resize_mode="longest",
                          fill_color=0), False),
    "eval_longest_rect": (dict(image_size=(40, 64), resize_mode="longest",
                               fill_color=5), False),
    "eval_squash_siglip": (dict(image_size=64, resize_mode="squash",
                                mean=(0.5,) * 3, std=(0.5,) * 3), False),
    "eval_random_is_bicubic": (dict(image_size=48, interpolation="random"),
                               False),
    "train_default": (dict(image_size=64), True),
    "train_bilinear": (dict(image_size=40, interpolation="bilinear"), True),
    "train_aug_cfg": (dict(image_size=48, aug_cfg={
        "scale": [0.8, 1.0], "color_jitter": (0.4, 0.4, 0.4, 0.1),
        "color_jitter_prob": 0.8, "gray_scale_prob": 0.5}), True),
    "train_ratio": (dict(image_size=48, aug_cfg=jt.AugmentationCfg(
        scale=(0.3, 1.0), ratio=(0.5, 2.0))), True),
    "train_timm": (dict(image_size=48, aug_cfg={
        "use_timm": True, "scale": (0.8, 1.0), "color_jitter": 0.4,
        "re_prob": 1.0, "re_count": 2}), True),
    "train_timm_random_interp": (dict(
        image_size=48, interpolation="random",
        aug_cfg={"use_timm": True, "scale": (0.99, 1.0)}), True),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_image_transform_matches_jax(name):
    kw, is_train = TRANSFORMS[name]
    port_kw = dict(kw)
    if isinstance(kw.get("aug_cfg"), jt.AugmentationCfg):
        port_kw["aug_cfg"] = pt.AugmentationCfg(
            **vars(kw["aug_cfg"]))
    got_fn = pt.image_transform(is_train=is_train, **port_kw)
    want_fn = jt.image_transform(is_train=is_train, **kw)
    for i, (h, w) in enumerate(SHAPES):
        img = _img(h, w, seed=i)
        for idx in range(3 if is_train else 1):
            if is_train:
                got = got_fn(img, pt.sample_rng(4, 1, idx))
                want = want_fn(img, jt.sample_rng(4, 1, idx))
            else:
                got, want = got_fn(img), want_fn(img)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_image_transform_v2_matches_jax():
    for size, mode in ((64, "squash"), (56, "longest"), (48, "shortest")):
        got = pt.image_transform_v2(
            pt.PreprocessCfg(size=size, resize_mode=mode), False)(_img())
        want = jt.image_transform_v2(
            jt.PreprocessCfg(size=size, resize_mode=mode), False)(_img())
        np.testing.assert_array_equal(got, want)
    cfg = {"scale": (0.5, 1.0), "gray_scale_prob": 1.0}
    got = pt.image_transform_v2(pt.PreprocessCfg(size=32), True, cfg)(
        _img(), pt.sample_rng(0, 0, 9))
    want = jt.image_transform_v2(jt.PreprocessCfg(size=32), True, cfg)(
        _img(), jt.sample_rng(0, 0, 9))
    np.testing.assert_array_equal(got, want)


def test_train_transform_reads_paths_as_jax(tmp_path):
    path = str(tmp_path / "a.png")
    _img(70, 150).save(path)
    got = pt.image_transform(40, is_train=True)(path, pt.sample_rng(1, 2, 3))
    want = jt.image_transform(40, is_train=True)(path, jt.sample_rng(1, 2, 3))
    np.testing.assert_array_equal(got, want)


def test_color_jitter_prob_needs_a_4_tuple():
    bad = {"color_jitter": 0.4, "color_jitter_prob": 0.8}
    with pytest.raises(AssertionError):
        jt.image_transform(64, is_train=True, aug_cfg=bad)
    with pytest.raises(AssertionError):
        pt.image_transform(64, is_train=True, aug_cfg=bad)
