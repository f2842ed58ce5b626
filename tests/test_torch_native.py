"""The port's native image pipeline (its copies of resize.cpp / decode.cpp,
built by clip_embeds_tpu_torch/native/build.py) and its host preprocessing
against Pillow and the JAX package: the counterparts of tests/test_native.py
on the port's copy, the sources held byte-equal, preprocess_batch of paths
bit-equal to the JAX package's, concurrent builds, a failed build that says
so once and decodes with PIL, and the threaded PIL fallback."""

import ctypes
import filecmp
import io
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
from PIL import Image

from clip_embeds_tpu.image import loader as jax_loader
from clip_embeds_tpu.image import preprocess as jax_preprocess
from clip_embeds_tpu_torch.core.constants import (
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)
from clip_embeds_tpu_torch.image import loader
from clip_embeds_tpu_torch.image.loader import (
    PrefetchLoader,
    decode_preprocess_batch,
    native_decode_preprocess,
)
from clip_embeds_tpu_torch.image.preprocess import (
    native_preprocess_clip,
    native_resize_normalize,
    native_resize_normalize_batch,
    preprocess_batch,
    preprocess_clip,
    preprocess_pacl,
)
from clip_embeds_tpu_torch.native import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    lib = build.load_library()
    if lib is None:
        pytest.skip("native library unavailable (no g++ or image headers)")
    return lib


def _encode(arr: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _pil_ref(blob: bytes, size: int = 96) -> np.ndarray:
    return preprocess_clip(Image.open(io.BytesIO(blob)).convert("RGB"), size)


# -- the counterparts of tests/test_native.py ------------------------------


def test_bicubic_matches_pillow(lib):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (123, 200, 3), dtype=np.uint8)
    pil = Image.fromarray(img).resize((64, 64), Image.BICUBIC)
    pil_arr = np.asarray(pil).astype(np.float32) / 255.0
    ours = native_resize_normalize(img, 64, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                   bicubic=True)
    # Pillow quantizes the intermediate to uint8; allow 1/255 + rounding slack
    assert np.abs(ours - pil_arr).max() < 2.5 / 255


def test_bilinear_matches_pacl_path(lib):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (97, 150, 3), dtype=np.uint8)
    ref = preprocess_pacl(img, 48)  # PIL BILINEAR + ImageNet stats
    ours = native_resize_normalize(
        img, 48, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), bicubic=False
    )
    assert np.abs(ours - ref).max() < 0.03  # ~2.5/255 in normalized units


def test_batch_matches_single(lib):
    rng = np.random.default_rng(2)
    batch = rng.integers(0, 255, (6, 80, 60, 3), dtype=np.uint8)
    mean, std = (0.5, 0.5, 0.5), (0.3, 0.3, 0.3)
    whole = native_resize_normalize_batch(batch, 32, mean, std, num_threads=4)
    for i in range(6):
        one = native_resize_normalize(batch[i], 32, mean, std)
        np.testing.assert_allclose(whole[i], one, rtol=1e-5, atol=1e-6)


def test_upscale(lib):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    pil = np.asarray(
        Image.fromarray(img).resize((48, 48), Image.BICUBIC)
    ).astype(np.float32) / 255.0
    ours = native_resize_normalize(img, 48, (0, 0, 0), (1, 1, 1))
    assert np.abs(ours - pil).max() < 2.5 / 255


def test_native_preprocess_clip_parity(lib):
    rng = np.random.default_rng(5)
    for shape in [(123, 200, 3), (400, 250, 3), (112, 112, 3)]:
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        a = native_preprocess_clip(img, 112)
        b = preprocess_clip(img, 112)
        assert a.shape == b.shape == (112, 112, 3)
        # within one uint8 step in normalized units (Pillow fixed-point coeffs)
        assert np.abs(a - b).max() < 1.5 / 255 / 0.2686


def test_decode_batch_bit_exact_vs_pil(lib):
    rng = np.random.default_rng(3)
    shapes_fmts = [
        ((120, 200), "JPEG"), ((211, 97), "PNG"), ((96, 96), "WEBP"),
        ((97, 96), "PNG"), ((300, 110), "JPEG"), ((50, 400), "JPEG"),
    ]
    blobs = [
        _encode(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), fmt, quality=90)
        if fmt != "PNG" else
        _encode(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), fmt)
        for hw, fmt in shapes_fmts
    ]
    out, ok = decode_preprocess_batch(blobs, 96)
    assert ok.all()
    for i, blob in enumerate(blobs):
        # identical uint8 pixels -> identical float32 after the same normalize
        np.testing.assert_allclose(out[i], _pil_ref(blob), rtol=0, atol=1e-5)


def _gray_jpeg_and_alpha_png(rng):
    gray = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (80, 100), dtype=np.uint8),
                    mode="L").save(gray, format="JPEG")
    rgba = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (60, 70, 4), dtype=np.uint8),
                    mode="RGBA").save(rgba, format="PNG")
    return [gray.getvalue(), rgba.getvalue()]


def test_decode_native_claims_only_what_it_handles(lib):
    blobs = _gray_jpeg_and_alpha_png(np.random.default_rng(4))
    res = native_decode_preprocess(blobs, 96)
    assert res is not None
    _, native_ok = res
    assert native_ok[0]          # grayscale JPEG: native handles (libjpeg RGB)
    assert not native_ok[1]      # alpha PNG: defers to PIL's convert("RGB")
    out, ok = decode_preprocess_batch(blobs, 96)  # fallback fills slot 1
    assert ok.all()
    for i, blob in enumerate(blobs):
        np.testing.assert_allclose(out[i], _pil_ref(blob), rtol=0, atol=1e-5)


def test_decode_corrupt_slot_is_flagged_and_zeroed(lib):
    rng = np.random.default_rng(5)
    good = _encode(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), "PNG")
    out, ok = decode_preprocess_batch([b"not an image", good, b""], 96)
    assert list(ok) == [False, True, False]
    assert np.all(out[0] == 0.0) and np.all(out[2] == 0.0)


def _smooth_jpeg(h=700, w=900, quality=92) -> bytes:
    """Low-frequency (natural-image-like) content."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [128 + 80 * np.sin(x * 0.01 * (c + 1)) + 40 * np.cos(y * 0.008 * (c + 1))
         for c in range(3)], axis=-1)
    return _encode(np.clip(img, 0, 255).astype(np.uint8), "JPEG",
                   quality=quality)


def test_decode_fast_jpeg_close_on_natural_images(lib):
    # DCT-domain downscaled decode deviates from the full decode but must
    # stay close on low-frequency content
    blob = _smooth_jpeg()
    exact, _ = decode_preprocess_batch([blob], 96)
    fast, ok = decode_preprocess_batch([blob], 96, fast_jpeg=True)
    assert ok.all()
    a, b = exact.ravel(), fast.ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.995


def test_prefetch_loader_matches_batch_call(lib, tmp_path):
    rng = np.random.default_rng(7)
    paths, blobs = [], []
    for i in range(5):
        blob = _encode(
            rng.integers(0, 256, (100 + 7 * i, 130, 3), dtype=np.uint8),
            "JPEG", quality=90)
        p = tmp_path / f"img{i}.jpg"
        p.write_bytes(blob)
        paths.append(str(p))
        blobs.append(blob)
    ref, _ = decode_preprocess_batch(blobs, 64)

    got_paths, got = [], []
    for chunk, batch, ok in PrefetchLoader(paths, batch_size=2, image_size=64):
        assert ok.all()
        got_paths.extend(chunk)
        got.append(batch)
    assert got_paths == paths
    np.testing.assert_allclose(np.concatenate(got), ref, rtol=0, atol=0)


def test_probe_image_dimensions(lib):
    rng = np.random.default_rng(8)
    h, w = ctypes.c_int(), ctypes.c_int()
    for fmt in ("JPEG", "PNG", "WEBP"):
        blob = _encode(rng.integers(0, 256, (123, 77, 3), dtype=np.uint8), fmt)
        assert lib.probe_image(ctypes.c_char_p(blob), len(blob),
                               ctypes.byref(h), ctypes.byref(w)) == 1
        assert (h.value, w.value) == (123, 77)
    assert lib.probe_image(ctypes.c_char_p(b"junk"), 4,
                           ctypes.byref(h), ctypes.byref(w)) == 0


def test_decompression_bomb_defers_to_fallback(lib):
    # the native path must refuse headers above PIL's MAX_IMAGE_PIXELS
    # rather than attempt the allocation
    buf = io.BytesIO()
    Image.new("RGB", (12000, 9000)).save(buf, format="JPEG", quality=10)
    res = native_decode_preprocess([buf.getvalue()], 64)
    assert res is not None
    assert not res[1][0]


def test_prefetch_loader_abandoned_iteration_terminates(lib, tmp_path):
    rng = np.random.default_rng(9)
    paths = []
    for i in range(12):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(
            rng.integers(0, 256, (60, 60, 3), dtype=np.uint8)
        ).save(p, format="JPEG")
        paths.append(str(p))
    before = threading.active_count()
    it = iter(PrefetchLoader(paths, batch_size=2, image_size=32, prefetch=1))
    next(it)
    it.close()  # abandon mid-iteration; the producer must not deadlock
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


# -- the port against the JAX package ----------------------------------------


@pytest.mark.parametrize("name", ["resize.cpp", "decode.cpp"])
def test_sources_equal_the_jax_packages(name):
    assert filecmp.cmp(os.path.join(ROOT, "clip_embeds_tpu_torch", "native",
                                    name),
                       os.path.join(ROOT, "clip_embeds_tpu", "native", name),
                       shallow=False)


def _write_fixture(tmp_path):
    """Baseline and progressive JPEG, PNG, WebP, grayscale JPEG, alpha PNG
    and a corrupt file."""
    rng = np.random.default_rng(11)
    blobs = [
        _encode(rng.integers(0, 256, (120, 200, 3), dtype=np.uint8), "JPEG",
                quality=90),
        _encode(rng.integers(0, 256, (211, 97, 3), dtype=np.uint8), "PNG"),
        _encode(rng.integers(0, 256, (96, 96, 3), dtype=np.uint8), "WEBP"),
        _encode(rng.integers(0, 256, (90, 140, 3), dtype=np.uint8), "JPEG",
                quality=80, progressive=True),
        *_gray_jpeg_and_alpha_png(rng),
    ]
    paths = []
    for i, blob in enumerate(blobs):
        p = tmp_path / f"img{i}.bin"
        p.write_bytes(blob)
        paths.append(str(p))
    return paths, blobs


@pytest.mark.parametrize("variant", ["clip", "pacl", "siglip", "llava"])
def test_preprocess_batch_of_paths_equals_jax(lib, tmp_path, variant):
    paths, _ = _write_fixture(tmp_path)
    got = preprocess_batch(paths, 64, variant)
    want = jax_preprocess.preprocess_batch(paths, 64, variant)
    assert got.shape == want.shape == (len(paths), 64, 64, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["path", "pil", "array"])
@pytest.mark.parametrize("fn", ["preprocess_clip", "preprocess_pacl",
                                "preprocess_siglip", "preprocess_llava"])
def test_pil_preprocess_equals_jax(tmp_path, kind, fn):
    from clip_embeds_tpu_torch.image import preprocess

    arr = np.random.default_rng(12).integers(0, 256, (70, 45, 3),
                                             dtype=np.uint8)
    path = tmp_path / "x.png"
    Image.fromarray(arr).save(path)
    image = {"path": str(path), "pil": Image.fromarray(arr),
             "array": arr}[kind]
    np.testing.assert_array_equal(getattr(preprocess, fn)(image, 48),
                                  getattr(jax_preprocess, fn)(image, 48))


@pytest.mark.parametrize("fast_jpeg", [False, True])
def test_decode_batch_equals_jax(lib, tmp_path, fast_jpeg):
    _, blobs = _write_fixture(tmp_path)
    blobs = blobs + [_smooth_jpeg(300, 420), b"not an image"]
    got, ok = decode_preprocess_batch(blobs, 64, fast_jpeg=fast_jpeg)
    want, want_ok = jax_loader.decode_preprocess_batch(blobs, 64,
                                                       fast_jpeg=fast_jpeg)
    np.testing.assert_array_equal(ok, want_ok)
    assert list(ok) == [True] * (len(blobs) - 1) + [False]
    np.testing.assert_array_equal(got, want)


def test_pil_fallback_threads_give_the_serial_pixels(tmp_path, monkeypatch):
    """Without the library every slot decodes with PIL, on num_threads
    threads; the pixels equal one thread's and, for baseline JPEG and PNG,
    the native decoder's uint8 pixels (where it builds); a corrupt slot
    stays flagged."""
    _, blobs = _write_fixture(tmp_path)
    blobs = blobs + [b"not an image"]
    native = decode_preprocess_batch(blobs, 64) \
        if build.load_library() is not None else None
    monkeypatch.setattr(build, "load_library", lambda: None)
    assert build.decoder_name() == "pil"
    assert native_decode_preprocess(blobs, 64) is None
    serial, ok1 = decode_preprocess_batch(blobs, 64, num_threads=1)
    threaded, ok4 = decode_preprocess_batch(blobs, 64, num_threads=4)
    np.testing.assert_array_equal(serial, threaded)
    np.testing.assert_array_equal(ok1, ok4)
    assert list(ok4) == [True] * (len(blobs) - 1) + [False]
    assert np.all(threaded[-1] == 0.0)
    if native is not None:
        np.testing.assert_array_equal(native[1], ok4)
        # the same uint8 pixels; the normalize rounds apart by an ulp
        np.testing.assert_allclose(native[0][:2], threaded[:2], rtol=0,
                                   atol=1e-5)


def _copy_builder(tmp_path, broken=False):
    """build.py and the sources in a package of their own, so a build there
    starts from nothing; returns a script that loads the library."""
    pkg = tmp_path / "pkg" / "native"
    pkg.mkdir(parents=True)
    src = os.path.join(ROOT, "clip_embeds_tpu_torch", "native")
    for name in ("build.py", "resize.cpp", "decode.cpp"):
        shutil.copy(os.path.join(src, name), pkg / name)
    if broken:
        (pkg / "decode.cpp").write_text("#include <no_such_header.h>\n")
    return textwrap.dedent(f"""
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location("b", {str(pkg / 'build.py')!r})
        b = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(b)
        print(b.load_library() is not None, b.load_library() is not None,
              b.decoder_name())
    """)


def test_two_processes_building_at_once_both_load(lib, tmp_path):
    script = _copy_builder(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "True", "native"], (out, err)
    # one whole library, no temporary file left behind
    built = os.listdir(tmp_path / "pkg" / "_build")
    assert len(built) == 1 and built[0].endswith(".so"), built


def test_failed_build_says_so_once_and_decodes_with_pil(tmp_path):
    script = _copy_builder(tmp_path, broken=True)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False", "pil"]
    assert proc.stderr.count("native image library unavailable") == 1
    assert "no_such_header.h" in proc.stderr  # g++'s own error
    assert os.listdir(tmp_path / "pkg" / "_build") == []


def test_preprocess_batch_without_the_library(tmp_path, monkeypatch):
    """preprocess_batch of paths decodes with PIL when the library is
    absent, and an undecodable path raises PIL's error, as with it."""
    paths, _ = _write_fixture(tmp_path)
    monkeypatch.setattr(build, "load_library", lambda: None)
    got = preprocess_batch(paths, 64)
    want = np.stack([preprocess_clip(p, 64) for p in paths])
    np.testing.assert_array_equal(got, want)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8broken")
    with pytest.raises(OSError):
        preprocess_batch(paths[:1] + [str(bad)], 64)
    assert loader.variant_kwargs("llava") is None
    assert loader.variant_kwargs("clip")["mean"] == OPENAI_DATASET_MEAN
    assert loader.variant_kwargs("clip")["std"] == OPENAI_DATASET_STD
