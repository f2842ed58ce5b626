"""``image/preprocess.py jax_preprocess``, the on-device squash resize and
normalise, against the JAX package's on the CPU: both variants ('clip':
bicubic and OpenAI stats; 'pacl': bilinear and ImageNet's), up, down, mixed
and at the size, within 1e-5 of the normalised values (fp32 filters in a
different order: about 1e-6 apart). ``F.interpolate`` without
``antialias`` is another filter (a = -0.75 and clamped borders up,
two-tap sampling down), which the last case shows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_embeds_tpu.image.preprocess import jax_preprocess as jax_version
from clip_embeds_tpu_torch.image.preprocess import jax_preprocess

SHAPES = {"up": (20, 28, 32), "down": (64, 48, 32), "mixed": (50, 17, 24),
          "same": (32, 32, 32)}


def _batch(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (3, h, w, 3),
                                                np.uint8)


@pytest.mark.parametrize("variant", ["clip", "pacl"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_jax_preprocess_matches_jax(shape, variant):
    h, w, s = SHAPES[shape]
    u8 = _batch(h, w)
    got = jax_preprocess(torch.from_numpy(u8), s, variant)
    want = np.asarray(jax_version(jnp.asarray(u8), s, variant))
    assert got.shape == want.shape == (3, s, s, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_jax_preprocess_casts_to_the_dtype_asked():
    u8 = torch.from_numpy(_batch(40, 40))
    got = jax_preprocess(u8, 32, "clip", torch.bfloat16)
    want = jax_preprocess(u8, 32, "clip")
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("shape", ["up", "down"])
def test_interpolate_without_antialias_is_another_filter(shape):
    h, w, s = SHAPES[shape]
    u8 = _batch(h, w)
    x = torch.from_numpy(u8).float().permute(0, 3, 1, 2) / 255.0
    plain = F.interpolate(x, size=(s, s), mode="bicubic",
                          align_corners=False).permute(0, 2, 3, 1)
    want = np.asarray(jax_version(jnp.asarray(u8), s, "clip"))
    mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
    assert np.abs((plain.numpy() - mean) / std - want).max() > 1e-2
