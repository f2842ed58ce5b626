"""The port's zero-shot classifier and eval, Flickr retrieval and the
shipped ImageNet metadata against the JAX package's, on seeded numpy
encoders (host numpy on both sides: atol 1e-6); and the metadata keys the
training CLI reads."""

import json
import os
import zlib

import numpy as np
import pytest

from clip_embeds_tpu.evals import flickr as jax_flickr
from clip_embeds_tpu.evals import zero_shot as jax_zs
from clip_embeds_tpu_torch.cli import train as port_train
from clip_embeds_tpu_torch.evals import flickr, zero_shot

DIM = 16


def _embed(key: str, dim: int = DIM) -> np.ndarray:
    """A unit vector drawn from a seed of ``key``'s bytes."""
    v = np.random.default_rng(zlib.crc32(key.encode())).standard_normal(dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _encode(items):
    return np.stack([_embed(str(x)) for x in items])


def _encode_tied(items):
    """The last word's first 6 characters pick the vector: 'thing1' and
    'thing10'..'thing19' tie in the ranking."""
    return np.stack([_embed(str(x).split()[-1][:6]) for x in items])


_CLASSNAMES = [f"thing{i}" for i in range(23)]
_TEMPLATES = ["a photo of a {c}.", "a {c} in the wild.", "art of the {c}."]


@pytest.mark.parametrize("per_batch", [10, 7, None, 1])
@pytest.mark.parametrize("templates", ["strings", "callables"])
def test_classifier_matches_jax(per_batch, templates):
    """23 classes: 10 or 7 a call leave a short last call."""
    tm = {"strings": _TEMPLATES,
          "callables": zero_shot.SIMPLE_TEMPLATES}[templates]
    jtm = {"strings": _TEMPLATES, "callables": jax_zs.SIMPLE_TEMPLATES}[
        templates]
    calls = []

    def enc(prompts):
        calls.append(len(prompts))
        return _encode(prompts)

    got = zero_shot.build_zero_shot_classifier(enc, _CLASSNAMES, tm,
                                               per_batch)
    want = jax_zs.build_zero_shot_classifier(_encode, _CLASSNAMES, jtm,
                                             per_batch)
    assert got.shape == want.shape == (DIM, len(_CLASSNAMES))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, atol=1e-6)
    per = per_batch or len(_CLASSNAMES)
    assert calls[-1] == len(tm) * (len(_CLASSNAMES) - per * (len(calls) - 1))


@pytest.mark.parametrize("encode", [_encode, _encode_tied],
                         ids=["distinct", "ties"])
@pytest.mark.parametrize("batch_size", [8, 64])
def test_zero_shot_eval_matches_jax(encode, batch_size):
    """29 samples (a short last batch at 8); with tied classifier columns
    the ranking's order among ties decides top-1, the same in both."""
    classifier = zero_shot.build_zero_shot_classifier(
        encode, _CLASSNAMES, _TEMPLATES)
    rng = np.random.default_rng(3)
    targets = rng.integers(0, len(_CLASSNAMES), 29)
    # each sample's image is its class's first prompt, half of them
    samples = [_TEMPLATES[0].format(c=_CLASSNAMES[t]) if i % 2 else f"x{i}"
               for i, t in enumerate(targets)]
    got = zero_shot.zero_shot_eval(encode, classifier, samples, targets,
                                   batch_size=batch_size)
    want = jax_zs.zero_shot_eval(encode, classifier, samples, targets,
                                 batch_size=batch_size)
    assert got.keys() == want.keys() == {"top1", "top5"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0 < got["top1"] <= got["top5"] <= 1


def _annotations(n, ties):
    ann = []
    for i in range(n):
        caps = [f"cap{i}-{j}" for j in range(5)]
        if ties and i % 3 == 0:
            caps[2] = f"cap{(i + 1) % n}-0"  # a caption another image has
        ann.append({"image": f"im{i % (n - 2) if ties else i}.jpg",
                    "captions": caps})
    return ann


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_evaluate_retrieval_matches_jax(ties, tmp_path):
    """Images and captions through seeded encoders; with ties, repeated
    images and captions give equal scores. Via annotations.json both
    ways."""
    ann = _annotations(12, ties)
    (tmp_path / "annotations.json").write_text(json.dumps(ann))
    assert flickr.load_flickr_annotations(str(tmp_path)) == ann == \
        jax_flickr.load_flickr_annotations(str(tmp_path))

    def enc_images(paths):  # "root/im3.jpg" -> key "3"
        return 3.0 * _encode(os.path.basename(p)[2:-4] for p in paths)

    def enc_texts(caps):  # "cap3-1" -> key "3", plus the caption's own
        mix = _encode(c.split("-")[0][3:] for c in caps)
        return mix + 0.7 * _encode(caps)  # unnormalised, as a tower's

    got = flickr.evaluate_retrieval(enc_images, enc_texts, ann, "root")
    want = jax_flickr.evaluate_retrieval(enc_images, enc_texts, ann, "root")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0 < got["image_to_text_R@1"] <= got["image_to_text_R@10"] <= 1


def test_metadata_copy_equals_jax():
    port = os.path.join(os.path.dirname(zero_shot.__file__),
                        "zero_shot_metadata.json")
    jax_file = os.path.join(os.path.dirname(jax_zs.__file__),
                            "zero_shot_metadata.json")
    with open(port, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    meta = zero_shot.load_imagenet_metadata()
    assert meta == jax_zs.load_imagenet_metadata()
    assert {k: len(v) for k, v in meta.items()} == {
        "IMAGENET_CLASSNAMES": 1000, "OPENAI_IMAGENET_TEMPLATES": 80,
        "SIMPLE_IMAGENET_TEMPLATES": 7}


def test_cli_reads_the_keys_the_file_has():
    """The training CLI's zero-shot takes the shipped keys (open_clip's
    1000 classnames with the 80 OpenAI templates); the JAX CLI's keys
    'classnames' and 'templates' are not in the file."""
    meta = zero_shot.load_imagenet_metadata()
    classnames, templates = port_train.imagenet_prompts(meta)
    assert len(classnames) == 1000 and len(templates) == 80
    assert classnames[0] == "tench" and templates[0] == \
        "a bad photo of a {c}."
    for key in ("classnames", "templates"):
        with pytest.raises(KeyError):
            jax_zs.load_imagenet_metadata()[key]


def test_imagefolder_samples_sorted(tmp_path):
    for d, files in (("n02", ["b.jpg", "a.jpg"]), ("n01", ["z.jpg"])):
        (tmp_path / d).mkdir()
        for f in files:
            (tmp_path / d / f).write_bytes(b"")
    (tmp_path / "stray.txt").write_text("")
    samples, targets = port_train.imagefolder_samples(str(tmp_path))
    assert [os.path.relpath(s, tmp_path) for s in samples] == [
        "n01/z.jpg", "n02/a.jpg", "n02/b.jpg"]
    assert targets == [0, 1, 1]
