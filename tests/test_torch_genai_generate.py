"""The port's GenAI-Bench generate CLI (``clip_embeds_tpu_torch/cli/
genai_generate.py``), mirroring ``tests/test_genai_generate.py``: the
output layout, determinism, generate-then-score through the port's
``GenAIBench``; beside the JAX CLI, byte-equal synthetic JPEGs, the same
prompt order, and the diffusers source's actionable error where the
package is absent."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from clip_embeds_tpu.cli import genai_generate as jax_gen
from clip_embeds_tpu_torch.cli import genai_generate as port_gen


@pytest.fixture()
def prompts_json(tmp_path):
    prompts = {str(i): {"prompt": f"a photo of object {i}"}
               for i in range(12)}
    path = tmp_path / "genai_image.json"
    path.write_text(json.dumps(prompts))
    return str(path)


def test_generate_synthetic_layout(prompts_json, tmp_path):
    out = port_gen.main([
        "--prompts", prompts_json, "--gen-model", "toy-model",
        "--output-dir", str(tmp_path / "outputs"),
        "--image-source", "synthetic", "--num-prompts", "5",
    ])
    assert out == str(tmp_path / "outputs" / "toy-model")
    assert sorted(os.listdir(out)) == [f"{i}.jpeg" for i in range(5)]


def test_generate_deterministic(prompts_json, tmp_path):
    a = port_gen.main(["--prompts", prompts_json, "--gen-model", "m",
                       "--output-dir", str(tmp_path / "a")])
    b = port_gen.main(["--prompts", prompts_json, "--gen-model", "m",
                       "--output-dir", str(tmp_path / "b")])
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read()


def test_synthetic_jpegs_and_order_equal_jax(prompts_json, tmp_path):
    """The same files, byte for byte, in the same order ('10' after '9':
    the keys sort by length, then text), from a list of prompts too."""
    for prompts in (prompts_json, str(tmp_path / "list.json")):
        if prompts.endswith("list.json"):
            with open(prompts, "w") as fh:
                json.dump([f"p{i}" for i in range(3)] + [{"prompt": "q"}],
                          fh)
        assert port_gen.load_prompts(prompts) == jax_gen.load_prompts(
            prompts)
        argv = ["--prompts", prompts, "--num-prompts", "11"]
        mine = port_gen.main(argv + ["--output-dir", str(tmp_path / "p")])
        theirs = jax_gen.main(argv + ["--output-dir", str(tmp_path / "j")])
        names = sorted(os.listdir(theirs))
        assert sorted(os.listdir(mine)) == names
        for name in names:
            with open(os.path.join(mine, name), "rb") as fa, \
                    open(os.path.join(theirs, name), "rb") as fb:
                assert fa.read() == fb.read(), name


def test_callable_source_and_bad_source(prompts_json, tmp_path, monkeypatch):
    """'module:callable' sources are called with (prompt, idx, seed); a
    source without ':' exits naming the three forms."""
    from PIL import Image

    seen = []

    def source(prompt, idx, seed):
        seen.append((prompt, idx, seed))
        return Image.new("RGB", (16, 16), (int(idx) * 20, 0, 0))

    mod = type(sys)("genai_test_source")
    mod.source = source
    monkeypatch.setitem(sys.modules, "genai_test_source", mod)
    out = port_gen.main(["--prompts", prompts_json, "--num-prompts", "3",
                         "--image-source", "genai_test_source:source",
                         "--seed", "5", "--output-dir", str(tmp_path)])
    assert seen == [(f"a photo of object {i}", str(i), 5) for i in range(3)]
    assert sorted(os.listdir(out)) == ["0.jpeg", "1.jpeg", "2.jpeg"]
    with pytest.raises(SystemExit, match="module:callable"):
        port_gen.main(["--prompts", prompts_json, "--image-source", "nope",
                       "--output-dir", str(tmp_path)])


def test_diffusers_source_is_actionable_without_the_package(
        prompts_json, tmp_path, monkeypatch):
    """Without the optional diffusers package both CLIs exit with the
    actionable error; the port's source would place the pipeline on
    --device, and without a card 'cuda' exits."""
    monkeypatch.setitem(sys.modules, "diffusers", None)
    argv = ["--prompts", prompts_json, "--image-source", "diffusers",
            "--output-dir", str(tmp_path)]
    for gen in (port_gen, jax_gen):
        with pytest.raises(SystemExit, match="needs the diffusers package"):
            gen.main(argv)
    fake = type(sys)("diffusers")
    fake.StableDiffusionPipeline = None
    monkeypatch.setitem(sys.modules, "diffusers", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        port_gen.main(argv)


def test_generate_then_score(prompts_json, tmp_path):
    """The CLI's output feeds the port's GenAIBench scoring dataset."""
    from clip_embeds_tpu_torch.evals.benchmarks import GenAIBench

    out = port_gen.main(["--prompts", prompts_json, "--gen-model", "toy",
                         "--output-dir", str(tmp_path / "outputs"),
                         "--num-prompts", "6"])
    root = tmp_path / "bench_root"
    (root / "images").mkdir(parents=True)
    meta = {}
    rng = np.random.default_rng(0)
    for i in range(6):
        os.link(os.path.join(out, f"{i}.jpeg"), root / "images" / f"{i}.jpeg")
        meta[str(i)] = {
            "image": f"{i}.jpeg",
            "prompt": f"a photo of object {i}",
            "human_alignment": rng.integers(1, 6, 3).tolist(),
        }
    (root / "metadata.json").write_text(json.dumps(meta))

    ds = GenAIBench(str(root))
    assert len(ds.samples) == 6
    for s in ds.samples:
        assert os.path.exists(s["images"][0])
    metrics = ds.evaluate_scores(rng.random(6))
    assert "alignment" in metrics and metrics["alignment"]
