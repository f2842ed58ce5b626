"""The cost arithmetic against torch's FLOP counter on the reference towers
at published widths (meta device), and its conventions."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import costs
from port_bench.harness import read_json
from port_bench.reference.towers import encode_image, encode_text, param_specs

CONFIGS = ["vitl14_336_openai", "eva01_g14"]


def _meta_params(config):
    return {name: torch.empty(shape, device="meta")
            for name, shape, _, _ in param_specs(config)}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", CONFIGS)
def test_image_flops_match_flop_counter(name):
    config = read_json("configs", name + ".json")
    p = _meta_params(config)
    s = config["vision"]["image_size"]
    images = torch.empty(2, s, s, 3, device="meta")
    counted = _count(lambda: encode_image(p, config, images))
    assert counted == 2 * costs.embed_flops_per_item(config, "vision")


@pytest.mark.parametrize("name", CONFIGS)
def test_text_flops_match_flop_counter(name):
    """The plain masked attention computes all N^2 pairs; the model FLOPs
    count the kept N(N+1)/2, which the counter cannot see."""
    config = read_json("configs", name + ".json")
    p = _meta_params(config)
    ids = torch.zeros(2, config["text"]["context_length"], dtype=torch.long,
                      device="meta")
    counted = _count(lambda: encode_text(p, config, ids))
    full = costs.tower_forward_flops(config["text"], config["embed_dim"],
                                     causal_pairs=False)
    assert counted == 2 * full
    kept = costs.tower_forward_flops(config["text"], config["embed_dim"])
    n, t = 77, config["text"]
    assert full - kept == t["layers"] * 4 * t["width"] * (n * n - n * (n + 1)
                                                          // 2)


def test_published_sizes():
    vit = read_json("configs", "vitl14_336_openai.json")
    eva = read_json("configs", "eva01_g14.json")
    # 381.9 GFLOP an image (381.2 in the blocks), 13.3 a text, 1.64 TFLOP
    # an EVA01-g/14 sample
    assert costs.embed_flops_per_item(vit, "vision") == pytest.approx(
        381.92e9, rel=1e-4)
    assert costs.embed_flops_per_item(vit, "text") == pytest.approx(
        13.3e9, rel=1e-2)
    assert costs.train_flops_per_step(eva, 1, 0, False) == pytest.approx(
        1.64e12, rel=1e-2)
    params = sum(math.prod(s) for _, s, _, _ in param_specs(eva))
    assert params == 1136435841
    assert costs.attention_shape(eva["vision"]) == (16, 257, 88, False)


def test_head_dim_88_counted_at_88():
    flops, nbytes = costs.attention_fwd_cost(64, 16, 257, 88, False)
    assert flops == 4 * 64 * 16 * 257 * 257 * 88
    assert nbytes == 4 * 64 * 16 * 257 * 88 * 2
    bflops, _ = costs.attention_bwd_cost(64, 16, 257, 88, False)
    assert bflops == 2.5 * flops


@pytest.mark.parametrize("n", [1, 77, 257])
def test_causal_pairs(n):
    assert costs.attention_pairs(n, True) == n * (n + 1) // 2
    assert costs.attention_pairs(n, False) == n * n
    f_causal, _ = costs.attention_fwd_cost(1, 1, n, 64, True)
    assert f_causal == 4 * 64 * n * (n + 1) // 2


def test_bound_and_block_cost():
    ms, which = costs.bound_ms(flops=989e12)
    assert (ms, which) == (pytest.approx(1e3), "operations")
    ms, which = costs.bound_ms(nbytes=3.35e12)
    assert (ms, which) == (pytest.approx(1e3), "bytes")
    # the text block: projections over 77 rows, causal attention
    b, n, d, mlp, h = 256, 77, 768, 3072, 12
    ms, which = costs.block_cost(b, n, d, mlp, h, n, True)
    flops = 2 * b * n * (4 * d * d + 2 * d * mlp) \
        + 4 * b * h * (n * (n + 1) // 2) * (d // h)
    assert which == "operations"
    assert ms == pytest.approx(flops / 989e12 * 1e3)


def _summary(kernels, memcpy=None, busy=9.0, window=10.0):
    return {"kernels": kernels, "memcpy": memcpy or {}, "busy_s": busy,
            "window_s": window}


def test_metric_readers():
    from port_bench.harness import load_file

    vit = read_json("configs", "vitl14_336_openai.json")
    eva = read_json("configs", "eva01_g14.json")
    images = read_json("traffic", "images_b256.json")
    train = read_json("traffic", "train_b64.json")
    lit = read_json("traffic", "lit_hardneg_b256.json")
    texts = read_json("traffic", "texts_b256.json")
    read = lambda name, *a: load_file("metrics", name).read(*a)
    counts = {"batches": 10, "returned": 2560, "window_s": 3.0}
    s = _summary({"void cet::attention_kernel<64>(FwdMaps)": [240, 0.5],
                  "void cet::attention_bwd_dq_kernel<128>()": [1, 9.0],
                  "nvjet_tst_gemm": [100, 2.0]},
                 memcpy={"HtoD": [10, 0.08]})
    # 240 calls of the image tower's attention, 0.361 ms each at the bound:
    # 1.21 GB of q, k, v and o outweigh the 349 GFLOP at this head dim
    share = read("flash_fwd_roofline", s, counts, vit, images)
    assert share == pytest.approx(240 * 0.36121 / 500 * 100, rel=1e-4)
    assert read("h2d_ms_per_batch.embed", s, counts, vit, images) == \
        pytest.approx(8.0)
    assert read("device_idle_share.embed", s, counts, vit, images) == \
        pytest.approx(10.0)
    assert read("mfu.embed", s, counts, vit, images) == pytest.approx(
        2560 * 381.92e9 / (9.0 * 989e12) * 100, rel=1e-4)
    assert read("flash_fwd_roofline", _summary({}), counts, vit,
                images) is None
    assert read("fused_block_roofline", _summary({"nvjet_tst_gemm": [1, 1.0]}),
                counts, vit, texts) is None
    assert read("fused_block_roofline", s, counts, vit, texts) > 0
    tc = {"steps": 5, "samples": 320, "window_s": 2.0}
    assert read("flash_bwd_roofline", s, tc, eva, train) > 0
    assert read("flash_bwd_roofline", s, tc, vit, lit) is None
    adam = "void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>>"
    assert read("optimizer_ms_per_step.train", _summary(
        {adam: [9, 0.1]}), tc, eva, train) == pytest.approx(20.0)
    assert read("mfu.train", s, tc, eva, train) == pytest.approx(
        5 * costs.train_flops_per_step(eva, 64, 0, False)
        / (9.0 * 989e12) * 100)


def test_union_of_device_intervals():
    from port_bench.trace import _union

    busy, gaps = _union([(10, 20), (15, 30), (40, 50)], 0, 60)
    assert busy == pytest.approx(30e-9)
    assert gaps == [(0, 10), (30, 40), (50, 60)]
    assert _union([], 0, 5) == (0.0, [(0, 5)])
