"""The fused text blocks' share of their roofline in caption embedding, %:
the least time the card needs for the text tower's blocks of every batch
in the window (``costs.block_cost``: the four projections over the 77
rows, causal attention over its kept pairs, x, weights and biases read
once, y written once; bf16) over the device time of the kernels that
implement the blocks, matched by name (the #1 chain's layernorm, GEMM and
attention kernels)."""

import re

from port_bench import costs

KERNELS = re.compile(r"\b(layernorm_kernel|gemm_kernel|attention_kernel)\b")


def read(summary, counts, config, traffic):
    sec = sum(c[1] for n, c in summary["kernels"].items()
              if KERNELS.search(n))
    if sec <= 0.0 or not counts.get("batches"):
        return None
    t = config["text"]
    n = costs.tower_rows(t)
    one, _ = costs.block_cost(traffic["batch"], n, t["width"], t["mlp_width"],
                              t["heads"], n, bool(t.get("causal")))
    return one * t["layers"] * counts["batches"] / 1e3 / sec * 100.0
