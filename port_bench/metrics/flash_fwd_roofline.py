"""The attention forward's share of its roofline in image embedding, %:
the least time the card needs for the image tower's attention forwards of
every batch in the window (``costs.attention_fwd_cost`` at the published
head dim and rows, bf16) over the device time of the kernels that
implement it, matched by name."""

import re

from port_bench import costs

# the port's #4 (csrc/attention.cu), and the names SDPA's and a Triton
# attention forward would carry
KERNELS = re.compile(r"attention_kernel|flash_fwd|fmha.*fwd|_attn_fwd|sdpa",
                     re.IGNORECASE)
NOT = re.compile(r"bwd|backward", re.IGNORECASE)


def read(summary, counts, config, traffic):
    sec = sum(c[1] for n, c in summary["kernels"].items()
              if KERNELS.search(n) and not NOT.search(n))
    if sec <= 0.0 or not counts.get("batches"):
        return None
    v = config["vision"]
    heads, n, hd, causal = costs.attention_shape(v)
    flops, nbytes = costs.attention_fwd_cost(traffic["batch"], heads, n, hd,
                                             causal)
    calls = counts["batches"] * v["layers"]
    bound_ms, _ = costs.bound_ms(flops=flops * calls, nbytes=nbytes * calls)
    return bound_ms / 1e3 / sec * 100.0
