"""The attention backward's share of its roofline in training, %: the
least time the card needs for the trained image tower's attention
backwards of every step in the window (``costs.attention_bwd_cost`` at the
published head dim, 88 for EVA01-g/14 and not the 128 the kernel pads it
to, bf16) over the device time of the kernels that implement it, matched
by name. The 77-token text tower's attention is outside it (plain
attention), and a locked image tower has none."""

import re

from port_bench import costs

# the port's #5 (csrc/attention_bwd.cu), and the names SDPA's and a
# Triton attention backward would carry
KERNELS = re.compile(r"attention_bwd|flash_bwd|fmha.*bwd|_attn_bwd",
                     re.IGNORECASE)


def read(summary, counts, config, traffic):
    if traffic.get("lock_image"):
        return None
    sec = sum(c[1] for n, c in summary["kernels"].items()
              if KERNELS.search(n))
    if sec <= 0.0 or not counts.get("steps"):
        return None
    v = config["vision"]
    heads, n, hd, causal = costs.attention_shape(v)
    flops, nbytes = costs.attention_bwd_cost(traffic["batch"], heads, n, hd,
                                             causal)
    calls = counts["steps"] * v["layers"]
    bound_ms, _ = costs.bound_ms(flops=flops * calls, nbytes=nbytes * calls)
    return bound_ms / 1e3 / sec * 100.0
