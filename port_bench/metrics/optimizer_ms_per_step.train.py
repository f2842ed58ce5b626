"""Device time a step of the optimizer's kernels, ms: torch's AdamW runs
as multi-tensor-apply kernels (foreach; a fused AdamW's name holds
'adam'), which nothing else in the train step launches."""

import re

KERNELS = re.compile(r"multi_tensor_apply|adam", re.IGNORECASE)


def read(summary, counts, config, traffic):
    sec = sum(c[1] for n, c in summary["kernels"].items()
              if KERNELS.search(n))
    if sec <= 0.0 or not counts.get("steps"):
        return None
    return sec / counts["steps"] * 1e3
