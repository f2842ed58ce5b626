"""Model FLOPs of the items the window returned over the device's busy
time in the traced window and the H100's bf16 dense peak, %: the whole
embedding call's share of the chip while it works (``costs.py``: matrix
products of the forward pass). The busy time is the trace's, so the
tracer's cost on the host does not enter; idle time is
``device_idle_share.embed``'s."""

from port_bench import costs

TOWER = {"embed_images": "vision", "embed_texts": "text"}


def read(summary, counts, config, traffic):
    tower = TOWER.get(traffic["kind"])
    if tower is None or summary["busy_s"] <= 0 or not counts.get("returned"):
        return None
    flops = counts["returned"] * costs.embed_flops_per_item(config, tower)
    return flops / (summary["busy_s"] * costs.PEAK_BF16) * 100.0
