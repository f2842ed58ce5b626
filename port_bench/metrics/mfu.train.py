"""Model FLOPs of the window's completed steps over the device's busy time
in the traced window and the H100's bf16 dense peak, %: three forwards of
a trained tower, one of a locked one, hard-negative texts included,
recomputation not (``costs.py``). The busy time is the trace's, so the
tracer's cost on the host does not enter; idle time is
``device_idle_share.train``'s."""

from port_bench import costs


def read(summary, counts, config, traffic):
    if summary["busy_s"] <= 0 or not counts.get("steps"):
        return None
    flops = counts["steps"] * costs.train_flops_per_step(
        config, traffic["batch"], traffic.get("hard_texts", 0),
        bool(traffic.get("lock_image")))
    return flops / (summary["busy_s"] * costs.PEAK_BF16) * 100.0
