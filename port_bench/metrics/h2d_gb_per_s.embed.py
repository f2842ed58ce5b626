"""Rate of the copies to the card, GB/s: the bytes the program counted
handing batches to the card (``h2d_bytes``) over the device time of the
trace's host-to-device copies."""

from port_bench import program_spans


def read(summary, counts, config, traffic):
    snap = program_spans.snapshot()
    c = summary["memcpy"].get("HtoD")
    if snap is None or not c or c[1] <= 0 or \
            not snap["counters"].get("h2d_bytes"):
        return None
    return snap["counters"]["h2d_bytes"] / c[1] / 1e9
