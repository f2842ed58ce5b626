"""Share of the traced window in which no kernel, copy or set ran on the
device, %."""


def read(summary, counts, config, traffic):
    if summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return (1.0 - summary["busy_s"] / summary["window_s"]) * 100.0
