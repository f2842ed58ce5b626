"""Device time of the host-to-device copies a batch (the program's pinned
float32 copy of each image batch, on the compute stream), ms."""


def read(summary, counts, config, traffic):
    c = summary["memcpy"].get("HtoD")
    if not c or not counts.get("batches"):
        return None
    return c[1] / counts["batches"] * 1e3
