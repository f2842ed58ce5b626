"""Device time a step of the backward pass, ms: the program's
``train.backward`` spans (``loss.backward()``, remat's recompute
included) over its ``train.step`` spans."""

from port_bench import program_spans


def read(summary, counts, config, traffic):
    return program_spans.ms_per_step("train.step/train.backward")
