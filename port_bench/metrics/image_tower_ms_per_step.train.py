"""Device time a step of the image tower's forward in training, ms: the
program's ``tower.image`` spans under ``train.forward`` (the frozen
forward of a locked tower too; a recompute under ``train.backward`` is not
counted) over its ``train.step`` spans."""

from port_bench import program_spans


def read(summary, counts, config, traffic):
    return program_spans.ms_per_step(
        "train.step/train.forward/tower.image")
