"""Device time a step of the text tower's forwards in training, ms: the
program's ``tower.text`` spans under ``train.forward`` (the captions and
any hard-negative captions) over its ``train.step`` spans."""

from port_bench import program_spans


def read(summary, counts, config, traffic):
    return program_spans.ms_per_step("train.step/train.forward/tower.text")
