"""Device time a step of the update, ms: the program's ``train.update``
spans (``TrainState.apply_gradients``: gradient sync, clipping, the
learning rate, AdamW, clearing the gradients) over its ``train.step``
spans."""

from port_bench import program_spans


def read(summary, counts, config, traffic):
    return program_spans.ms_per_step("train.step/train.update")
