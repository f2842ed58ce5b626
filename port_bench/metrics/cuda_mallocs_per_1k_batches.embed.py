"""``cudaMalloc`` calls of the caching allocator a thousand batches of the
entry's loop: the program's ``cuda_mallocs`` counter on its ``embed.loop``
span (the outputs it keeps on the card as they grow, and the batches'
working memory) times 1000 over its ``embed.batch`` spans. The final
fetch's own are on ``embed.fetch``."""

from port_bench import program_spans


def read(summary, counts, config, traffic):
    snap = program_spans.snapshot()
    loop = program_spans.path(snap, "embed.call/embed.loop")
    batches = program_spans.path(snap, "embed.call/embed.loop/embed.batch")
    if loop is None or batches is None or \
            "cuda_mallocs" not in loop["counters"]:
        return None
    return loop["counters"]["cuda_mallocs"] * 1000.0 / batches["count"]
