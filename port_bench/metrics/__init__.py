"""One reader per per-layer metric: ``read(summary, counts, config,
traffic)`` returns the metric's value, or None where the trace holds
nothing for it."""
