"""One driver per traffic kind; ``run(bench)`` returns the run's numbers."""
