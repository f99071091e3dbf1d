"""One reader an end-to-end metric, named as in BENCHMARK.json: ``read(ctx)``
returns the metric's value from the measured window (host clock), or None
where the cell has nothing to read."""
