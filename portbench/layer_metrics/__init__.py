"""One reader a per-layer metric, named as in BENCHMARK.json: ``read(ctx)``
returns the metric's value (or a dict with ``value`` and further keys), or
None where it finds nothing to read; the run then leaves the metric out."""
