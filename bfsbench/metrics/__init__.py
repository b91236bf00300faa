"""Metric readers, one module a metric of ``BENCHMARK.json``, found by the
metric's name. Each has ``read(record) -> float | None``, where ``record``
is the run's :class:`bfsbench.harness.RunRecord`. A reader that finds
nothing to read returns None and the metric is left out of the line."""
