"""bfsbench: the benchmark of ``tpu_bfs_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m bfsbench.run --workload g500-s21.keys8192 --seed 7 --seconds 10 --trace 0

Everything a cell needs is found by name: its file under ``workloads/``,
its configuration under ``configs/``, its traffic mix under ``traffic/``,
the graph generator and engine adapter the configuration names under
``graphs/`` and ``engines/``, and one reader a per-layer metric under
``metrics/``. The yardstick (generators, key sampler, plain reference,
least-bytes functions, peaks) lives here and imports nothing of the
program; only ``engines/`` and the harness's run of an engine touch
``tpu_bfs_torch``.
"""
