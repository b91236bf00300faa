"""The yardstick imports nothing of the program, JAX, or the JAX package;
the check compares whole top-level module names."""

from __future__ import annotations

import subprocess
import sys
import types

from bfsbench import harness

YARDSTICK = [
    "bfsbench.reference.bfs", "bfsbench.reference.components", "bfsbench.reference.graph",
    "bfsbench.graphs.kronecker", "bfsbench.graphs.urand", "bfsbench.roofline",
    "bfsbench.traffic.graph500_keys", "bfsbench.traffic.closed_loop", "bfsbench.harness",
    "bfsbench.tracing", "bfsbench.cache",
]


def test_yardstick_loads_no_program_and_no_jax():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in YARDSTICK)
            + "from bfsbench import harness\n"
            + "for k in ('gteps', 'k1_roofline_pct', 'k2_roofline_pct', 'plain_torch_pct'):\n"
            + "    harness.load_plugin('metrics', k)\n"
            + "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.BENCH_DIR.parent, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "tpu_bfs", "tpu_bfs_torch"}


def test_banned_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_bfs_torch_like", types.ModuleType("x"))
    assert "tpu_bfs_torch_like" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "tpu_bfs.graph", types.ModuleType("tpu_bfs.graph"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert {"tpu_bfs.graph", "jaxlib"} <= set(harness.banned_modules())
