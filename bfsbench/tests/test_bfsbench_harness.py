"""A tiny rehearsal of the harness on the CPU through ``run_cell`` (the
command itself refuses to run without a card), and the readers on a
trace of known shape."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from bfsbench import harness, roofline, tracing
from bfsbench.tests.conftest import tiny_cell

CELLS = [w["name"] for w in harness.read_json(harness.MANIFEST)["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_on_the_cpu(cell, trace, cache_root):
    c = tiny_cell(cell, scale=9, lanes=64)
    r = harness.run_cell(c, seed=2**33 + 1, seconds=0.3, trace=trace, device="cpu",
                         cache_root=cache_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 64
    assert list(r)[-1] == "checks"
    m = harness.read_json(harness.MANIFEST)
    wanted = {x["name"] for x in harness.cell_metrics(m, cell, trace)}
    # a CPU run has no device numbers: those readers find nothing
    device_only = {"peak_mem_gib", "plain_torch_pct", "k1_roofline_pct", "k2_roofline_pct",
                   "device_idle_pct"}
    assert set(r["metrics"]) == {n for n in wanted if n.split(".")[0] not in device_only}
    if trace:
        assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0


def test_same_seed_same_keys_and_lanes(cache_root):
    c = tiny_cell("g500-s21.keys64", scale=9, lanes=64)
    spans = tracing.Spans()
    s = harness.Session(c, seed=5, device="cpu", cache_root=cache_root, spans=spans)
    a, b = s.sampler(2**32 + 9, 0), s.sampler(2**32 + 9, 0)
    for _ in range(3):
        assert (a.next() == b.next()).all()
    assert (s.sampled_lanes(11, 64) == s.sampled_lanes(11, 64)).all()


def test_the_command_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "bfsbench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.BENCH_DIR.parent, env=env, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def _window(events):
    return [{"ph": "X", "name": tracing.WINDOW, "cat": "user_annotation",
             "ts": 0.0, "dur": 1000.0}] + events


def test_readers_on_a_known_trace(tmp_path):
    from bfsbench.harness import RunRecord, load_plugin

    ev = _window([
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::ell_expand_kernel<1>(int const*)",
         "ts": 100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "tile_spmm_kernel(int const*)", "ts": 250.0,
         "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 600.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "tpu_bfs_torch::ell_expand", "ts": 90.0,
         "dur": 5.0, "args": {"Input Dims": [[1], [1, 128], [256, 8], [], []]}},
        {"ph": "X", "cat": "cpu_op", "name": "tpu_bfs_torch::tile_spmm", "ts": 95.0,
         "dur": 5.0, "args": {"Input Dims": [[3], [4], [4, 128, 4], [256, 8], [256, 8], []]}},
        {"ph": "X", "cat": "user_annotation", "name": "bfsbench.dispatch", "ts": 50.0,
         "dur": 600.0},
        {"ph": "X", "cat": "user_annotation", "name": "bfsbench.fetch", "ts": 650.0,
         "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000.0, "dur": 5.0},
    ])
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tw = tracing.read_chrome_trace(str(path), "NVIDIA H100 80GB HBM3")
    facts = {"k2_tiles": {(2, 4): roofline.K2Tiles(slabs=2, row_tiles=2)}}
    rec = RunRecord(None, tracing.Spans(), 0.0, None, None, None, tw, tw.device_name, facts)
    assert tw.busy_seconds() == pytest.approx(350e-6)
    assert load_plugin("metrics", "device_idle_pct").read(rec) == pytest.approx(65.0)
    assert load_plugin("metrics", "plain_torch_pct").read(rec) == pytest.approx(25.0)
    k1_bytes = 4 + 512 + 128 * 32 + 128 * 32
    assert load_plugin("metrics", "k1_roofline_pct").read(rec) == pytest.approx(
        100 * k1_bytes / 3.35e12 / 200e-6)
    k2_bytes = 12 + 16 + 4 * 2048 + 2 * 2 * 128 * 32
    assert load_plugin("metrics", "k2_roofline_pct").read(rec) == pytest.approx(
        100 * k2_bytes / 3.35e12 / 100e-6)
    rec.facts = {}  # no tile counts for the launch's shape: nothing to read
    assert load_plugin("metrics", "k2_roofline_pct").read(rec) is None
    bd = harness.breakdown(tw)
    assert bd["device_ops"][0] == ["ell_expand_kernel<1>", pytest.approx(200e-6)]
    idle = dict(bd["idle_gaps"])
    # gaps 0-100, 350-600, 700-1000 against dispatch 50-650 and fetch 650-950
    assert idle["dispatch"] == pytest.approx(300e-6)
    assert idle["fetch"] == pytest.approx(250e-6)
    assert idle["between"] == pytest.approx(100e-6)


@pytest.mark.cuda
def test_a_card_run_of_a_tiny_cell(card, cache_root):
    c = tiny_cell("g500-s21.keys64", scale=12, lanes=64)
    r = harness.run_cell(c, seed=7, seconds=0.5, trace=True, device=card, cache_root=cache_root)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
