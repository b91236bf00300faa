"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by name."""

from __future__ import annotations

import json
import re

import pytest

from bfsbench import harness

M = harness.read_json(harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert harness.MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_a_full_check_with_24_cells_fits():
    cells = 24
    need = (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in M[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert not set(e2e) & {m["name"] for m in M["per_layer"]}
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in M["workloads"]}
        if m["name"].endswith("_roofline_pct") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_metric_has_its_reader():
    for m in M["end_to_end"] + M["per_layer"]:
        assert callable(harness.load_plugin("metrics", m["name"]).read)


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("bfsbench/configs/") and c["file"] not in files
        files.add(c["file"])
        cfg = harness.read_json(harness.BENCH_DIR.parent / c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        harness.load_plugin("graphs", cfg["graph"]["generator"])
        harness.load_plugin("engines", cfg["engine"]["name"])


def test_cells():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"]) and NAME.match(w["traffic"])
        cell = harness.load_cell(w["name"], M)
        harness.load_plugin("traffic", cell.traffic["sampler"])
        harness.load_plugin("traffic", cell.traffic["loop"])
        assert cell.traffic["keys_per_batch"] <= cell.lanes
        # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert {"setup_s"} < {m["name"] for m in harness.cell_metrics(M, w["name"], False)}
        assert harness.cell_metrics(M, w["name"], True)


def test_each_cell_reports_what_its_layer_metrics_move():
    for w in M["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(M, w["name"], False)}
        for m in harness.cell_metrics(M, w["name"], True):
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_command_names_only_files_under_paths():
    for word in M["command"]:
        assert not word.startswith("/") and ".." not in word
    assert M["command"][:3] == ["python3", "-m", "bfsbench.run"]
    assert json.dumps(M["paths"]) == '["bfsbench"]'
