"""The port's JSONL server (``run_server``) against the JAX package's.

Both servers run in process on the same request stream (``StringIO``
stdin and stdout): the response lines must be equal once the timing field
(``latency_ms``) is dropped, ``distances_npy`` byte for byte, and the
error texts too. The stream fills one 32-lane batch exactly, so batch
composition does not depend on timing. Then the port's server runs as a
subprocess (``python -m tpu_bfs_torch.serve --device cpu``) and drains on
SIGTERM with a final statsz line and exit code 0.
"""

import io
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_bfs import faults as jfaults
from tpu_bfs import obs as jobs
from tpu_bfs.serve import EngineRegistry as JRegistry
from tpu_bfs.serve import frontend as jfront

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch import obs as tobs
from tpu_bfs_torch.cli import load_graph
from tpu_bfs_torch.reference import bfs_scipy
from tpu_bfs_torch.serve import EngineRegistry as TRegistry
from tpu_bfs_torch.serve import frontend as tfront

from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

pytestmark = pytest.mark.serve

ROOT = Path(__file__).resolve().parents[1]
SPEC = "rmat:scale=8,ef=8,seed=5"
COMMON = [SPEC, "--lanes", "32", "--ladder", "off", "--linger-ms", "300",
          "--statsz-interval-s", "0"]


@pytest.fixture(autouse=True)
def _disarm():
    """A server run with --faults or --obs arms its package's schedule and
    recorder process-wide; disarm both packages' after each test, so a
    later test file on the same worker starts disarmed."""
    yield
    for mod in (jfaults, jobs, tfaults, tobs):
        mod.disarm()


@pytest.fixture(scope="module")
def regs():
    return JRegistry(capacity=4), TRegistry(capacity=4, device="cpu")


def _run(front, reg, requests: str, extra=()):
    argv = list(COMMON) + list(extra)
    if front is tfront:
        argv += ["--device", "cpu"]
    args = front.build_arg_parser().parse_args(argv)
    out, err = io.StringIO(), io.StringIO()
    assert front.run_server(args, stdin=io.StringIO(requests), stdout=out,
                            stderr=err, registry=reg) == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    statsz = [ln for ln in err.getvalue().splitlines() if ln.startswith("statsz ")]
    return lines, json.loads(statsz[-1][len("statsz "):])


def _canon(lines):
    out = []
    for r in lines:
        r = dict(r)
        r.pop("latency_ms", None)
        out.append(json.dumps(r, sort_keys=True))
    return sorted(out)


def _stream(g):
    src = np.random.default_rng(11).choice(g.num_vertices, 32, replace=False)
    reqs = [{"id": f"q{i}", "source": int(s)} for i, s in enumerate(src[:31])]
    reqs.append({"id": "nodist", "source": int(src[31]), "want_distances": False})
    lines = [json.dumps(r) for r in reqs]
    lines += [
        "this is not json",
        "[1, 2, 3]",
        '{"id": "nosrc"}',
        json.dumps({"id": "far", "source": g.num_vertices + 5}),
        '{"id": "bool", "source": true}',
        '{"id": "frac", "source": 7.9}',
        '{"id": "ddl", "source": 1, "deadline_ms": "soon"}',
        '{"id": "want", "source": 2, "want_distances": "yes"}',
        '{"id": "kind?", "source": 1, "kind": "mystery"}',
        '{"id": "kindtype", "source": 1, "kind": 7}',
        '{"id": "khop-no-k", "source": 1, "kind": "khop"}',
        '{"id": "cc", "source": 3, "kind": "cc"}',
    ]
    return "\n".join(lines) + "\n", reqs


def test_jsonl_lines_equal_jax(regs):
    g = load_graph(SPEC)
    requests, reqs = _stream(g)
    got, tstat = _run(tfront, regs[1], requests)
    want, jstat = _run(jfront, regs[0], requests)
    assert _canon(got) == _canon(want)
    assert len(got) == len(reqs) + 12
    by_id = {r.get("id"): r for r in got}
    for r in reqs[:3]:
        d = tfront.decode_distances(by_id[r["id"]]["distances_npy"])
        assert d.dtype == np.int32
        np.testing.assert_array_equal(d, bfs_scipy(g, r["source"]))
    assert "distances_npy" not in by_id["nodist"]
    assert by_id["q0"]["batch_lanes"] == 32 and by_id["cc"]["batch_lanes"] == 1
    assert "out of range" in by_id["far"]["error"]
    # The final statsz lines carry the same keys and counts.
    assert set(tstat) == set(jstat)
    for key in ("completed", "batches", "errors", "rejected", "routing",
                "fill_ratio", "padded_lanes_total", "devices", "breaker_opens"):
        assert tstat[key] == jstat[key], key


def test_jsonl_no_distances_flag_equal_jax(regs):
    requests = "".join(json.dumps({"id": i, "source": s}) + "\n"
                       for i, s in enumerate(range(32)))
    got, _ = _run(tfront, regs[1], requests, ["--no-distances"])
    want, _ = _run(jfront, regs[0], requests, ["--no-distances"])
    assert _canon(got) == _canon(want)
    assert all("distances_npy" not in r for r in got)


def _mutate_stream(g) -> str:
    """Mutations first (the reader applies each before reading on), then
    queries, so every answer is the last generation's whatever the timing."""
    deg = g.degrees
    low = [int(v) for v in np.flatnonzero((deg > 0) & (deg < 8))[:6]]
    hub = int(np.argmax(deg))
    hub_nbr = int(g.col_idx[g.row_ptr[hub]])
    src, dst = g.coo
    pair = next((int(a), int(b)) for a, b in zip(src, dst) if deg[a] < 8 and deg[b] < 8)
    lines = [
        {"id": "m1", "op": "mutate", "add": [[low[0], low[1]], [low[2], low[3], 7]]},
        {"id": "m2", "op": "mutate", "remove": [list(pair)]},
        {"id": "m3", "op": "mutate", "add": "x"},
        {"id": "m4", "op": "mutate", "add": [[0, g.num_vertices]]},
        # The hub's override row cannot fit kcap, compaction or not.
        {"id": "m5", "op": "mutate", "remove": [[hub, hub_nbr]]},
        {"id": "m6", "op": "mutate", "add": [[low[4], low[5]]], "remove": [[low[2], low[3]]]},
    ]
    # 32 queries fill one 32-lane batch: its composition does not depend on
    # timing.
    sources = [int(v) for v in np.flatnonzero(deg > 0)[:31]] + [hub]
    lines += [{"id": f"q{i}", "source": s} for i, s in enumerate(sources)]
    return "".join(json.dumps(r) + "\n" for r in lines)


def _no_flip(lines):
    out = []
    for r in lines:
        r = dict(r)
        if r.get("op") == "mutate" and r.get("ok"):
            assert r.pop("flip_ms") >= 0
        out.append(r)
    return _canon(out)


def _ready_run(front, requests: str, extra):
    """A server run's response lines and its READY line."""
    argv = list(COMMON) + list(extra) + (["--device", "cpu"] if front is tfront else [])
    out, err = io.StringIO(), io.StringIO()
    assert front.run_server(front.build_arg_parser().parse_args(argv),
                            stdin=io.StringIO(requests), stdout=out, stderr=err) == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    for r in lines:  # timings are each package's own
        r["gteps"] = r.get("gteps", 0) > 0
    ready = [ln for ln in err.getvalue().splitlines() if "READY" in ln]
    assert len(ready) == 1, err.getvalue()
    return _canon(lines), ready[0]


def test_jsonl_refuses_unported_flags_and_ops(regs, tmp_path):
    # The mesh flags are ported: --engine dist2d on one device raises JAX's
    # ValueError, and --devices 2 serves (the port on two gloo ranks this
    # process starts) the lines JAX serves on two virtual devices.
    errs = []
    for front, reg in ((tfront, regs[1]), (jfront, regs[0])):
        with pytest.raises(ValueError) as ei:
            _run(front, reg, "", ["--engine", "dist2d"])
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "devices >= 2" in errs[0]
    queries = "".join(json.dumps({"id": i, "source": s}) + "\n"
                      for i, s in enumerate((0, 3, 7)))
    from tpu_bfs_torch.parallel.mesh import serve_mesh

    # One pair of ranks for both servers (a server that finds the process's
    # serving mesh uses it; one that does not would start its own).
    ctl = serve_mesh(2, device="cpu")
    try:
        runs = [(_run(tfront, None, queries, flag), _run(jfront, None, queries, flag))
                for flag in (["--devices", "2"], ["--devices", "2", "--audit-rate", "0.1"])]
        # The AOT preheat on a mesh: each package's --export-aot on two
        # devices, then a --preheat --devices 2 successor, whose READY line
        # carries JAX's extras (one mesh program a rung, every rank's).
        aot = {}
        for name, front in (("t", tfront), ("j", jfront)):
            d = str(tmp_path / name)
            first = _ready_run(front, queries, ["--devices", "2", "--export-aot", d])
            aot[name] = (first, _ready_run(front, queries, ["--devices", "2", "--preheat", d]))
    finally:
        ctl.close()
    (t_first, t_pre), (j_first, j_pre) = aot["t"], aot["j"]
    assert t_pre[1] == j_pre[1] and t_pre[1].endswith(" aot_hits=1 aot_fallbacks=0")
    assert t_first[1] == j_first[1] and "aot_" not in t_first[1]
    assert t_pre[0] == t_first[0] == j_pre[0] == j_first[0]
    for (got, tstat), (want, jstat) in runs:
        for lines in (got, want):
            for r in lines:  # timings are each package's own; an isolated
                # source traverses no edge and reports no rate
                r["gteps"] = r.get("gteps", 0) > 0
        assert _canon(got) == _canon(want)
        assert [r["devices"] for r in got] == [2, 2, 2]
        for key in ("completed", "devices", "mesh_degraded", "mesh_faults"):
            assert tstat[key] == jstat[key], key
    # The mutate op is ported: the round trip equals JAX's server, line for
    # line but flip_ms (each side's own registry: a compaction replaces the
    # registry's graph).
    g = load_graph(SPEC)
    requests = _mutate_stream(g)
    mut = ["--mutations", "64x32"]
    got, tstat = _run(tfront, None, requests, mut)
    want, jstat = _run(jfront, None, requests, mut)
    assert _no_flip(got) == _no_flip(want)
    by_id = {r["id"]: r for r in got}
    assert [by_id[f"m{i}"]["ok"] for i in range(1, 7)] == [True, True, False, False, False, True]
    assert by_id["m6"]["generation"] == 3 and by_id["m6"]["compacted"] is False
    assert tstat["dynamic"] == jstat["dynamic"]
    assert tstat["dynamic"]["compactions"] == 1
    # Without --mutations the op answers the static service's refusal.
    lines, _ = _run(tfront, regs[1], '{"id": 1, "op": "mutate", "add": [[1, 2]]}\n')
    jlines, _ = _run(jfront, regs[0], '{"id": 1, "op": "mutate", "add": [[1, 2]]}\n')
    assert lines == jlines and lines[0]["ok"] is False


def test_resume_dir_flag_sets_the_resume_spool_as_in_jax(regs, tmp_path):
    """``--resume-dir D`` parses on one device and points newly made resume
    caches at D, in both servers (JAX's parser has always taken it)."""
    from tpu_bfs.resilience import resume as jres

    from tpu_bfs_torch.resilience import resume as tres

    for front, reg, res in ((tfront, regs[1], tres), (jfront, regs[0], jres)):
        spool = tmp_path / res.__name__
        try:
            lines, stat = _run(front, reg, json.dumps({"id": 1, "source": 3}) + "\n",
                               ["--resume-dir", str(spool)])
            assert [r["status"] for r in lines] == ["ok"] and stat["devices"] == 1
            assert res._DEFAULT_DIR == str(spool)
        finally:
            res.set_default_dir(None)


def test_xprof_dir_parses_as_in_jax_and_writes_a_trace_at_shutdown(regs, tmp_path):
    """``--xprof-dir DIR``: both parsers take it; the port's server holds a
    torch.profiler session from start-up to shutdown and writes its Chrome
    trace into DIR when it shuts down, answers unchanged."""
    for front in (tfront, jfront):
        args = front.build_arg_parser().parse_args([SPEC, "--xprof-dir", "d"])
        assert args.xprof_dir == "d"
    queries = "".join(json.dumps({"id": i, "source": s}) + "\n" for i, s in enumerate((0, 3)))
    prof = tmp_path / "xprof"
    lines, _ = _run(tfront, regs[1], queries, ["--xprof-dir", str(prof)])
    plain, _ = _run(tfront, regs[1], queries)
    assert _canon(lines) == _canon(plain)
    events = json.loads((prof / "serve_trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.parametrize("flag", [["--mutations"], ["--mutations", "8x4"], []])
def test_mutations_flag_parses_as_in_jax(flag):
    args = tfront.build_arg_parser().parse_args(["g"] + flag)
    want = {(): (), ("--mutations",): True}.get(tuple(flag), (8, 4))
    assert tfront._dynamic_from_args(args) == want
    for front in (tfront, jfront):
        args = front.build_arg_parser().parse_args([SPEC, "--mutations", "8by4"])
        with pytest.raises(SystemExit, match="DxK"):
            front.run_server(args, stdin=io.StringIO(""), stdout=io.StringIO(),
                             stderr=io.StringIO())


def test_server_subprocess_drains_on_sigterm(tmp_path):
    """``python -m tpu_bfs_torch.serve`` on the CPU: answers, then a
    SIGTERM drains it with a final statsz line and exit code 0."""
    env = subprocess_env(PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_bfs_torch.serve", SPEC, "--lanes", "32",
         "--device", "cpu", "--statsz-interval-s", "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=tmp_path, env=env,
    )
    try:
        for i in range(3):
            proc.stdin.write(json.dumps({"id": i, "source": i}) + "\n")
        proc.stdin.flush()
        got = [json.loads(proc.stdout.readline()) for _ in range(3)]
        assert sorted(r["id"] for r in got) == [0, 1, 2]
        assert all(r["status"] == "ok" for r in got)
        time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    assert "SIGTERM received: draining" in err
    final = [ln for ln in err.splitlines() if ln.startswith("statsz ")][-1]
    assert json.loads(final[len("statsz "):])["completed"] == 3


# --- statsz interval alias and the integrity tier through the server ----------


def _ns(**kw):
    import argparse

    kw.setdefault("statsz_interval_s", None)
    kw.setdefault("statsz_every", None)
    return argparse.Namespace(**kw)


@pytest.mark.parametrize("kw,env,want", [
    ({}, "", 10.0), ({}, "2.5", 2.5), ({"statsz_every": 0.0}, "2.5", 0.0),
    ({"statsz_interval_s": 7.0, "statsz_every": 3.0}, "2.5", 7.0), ({}, "typo", 10.0),
])
def test_statsz_interval_precedence_equals_jax(kw, env, want):
    assert tfront.resolve_statsz_interval(_ns(**kw), env=env) == want
    assert jfront.resolve_statsz_interval(_ns(**kw), env=env) == want


def test_statsz_every_parses_as_in_jax():
    # The reference's own scripts start servers with --statsz-every 0.
    argv = [SPEC, "--statsz-every", "0"]
    targs = tfront.build_arg_parser().parse_args(argv)
    jargs = jfront.build_arg_parser().parse_args(argv)
    assert tfront.resolve_statsz_interval(targs) == jfront.resolve_statsz_interval(jargs) == 0.0


AUDIT_SPEC = "random:n=96,m=480,seed=3,weights=5"
AUDIT_ARGV = [AUDIT_SPEC, "--lanes", "64", "--ladder", "32,64", "--linger-ms", "5",
              "--statsz-every", "0", "--audit-rate", "1", "--audit-structural",
              "--audit-checksum"]
AUDIT_KEYS = ("audits_run", "audit_failures", "audit_errors", "audit_dropped", "quarantines",
              "completed", "errors", "batches", "audit")


def _audited(front, requests, extra=(), stdin=None, stdout=None):
    argv = AUDIT_ARGV + list(extra) + (["--device", "cpu"] if front is tfront else [])
    args = front.build_arg_parser().parse_args(argv)
    out, err = stdout or io.StringIO(), io.StringIO()
    reg = (TRegistry(capacity=8, device="cpu") if front is tfront
           else JRegistry(capacity=8))
    assert front.run_server(args, stdin=stdin or io.StringIO(requests), stdout=out,
                            stderr=err, registry=reg) == 0
    statsz = [ln for ln in err.getvalue().splitlines() if ln.startswith("statsz ")]
    return out, json.loads(statsz[-1][len("statsz "):])


@pytest.mark.chaos
def test_integrity_smoke_acts_equal_jax(tmp_path):
    """scripts/integrity_smoke.py's two acts through both JSONL servers in
    process: a clean fully-audited mixed-kind soak with zero findings, then
    corrupt_result with the flight recorder: the first answer is wrong,
    the rung is quarantined, every later answer is exact, the dump names
    the query. The statsz audit counters are equal."""
    import threading

    from tpu_bfs_torch.integrity.staleness import oracle_bfs

    g = load_graph(AUDIT_SPEC)
    reqs = []
    for s in (0, 3, 5, 7):
        for kind in ("bfs", "sssp", "cc", "khop", "p2p"):
            req = {"id": len(reqs), "source": s, "kind": kind}
            req.update({"khop": {"k": 2}, "p2p": {"target": (s + 7) % g.num_vertices}}.get(
                kind, {}))
            reqs.append(req)
    stream = "".join(json.dumps(r) + "\n" for r in reqs)
    snaps = {}
    for name, front in (("torch", tfront), ("jax", jfront)):
        out, snap = _audited(front, stream)
        lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
        assert len(lines) == len(reqs) and all(r["status"] == "ok" for r in lines)
        for r in lines:
            if reqs[r["id"]]["kind"] == "bfs":
                np.testing.assert_array_equal(
                    tfront.decode_distances(r["distances_npy"]), oracle_bfs(g, r["source"]))
        snaps[name] = snap
    for k in AUDIT_KEYS:
        assert snaps["torch"][k] == snaps["jax"][k], k
    assert snaps["torch"]["audits_run"] > 0
    assert snaps["torch"]["audit_failures"] == snaps["torch"]["quarantines"] == 0

    class Gate:
        """stdin that sends the first query, waits for its answer and the
        audit's quarantine, then sends the rest."""

        def __init__(self, first, rest, answered):
            self.first, self.rest, self.answered = first, rest, answered

        def __iter__(self):
            yield self.first
            assert self.answered.wait(120)
            import time

            time.sleep(2.0)  # detection and quarantine are asynchronous
            yield from self.rest

    class Out(io.StringIO):
        def __init__(self, answered):
            super().__init__()
            self.answered = answered

        def write(self, s):
            n = super().write(s)
            self.answered.set()
            return n

    for name, front in (("torch", tfront), ("jax", jfront)):
        dump = tmp_path / name
        answered = threading.Event()
        first = json.dumps({"id": 0, "source": 0}) + "\n"
        rest = [json.dumps({"id": i, "source": s}) + "\n" for i, s in enumerate((3, 5, 7), 1)]
        out, snap = _audited(front, None, ["--faults", "seed=5:corrupt_result:n=1", "--obs",
                                           f"dump_dir={dump},window=120"],
                             stdin=Gate(first, rest, answered), stdout=Out(answered))
        resp = {r["id"]: r for r in map(json.loads, out.getvalue().splitlines())}
        d0 = tfront.decode_distances(resp[0]["distances_npy"])
        assert not np.array_equal(d0, oracle_bfs(g, 0))
        for i, s in enumerate((3, 5, 7), 1):
            np.testing.assert_array_equal(tfront.decode_distances(resp[i]["distances_npy"]),
                                          oracle_bfs(g, s))
        assert snap["audit_failures"] >= 1 and snap["quarantines"] >= 1
        assert snap["faults"] == {"corrupt_result": 1}
        dumped = "\n".join(p.read_text() for p in sorted(dump.glob("*.jsonl")))
        assert '"corruption"' in dumped and '"query": 0' in dumped.replace('"query":0',
                                                                           '"query": 0')
        snaps[name] = snap
    for k in AUDIT_KEYS:
        assert snaps["torch"][k] == snaps["jax"][k], k
