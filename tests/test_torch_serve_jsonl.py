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
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_bfs.serve import EngineRegistry as JRegistry
from tpu_bfs.serve import frontend as jfront

from tpu_bfs_torch.cli import load_graph
from tpu_bfs_torch.reference import bfs_scipy
from tpu_bfs_torch.serve import EngineRegistry as TRegistry
from tpu_bfs_torch.serve import frontend as tfront

pytestmark = pytest.mark.serve

ROOT = Path(__file__).resolve().parents[1]
SPEC = "rmat:scale=8,ef=8,seed=5"
COMMON = [SPEC, "--lanes", "32", "--ladder", "off", "--linger-ms", "300",
          "--statsz-interval-s", "0"]


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


def test_jsonl_refuses_unported_flags_and_ops(regs):
    for flag in (["--devices", "2"], ["--audit-rate", "0.1"], ["--mutations"],
                 ["--preheat", "d"], ["--export-aot", "d"], ["--engine", "dist2d"]):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            _run(tfront, regs[1], "", flag)
    lines, _ = _run(tfront, regs[1], '{"id": 1, "op": "mutate", "add": [[1, 2]]}\n')
    assert lines == [{"id": 1, "op": "mutate", "ok": False, "error":
                      "NotImplementedError: edge updates wait for ROADMAP Queue 1 "
                      "item 4 (graph/dynamic.py, dynamic graphs)"}]


def test_server_subprocess_drains_on_sigterm(tmp_path):
    """``python -m tpu_bfs_torch.serve`` on the CPU: answers, then a
    SIGTERM drains it with a final statsz line and exit code 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
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
