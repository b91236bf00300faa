"""The port CLI's operations surface against the JAX CLI: ``--faults``,
``--obs``, ``--trace-out``, the ``trace`` and ``recovery`` lines of
``--stats``, and ``utils/recovery.advance_with_recovery`` under them.

Both CLIs run in process on the same argv; the lines compared are those
that carry no timing. On a mesh the port's ranks are spawned gloo
processes and JAX's run on its virtual devices: the ``trace`` line of a
single-source mesh run (which the port did not print before) and the
``recovery`` line under one fault spec must be equal.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from tpu_bfs import cli as jcli
from tpu_bfs import faults as jfaults
from tpu_bfs import obs as jobs
from tpu_bfs.utils.recovery import COUNTERS as JCOUNTERS
from tpu_bfs.utils.recovery import advance_with_recovery as jadvance

from tpu_bfs_torch import cli
from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch import obs as tobs
from tpu_bfs_torch.algorithms.bfs import BfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.utils.recovery import COUNTERS as TCOUNTERS
from tpu_bfs_torch.utils.recovery import advance_with_recovery
from tpu_bfs_torch.utils.stats import recovery_stats_line

from torch_threads import cap_torch_threads

cap_torch_threads()

GRAPH = "rmat:scale=9,ef=8,seed=2"
HUB = int(np.argmax(tgen.rmat_graph(9, 8, seed=2).degrees))  # a source with a deep BFS
MS = ["--multi-source", "1,2,200,77"]


@pytest.fixture(autouse=True)
def _fresh():
    for f, o, c in ((jfaults, jobs, JCOUNTERS), (tfaults, tobs, TCOUNTERS)):
        f.disarm()
        o.disarm()
        c.reset()
    yield
    for f, o in ((jfaults, jobs), (tfaults, tobs)):
        f.disarm()
        o.disarm()


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _both(argv, tmp_path=None, files=()):
    """(port lines, JAX lines) of one argv; ``files`` names argv entries
    that are per-package paths under ``tmp_path``."""
    out = []
    for main, tag, extra in ((cli.main, "t", ["--device", "cpu"]), (jcli.main, "j", [])):
        a = [str(tmp_path / f"{tag}_{x}") if x in files else x for x in argv]
        for f, c in ((jfaults, JCOUNTERS), (tfaults, TCOUNTERS)):
            f.disarm()
            c.reset()
        out.append(_run(main, a + extra))
    return out


def _stable(lines, *paths):
    """The lines without timings, the package tag and the per-package paths."""
    keep = ("source ", "Reached ", "Output", "checkpoint", "{", "trace ", "recovery",
            "[recovery]", "resumed ")
    out = []
    for ln in lines:
        if ln.startswith(keep):
            for p in paths:
                ln = ln.replace(str(p), "PATH")
            out.append(ln.replace("tpu_bfs_torch", "tpu_bfs"))
    return out


def _tagged(lines, prefix):
    return [ln for ln in lines if ln.startswith(prefix)]


@pytest.mark.parametrize("flags", [
    ["--devices", "2"],
    ["--devices", "2", "--exchange", "sparse", "--sparse-delta", "--sparse-predict"],
    ["--devices", "2", "--backend", "dopt", "--exchange", "allreduce"],
    ["--mesh", "1x2", "--exchange", "sparse"],
    ["--mesh", "2x2"],
])
def test_single_source_mesh_prints_the_jax_trace_line(flags):
    got, want = _both(["0", GRAPH, "--stats"] + flags)
    assert _stable(got) == _stable(want)
    line = _tagged(got, "trace ")
    assert len(line) == 1 and json.loads(line[0][6:])["levels"] >= 4


@pytest.mark.parametrize("flags", [
    ["--engine", "hybrid"], ["--engine", "wide", "--pull-gate"], ["--engine", "packed"],
    ["--engine", "wide", "--devices", "2", "--exchange", "sparse"],
    # The hybrid's trace says "pull+adaptive-push"; the wide engine keeps
    # its caps private and says "pull", in both packages.
    ["--engine", "hybrid", "--adaptive-push", "64,16"],
    ["--engine", "wide", "--adaptive-push", "64,16"],
])
def test_armed_multi_source_trace_line_equals_jax(flags):
    got, want = _both(["3", GRAPH, "--stats", "--obs"] + MS + flags)
    assert _stable(got) == _stable(want)
    # The 512-lane packed engine records no trace in either package.
    assert len(_tagged(got, "trace ")) == (0 if "packed" in flags else 1)
    # Disarmed, a single-device batch prints none.
    tobs.disarm()
    plain = _run(cli.main, ["3", GRAPH, "--stats", "--device", "cpu"] + MS + flags)
    assert _tagged(plain, "trace ") == [] or "--devices" in flags


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("spec", ["seed=7:transient@advance:n=1,corrupt_ckpt:n=1",
                                  "seed=3:transient@advance:n=2:skip=1"])
def test_faulted_checkpointed_run_equals_jax(spec, multi, tmp_path):
    argv = ["3", GRAPH, "--stats", "--ckpt", "ck.npz", "--ckpt-every", "2", "--faults", spec]
    if multi:
        argv += MS + ["--engine", "wide", "--lanes", "32"]
    got, want = _both(argv, tmp_path, files=("ck.npz",))
    paths = (tmp_path / "t_ck.npz", tmp_path / "j_ck.npz")
    assert _stable(got, *paths) == _stable(want, *paths)
    rec = json.loads(_tagged(got, '{"recovery"')[0])["recovery"]
    assert rec["transient_retries"] == rec["engine_rebuilds"] == spec.count("transient") * (
        2 if "n=2" in spec else 1)
    assert rec["faults_injected"] >= 1 and "Output OK" in got
    clean = _run(cli.main, ["3", GRAPH, "--stats", "--device", "cpu"] + (MS if multi else []))
    assert _tagged(clean, "source ", ) == _tagged(got, "source ")
    assert _tagged(clean, '{"recovery"') == []


def test_faults_on_a_mesh_fire_as_in_one_process(tmp_path):
    # Every rank arms the schedule and fails at the same visit, so the
    # ranks rebuild together and rank 0's counters equal JAX's.
    argv = ["3", GRAPH, "--stats", "--devices", "2", "--ckpt", "ck.npz", "--ckpt-every", "2",
            "--faults", "seed=7:transient@advance:n=1"]
    got, want = _both(argv, tmp_path, files=("ck.npz",))
    paths = (tmp_path / "t_ck.npz", tmp_path / "j_ck.npz")
    assert _stable(got, *paths) == _stable(want, *paths)
    assert len(_tagged(got, '{"recovery"')) == 1 and len(_tagged(got, "[recovery]")) == 1


def _level_tracks(path):
    doc = json.load(open(path))
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["tid"] >= 1000}
    rows = [(names[e["tid"]], e["args"]) for e in doc["traceEvents"]
            if e.get("cat") == "engine.level"]
    spans = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "cli"}
    return rows, spans


@pytest.mark.parametrize("argv", [
    ["3", GRAPH, "--engine", "hybrid", "--pull-gate"] + MS,
    ["0", GRAPH, "--devices", "2", "--exchange", "sparse"],
])
def test_trace_out_level_tracks_equal_jax(argv, tmp_path):
    got, want = _both(argv + ["--stats", "--trace-out", "t.json"], tmp_path, files=("t.json",))
    trows, tspans = _level_tracks(tmp_path / "t_t.json")
    jrows, jspans = _level_tracks(tmp_path / "j_t.json")
    assert trows == jrows and trows
    assert {"run", "graph_load", "engine_build"} <= tspans and tspans == jspans
    assert _tagged(got, "trace ") == _tagged(want, "trace ")


# --- advance_with_recovery ------------------------------------------------------


def _flaky(g, fail_times, msg="INTERNAL: during context: remote_compile: read body closed"):
    def make():
        eng = BfsEngine(g, device="cpu")
        real = eng.advance

        def advance(ckpt, levels=None):
            if fail_times:
                fail_times.pop()
                raise RuntimeError(msg)
            return real(ckpt, levels)

        eng.advance = advance
        return eng

    return make


def test_advance_with_recovery_rebuilds_and_resumes():
    g = tgen.rmat_graph(9, 8, seed=2)
    base = BfsEngine(g, device="cpu").run(42)
    make = _flaky(g, [1])
    msgs = []
    eng, st, restarts = advance_with_recovery(make, make().start(42), levels_per_chunk=1,
                                              log=msgs.append)
    assert restarts == 1 and st.done and any("rebuilding engine" in m for m in msgs)
    res = eng.finish(st)
    np.testing.assert_array_equal(res.distance, base.distance)
    np.testing.assert_array_equal(res.parent, base.parent)
    assert json.loads(recovery_stats_line())["recovery"]["engine_rebuilds"] == 1


def test_advance_with_recovery_budget_and_classifier():
    g = tgen.rmat_graph(8, 8, seed=2)
    make = _flaky(g, [1] * 10)
    with pytest.raises(RuntimeError, match="remote_compile"):
        advance_with_recovery(make, make().start(0), max_restarts=2)
    assert TCOUNTERS.transient_retries == 2
    bad = _flaky(g, [1], msg="checkpoint has 7 vertices, graph has 500")
    with pytest.raises(RuntimeError, match="checkpoint has 7"):
        advance_with_recovery(bad, bad().start(0))
    eng = BfsEngine(g, device="cpu")
    hub = int(np.argmax(g.degrees))
    _, st, restarts = advance_with_recovery(lambda: eng, eng.start(hub), engine=eng,
                                            levels_per_chunk=1, max_level=2)
    assert st.level == 2 and restarts == 0


def test_advance_site_and_recovery_line_equal_jax():
    """One spec through both packages' advance_with_recovery: the same
    visits fire, the same counters and the same recovery line."""
    from tpu_bfs.algorithms.bfs import BfsEngine as JBfsEngine
    from tpu_bfs.graph import generate as jgen

    lines = []
    for adv, faults, counters, eng in (
            (advance_with_recovery, tfaults, TCOUNTERS,
             lambda: BfsEngine(tgen.rmat_graph(9, 8, seed=2), device="cpu")),
            (jadvance, jfaults, JCOUNTERS, lambda: JBfsEngine(jgen.rmat_graph(9, 8, seed=2)))):
        faults.arm_from_spec("seed=9:transient@advance:n=2:skip=1")
        e = eng()
        e, st, restarts = adv(eng, e.start(HUB), engine=e, levels_per_chunk=1,
                              log=lambda m: None, max_restarts=3)
        lines.append((restarts, st.level, counters.as_dict(), faults.ACTIVE.counts()))
        faults.disarm()
    assert lines[0] == lines[1] and lines[0][0] == 2


@pytest.mark.parametrize("argv", [
    ["3", GRAPH, "--engine", "hybrid", "--repeat", "2"] + MS,
    ["3", GRAPH, "--backend", "dopt"],
])
def test_profile_dir_writes_a_trace_each_timed_run(argv, tmp_path):
    """``--profile-dir``: one parseable torch.profiler Chrome trace a timed
    run, holding the run's operators (CPU activity off the card)."""
    lines = _run(cli.main, argv + ["--device", "cpu", "--profile-dir", str(tmp_path)])
    assert "Output OK" in lines
    reps = 2 if "--repeat" in argv else 1
    files = sorted(tmp_path.glob("*.json"))
    assert [f.name for f in files] == [f"trace_rep{i}.json" for i in range(reps)]
    for f in files:
        events = json.loads(f.read_text())["traceEvents"]
        assert any(e.get("cat") == "cpu_op" for e in events)


def test_profile_dir_refusal_with_checkpoints_equals_jax(tmp_path, capsys):
    msgs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit):
            main(["0", GRAPH, "--ckpt", str(tmp_path / "c.npz"), "--profile-dir",
                  str(tmp_path)] + extra)
        msgs.append(capsys.readouterr().err.splitlines()[-1].split("error: ")[1])
    assert msgs[0] == msgs[1] == "--repeat/--profile-dir do not apply to checkpointed runs"
