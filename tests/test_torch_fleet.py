"""The port's fleet supervisor (tpu_bfs_torch/tools/fleet_supervisor.py)
against the JAX package's (scripts/fleet_supervisor.py).

JAX's fleet tests (tests/test_warm_handoff.py) run here on the port's
supervisor with the same stand-in server (a READY line on stderr, echo
responses on stdout), each scenario also driven through JAX's supervisor
where its outcome is deterministic, the two held equal. Then a fleet of
two ``python -m tpu_bfs_torch.serve --device cpu`` replicas on a small
graph, one SIGKILLed while queries are in flight: every query answered
exactly once, equal to the one-shot server's answers, and one restart.
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

import test_warm_handoff as jt
from fleet_supervisor import FleetSupervisor as JFleet

from tpu_bfs_torch.serve import frontend as tfront
from tpu_bfs_torch.serve.registry import EngineRegistry
from tpu_bfs_torch.tools import fleet_supervisor as fleet_mod
from tpu_bfs_torch.tools.fleet_supervisor import FleetSupervisor

from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

pytestmark = pytest.mark.serve

ROOT = Path(__file__).resolve().parents[1]
SPEC = "rmat:scale=8,ef=8,seed=5"
SERVE = ["--lanes", "32", "--ladder", "off", "--linger-ms", "50", "--statsz-interval-s", "0"]


@pytest.fixture(autouse=True)
def _capped_children(monkeypatch):
    """Replicas inherit this environment: the test process's thread cap
    and the checkout on the path."""
    for k, v in subprocess_env(PYTHONPATH=str(ROOT)).items():
        monkeypatch.setenv(k, v)


def _wait(cond, timeout=30.0, msg="condition"):
    jt._wait(cond, timeout=timeout, msg=msg)


def _kill_and_serve(cls):
    responses = []
    fleet = cls(jt.fake_server_argv(), replicas=2, ready_timeout=30.0, term_wait=5.0,
                emit=responses.append, log=lambda m: None).start()
    try:
        for i in range(4):
            fleet.submit({"id": i, "source": i})
        _wait(lambda: len(responses) >= 4, msg="first wave answered")
        victim = fleet._replicas[0]
        victim.proc.kill()
        _wait(lambda: victim.proc.poll() is not None, msg="victim death")
        for i in range(4, 8):
            fleet.submit({"id": i, "source": i})
        _wait(lambda: len(responses) >= 8, msg="second wave answered")
        _wait(lambda: len([r for r in fleet._replicas
                           if r.ready.is_set() and r.alive()]) == 2,
              msg="replacement READY")
        summary = fleet.summary()
    finally:
        fleet.close()
    return sorted(responses, key=lambda r: r["id"]), summary


def test_fleet_serves_and_restarts_dead_replica():
    got, summary = _kill_and_serve(FleetSupervisor)
    want, jsummary = _kill_and_serve(JFleet)
    assert [r["id"] for r in got] == list(range(8))
    assert all(r["status"] == "ok" for r in got)
    assert got == want
    assert summary["restarts"] == jsummary["restarts"] == 1
    assert summary["served"] == jsummary["served"] == 8


def test_fleet_requeues_killed_replicas_in_flight():
    slow_server = jt.FAKE_SERVER.replace(
        'req = json.loads(line)',
        'req = json.loads(line)\n    import time; time.sleep(0.3)',
    )
    responses = []
    fleet = FleetSupervisor(
        [sys.executable, "-u", "-c", slow_server], replicas=2,
        ready_timeout=30.0, term_wait=5.0, restart=False,
        emit=responses.append, log=lambda m: None,
    ).start()
    try:
        for i in range(6):
            fleet.submit({"id": i, "source": i})
        victim = fleet._replicas[0]
        victim.proc.kill()
        _wait(lambda: len(responses) >= 6, timeout=60.0,
              msg="all queries answered after the kill")
        assert fleet.requeues >= 1
        assert fleet.restarts == 0
    finally:
        fleet.close()
    assert sorted(r["id"] for r in responses) == list(range(6))
    assert all(r["status"] == "ok" for r in responses)


def test_fleet_drain_timeout_resolves_pending_with_errors():
    mute_server = jt.FAKE_SERVER.replace(
        "print(json.dumps(",
        "continue  # wedged: never answers\n    print(json.dumps(",
    )
    outcomes = []
    for cls in (FleetSupervisor, JFleet):
        responses = []
        fleet = cls([sys.executable, "-u", "-c", mute_server], replicas=1,
                    ready_timeout=30.0, restart=False,
                    emit=responses.append, log=lambda m: None).start()
        try:
            fleet.submit({"id": 1, "source": 0})
            assert not fleet.wait_drained(0.5)
            n = fleet.fail_pending("drain timeout")
            assert fleet.wait_drained(0.1)
            outcomes.append((n, fleet.summary(), responses))
        finally:
            fleet.close()
    assert outcomes[0] == outcomes[1]
    n, summary, responses = outcomes[0]
    assert n == 1 and summary["failed"] == 1
    assert responses == [{"id": 1, "status": "error", "error": "drain timeout"}]


def test_fleet_refuses_never_ready_binary():
    for cls in (FleetSupervisor, JFleet):
        with pytest.raises(SystemExit, match="not READY"):
            cls([sys.executable, "-c", "import time; time.sleep(60)"],
                replicas=1, ready_timeout=0.5, log=lambda m: None).start()
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        FleetSupervisor(["true"], replicas=0)


def test_fleet_client_id_collisions_across_replicas():
    responses = []
    fleet = FleetSupervisor(
        jt.fake_server_argv(), replicas=2, ready_timeout=30.0,
        emit=responses.append, log=lambda m: None,
    ).start()
    try:
        fleet.submit({"id": "same", "source": 1})
        fleet.submit({"id": "same", "source": 2})
        _wait(lambda: len(responses) == 2, msg="both collided ids answered")
        assert all(r.ready_s is not None and r.ready_s > 0 for r in fleet._replicas)
    finally:
        fleet.close()
    assert [r["id"] for r in responses] == ["same", "same"]
    assert sorted(r["source"] for r in responses) == [1, 2]


def test_fleet_command_line_equals_jax():
    """The module's command line against JAX's script on the same stdin:
    the same responses and the same summary line."""
    stdin = "\n".join([json.dumps({"id": i, "source": i}) for i in range(5)]
                      + ["not json", json.dumps({"source": 9})]) + "\n"
    outs = []
    for argv in ([sys.executable, "-m", "tpu_bfs_torch.tools.fleet_supervisor"],
                 [sys.executable, str(ROOT / "scripts" / "fleet_supervisor.py")]):
        proc = subprocess.run(argv + ["--replicas", "2", "--ready-timeout", "60", "--"]
                              + jt.fake_server_argv(), input=stdin, capture_output=True,
                              text=True, timeout=120, cwd=ROOT,
                              env=subprocess_env(PYTHONPATH=str(ROOT)))
        assert proc.returncode == 0, proc.stderr[-2000:]
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
        outs.append((sorted(json.dumps(r, sort_keys=True) for r in lines[:-1]), lines[-1]))
        assert "fleet READY: 2 replicas serving" in proc.stderr
    assert outs[0] == outs[1]
    summary = outs[0][1]
    assert (summary["served"], summary["restarts"], summary["failed"]) == (6, 0, 0)
    with pytest.raises(SystemExit):
        fleet_mod.main(["--replicas", "1"])  # no server argv


def _answers(lines):
    out = {}
    for r in lines:
        r = dict(r)
        for key in ("latency_ms", "batch_lanes"):  # the batch it rode in, not the answer
            r.pop(key, None)
        out[r["id"]] = r
    return out


def test_fleet_of_port_servers_answers_like_one_shot(tmp_path, monkeypatch):
    queries = [{"id": f"q{i}", "source": (37 * i) % 256} for i in range(16)]
    args = tfront.build_arg_parser().parse_args([SPEC, *SERVE, "--device", "cpu"])
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(q) + "\n" for q in queries))
    assert tfront.run_server(args, stdin=stdin, stdout=out, stderr=io.StringIO(),
                             registry=EngineRegistry(capacity=2, device="cpu")) == 0
    want = _answers(json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip())
    assert len(want) == 16 and all(r["status"] == "ok" for r in want.values())

    monkeypatch.chdir(tmp_path)
    responses = []
    fleet = FleetSupervisor(
        [sys.executable, "-m", "tpu_bfs_torch.serve", SPEC, *SERVE, "--device", "cpu"],
        replicas=2, ready_timeout=120.0, term_wait=10.0,
        emit=responses.append, log=lambda m: None,
    )
    try:
        fleet.start()
        for q in queries[:8]:
            fleet.submit(q)
        victim = fleet._replicas[0]
        victim.proc.kill()  # with queries in flight on it
        for q in queries[8:]:
            fleet.submit(q)
        assert fleet.wait_drained(120.0)
        _wait(lambda: len([r for r in fleet._replicas
                           if r.ready.is_set() and r.alive()]) == 2,
              timeout=120.0, msg="replacement READY")
        summary = fleet.summary()
        replicas = list(fleet._replicas)
    finally:
        fleet.close()
    got = _answers(responses)
    assert len(responses) == 16 and got == want
    assert summary["restarts"] == 1 and summary["served"] == 16 and summary["failed"] == 0
    assert victim not in replicas and all(r.ready_s > 0 for r in replicas)
    # close() ends them, escalating to SIGKILL, which lands a moment later.
    _wait(lambda: not any(r.alive() for r in replicas), timeout=15.0, msg="replicas exit")
