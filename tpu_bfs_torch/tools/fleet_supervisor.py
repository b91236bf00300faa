"""Supervised serve fleet: N replicas, health-gated restart, client-side
requeue; the port of ``scripts/fleet_supervisor.py``, grown from
``tools/warm_handoff.py``.

The warm handoff replaces ONE server with ONE successor, gated on the
successor's READY line. A fleet needs the standing version of that
guarantee: N replicas serving concurrently, each watched for liveness
(READY + heartbeat — any stderr output, which includes the periodic
statsz line, counts), a failing replica SIGTERM-drained (the server's
graceful drain flushes its in-flight batches) and its UNANSWERED
in-flight queries requeued onto a sibling, and a replacement spawned
that only takes traffic after ITS READY line. With every replica
started ``--preheat DIR`` the replacement adopts its programs from the
store instead of building them.

Usage::

    python -m tpu_bfs_torch.tools.fleet_supervisor --replicas 2 \
        [--ready-timeout S] [--term-wait S] [--heartbeat-timeout S] \
        -- python -m tpu_bfs_torch.serve <graph> [server flags...]

The supervisor reads JSONL requests on ITS stdin, fans them out
round-robin over READY replicas (wrapping each request with an internal
id so client ids can collide freely across replicas), fans responses
back in on stdout with the client's original id restored, and prints a
final JSON summary line (restarts, requeues, served).
Exactly-once emission: the internal-id map is the gate — a dying
replica's late answer and the sibling's requeued answer can both
arrive, but only the first one out of the map is emitted.
"""

from __future__ import annotations

import argparse
import itertools
import json
import signal
import subprocess
import sys
import threading
import time

from tpu_bfs_torch.tools.warm_handoff import READY_MARKER, pid_alive


def _log(msg: str) -> None:
    print(f"[fleet] {msg}", file=sys.stderr, flush=True)


class Replica:
    """One supervised server process: spawned, READY-gated, watched."""

    def __init__(self, idx: int, argv, *, on_response, on_exit, log=_log):
        self.idx = idx
        self.argv = list(argv)
        self._log = log
        self._on_response = on_response
        self._on_exit = on_exit
        self.ready = threading.Event()
        self.spawned_at = time.monotonic()
        self.ready_s = None  # seconds from spawn to the READY line
        self.last_heartbeat = time.monotonic()  # any stderr line refreshes
        self.draining = False
        self._lock = threading.Lock()
        self.proc = subprocess.Popen(
            self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        log(f"replica {idx}: spawned pid {self.proc.pid}")
        threading.Thread(target=self._watch_stdout,
                         name=f"fleet-out-{idx}", daemon=True).start()
        threading.Thread(target=self._watch_stderr,
                         name=f"fleet-err-{idx}", daemon=True).start()

    # --- watchers ---------------------------------------------------------

    def _watch_stdout(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                resp = json.loads(line)
            except json.JSONDecodeError:
                self._log(f"replica {self.idx}: non-JSON stdout "
                          f"line dropped: {line[:120]}")
                continue
            self._on_response(self, resp)
        self._on_exit(self)

    def _watch_stderr(self) -> None:
        for line in self.proc.stderr:
            self.last_heartbeat = time.monotonic()
            sys.stderr.write(f"[r{self.idx}] {line}")
            sys.stderr.flush()
            if READY_MARKER in line and not self.ready.is_set():
                self.ready_s = time.monotonic() - self.spawned_at
                self.ready.set()

    # --- control ----------------------------------------------------------

    def alive(self) -> bool:
        return self.proc.poll() is None and pid_alive(self.proc.pid)

    def send(self, wire_req: dict) -> bool:
        try:
            with self._lock:
                self.proc.stdin.write(json.dumps(wire_req) + "\n")
                self.proc.stdin.flush()
            return True
        except (OSError, ValueError):
            return False  # pipe dead; caller requeues

    def drain(self, term_wait: float) -> None:
        """SIGTERM the replica (graceful drain: in-flight batches flush
        and their responses still arrive on stdout) and wait for exit;
        escalate to SIGKILL past ``term_wait``."""
        self.draining = True
        if not self.alive():
            return
        self._log(f"replica {self.idx}: SIGTERM (graceful drain)")
        try:
            self.proc.send_signal(signal.SIGTERM)
        except OSError:
            return
        deadline = time.monotonic() + max(term_wait, 0.1)
        while self.alive() and time.monotonic() < deadline:
            time.sleep(0.1)
        if self.alive():
            self._log(f"replica {self.idx}: drain timed out; SIGKILL")
            self.proc.kill()

    def close_stdin(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass


class FleetSupervisor:
    """The fan-out/fan-in frontend over N supervised replicas."""

    def __init__(self, server_argv, *, replicas: int = 2,
                 ready_timeout: float = 600.0, term_wait: float = 30.0,
                 heartbeat_timeout: float = 0.0, restart: bool = True,
                 emit=None, log=_log):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.server_argv = list(server_argv)
        self.n = replicas
        self.ready_timeout = ready_timeout
        self.term_wait = term_wait
        self.heartbeat_timeout = heartbeat_timeout
        self.restart = restart
        self._emit = emit or self._emit_stdout
        self._log = log
        self._lock = threading.Lock()
        self._replicas: list = []  # guarded-by: _lock
        self._pending: dict = {}  # guarded-by: _lock — wire id -> entry
        self._seq = itertools.count(1)
        self._rr = itertools.count()
        self._drained = threading.Condition(self._lock)
        self._closing = False
        self.restarts = 0
        self.requeues = 0
        self.served = 0
        self.failed = 0  # explicit error responses emitted by the fleet

    @staticmethod
    def _emit_stdout(resp: dict) -> None:
        sys.stdout.write(json.dumps(resp) + "\n")
        sys.stdout.flush()

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        for i in range(self.n):
            self._spawn(i)
        deadline = time.monotonic() + self.ready_timeout
        # Bring-up is itself health-gated: a replica dying BEFORE its
        # READY line must not park the fleet for the whole timeout —
        # its death is surfaced immediately (the watcher's _on_exit may
        # already have spawned the replacement, which gets the same
        # deadline).
        while True:
            with self._lock:
                reps = list(self._replicas)
            pending = [r for r in reps if not r.ready.is_set()]
            if len(reps) >= self.n and not pending:
                break
            if time.monotonic() >= deadline:
                who = [r.idx for r in pending] or "all"
                raise SystemExit(
                    f"replica(s) {who} not READY within "
                    f"{self.ready_timeout:.0f}s"
                )
            dead = [r for r in pending if not r.alive()]
            if dead and not self.restart:
                raise SystemExit(
                    f"replica {dead[0].idx} died (rc="
                    f"{dead[0].proc.poll()}) before READY"
                )
            time.sleep(0.1)
        self._log(f"fleet READY: {self.n} replicas serving")
        if self.heartbeat_timeout > 0:
            threading.Thread(target=self._health_loop,
                             name="fleet-health", daemon=True).start()
        return self

    def _spawn(self, idx: int) -> Replica:
        rep = Replica(idx, self.server_argv, on_response=self._on_response,
                      on_exit=self._on_exit, log=self._log)
        with self._lock:
            self._replicas.append(rep)
        return rep

    # --- routing ----------------------------------------------------------

    def _pick(self) -> Replica | None:
        """Round-robin over READY, live, non-draining replicas; waits up
        to ready_timeout for one (a replacement may be preheating)."""
        deadline = time.monotonic() + self.ready_timeout
        while time.monotonic() < deadline:
            with self._lock:
                live = [r for r in self._replicas
                        if r.ready.is_set() and not r.draining and r.alive()]
            if live:
                return live[next(self._rr) % len(live)]
            time.sleep(0.1)
        return None

    def submit(self, req: dict) -> None:
        """Wrap with an internal wire id and route; requeues on a dead
        pipe until a replica accepts (or none is left)."""
        wire_id = f"f{next(self._seq)}"
        entry = {"req": dict(req), "has_id": "id" in req,
                 "client_id": req.get("id")}
        with self._lock:
            self._pending[wire_id] = entry
        self._route(wire_id, entry)

    def _route(self, wire_id: str, entry: dict) -> None:
        wire_req = dict(entry["req"])
        wire_req["id"] = wire_id
        while True:
            rep = self._pick()
            if rep is None:
                with self._lock:
                    self._pending.pop(wire_id, None)
                    self.failed += 1
                resp = {"id": entry["client_id"], "status": "error",
                        "error": "no live replica to serve the query"}
                self._emit(resp)
                return
            if rep.send(wire_req):
                entry["replica"] = rep.idx
                return
            self._log(f"replica {rep.idx}: dead pipe on send; rerouting")

    # --- fan-in + failure handling ----------------------------------------

    def _on_response(self, rep: Replica, resp: dict) -> None:
        wire_id = resp.get("id")
        with self._lock:
            entry = self._pending.pop(wire_id, None)
            if entry is not None:
                self.served += 1
            if not self._pending:
                self._drained.notify_all()
        if entry is None:
            # A late answer from a drained replica whose query was
            # already requeued and answered elsewhere — exactly-once.
            return
        if entry["has_id"] or entry["client_id"] is not None:
            resp["id"] = entry["client_id"]
        else:
            resp.pop("id", None)
        self._emit(resp)

    def _on_exit(self, rep: Replica) -> None:
        rc = rep.proc.poll()
        self._log(f"replica {rep.idx}: exited rc={rc}")
        with self._lock:
            if rep in self._replicas:
                self._replicas.remove(rep)
            orphans = [
                (wid, e) for wid, e in self._pending.items()
                if e.get("replica") == rep.idx
            ]
            closing = self._closing
        if orphans and not closing:
            self._log(f"replica {rep.idx}: requeueing "
                      f"{len(orphans)} unanswered in-flight queries")
            self.requeues += len(orphans)
            for wid, e in orphans:
                e.pop("replica", None)
                self._route(wid, e)
        if not closing and self.restart and not rep.draining:
            # Health-gated restart: the replacement joins the routing
            # set only once its own READY line lands (_pick gates on
            # ready), so a crash-looping binary cannot take traffic.
            self._log(f"replica {rep.idx}: spawning replacement")
            self.restarts += 1
            self._spawn(rep.idx)

    def _health_loop(self) -> None:
        while True:
            time.sleep(min(self.heartbeat_timeout / 2, 5.0))
            with self._lock:
                if self._closing:
                    return
                reps = list(self._replicas)
            now = time.monotonic()
            for rep in reps:
                if (rep.ready.is_set() and not rep.draining and rep.alive()
                        and now - rep.last_heartbeat
                        > self.heartbeat_timeout):
                    self._log(
                        f"replica {rep.idx}: no heartbeat for "
                        f"{now - rep.last_heartbeat:.0f}s — draining it"
                    )
                    # The drain triggers _on_exit, which requeues its
                    # in-flight queries and spawns the replacement.
                    threading.Thread(
                        target=rep.drain, args=(self.term_wait,),
                        name=f"fleet-drain-{rep.idx}", daemon=True,
                    ).start()

    # --- shutdown ---------------------------------------------------------

    def wait_drained(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._drained.wait(min(remaining, 0.2))
        return True

    def fail_pending(self, reason: str) -> int:
        """Resolve every still-pending query with an EXPLICIT error
        response (the never-silent-drops bar: a wedged replica must not
        turn into clients waiting forever). Exactly-once holds — a late
        real answer finds its entry already popped and is discarded."""
        with self._lock:
            stranded = list(self._pending.items())
            self._pending.clear()
            self.failed += len(stranded)
            self._drained.notify_all()
        for _wid, entry in stranded:
            self._emit({"id": entry["client_id"], "status": "error",
                        "error": reason})
        return len(stranded)

    def close(self) -> None:
        with self._lock:
            self._closing = True
            reps = list(self._replicas)
        for rep in reps:
            rep.close_stdin()  # EOF: the server drains and exits
        deadline = time.monotonic() + self.term_wait
        for rep in reps:
            while rep.alive() and time.monotonic() < deadline:
                time.sleep(0.1)
            if rep.alive():
                rep.drain(1.0)

    def summary(self) -> dict:
        return {
            "replicas": self.n,
            "served": self.served,
            "restarts": self.restarts,
            "requeues": self.requeues,
            "failed": self.failed,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="supervise N serve replicas: READY-gated spawn, "
        "heartbeat watch, SIGTERM drain + requeue on failure"
    )
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--ready-timeout", type=float, default=600.0,
                    help="seconds to wait for each replica's READY line "
                    "(spawn and replacement alike; default 600)")
    ap.add_argument("--term-wait", type=float, default=30.0,
                    help="graceful-drain window before SIGKILL "
                    "(default 30)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="drain a replica silent on stderr for this many "
                    "seconds (run the servers with a short "
                    "--statsz-interval-s); 0 disables (default)")
    ap.add_argument("--no-restart", action="store_true",
                    help="do not spawn replacements for dead replicas")
    ap.add_argument("server", nargs=argparse.REMAINDER,
                    help="server argv (prefix with --)")
    args = ap.parse_args(argv)
    server = args.server
    if server and server[0] == "--":
        server = server[1:]
    if not server:
        ap.error("no server argv given (append: -- <server argv...>)")

    fleet = FleetSupervisor(
        server, replicas=args.replicas, ready_timeout=args.ready_timeout,
        term_wait=args.term_wait, heartbeat_timeout=args.heartbeat_timeout,
        restart=not args.no_restart,
    ).start()
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if not isinstance(req, dict):
                    raise TypeError("request must be a JSON object")
            except Exception as exc:  # noqa: BLE001 — answer, keep reading
                fleet._emit_stdout({
                    "id": None, "status": "error",
                    "error": f"bad request: {exc!r}",
                })
                continue
            fleet.submit(req)
        if not fleet.wait_drained(args.ready_timeout):
            n = fleet.fail_pending(
                "fleet drain timeout: the serving replica never answered"
            )
            _log(f"drain timeout: {n} queries resolved with explicit "
                 f"errors (no silent drops)")
    finally:
        fleet.close()
    print(json.dumps({
        "metric": "fleet supervisor (replicas served with health-gated "
                  "restart + requeue)",
        "value": fleet.served,
        "unit": "queries",
        **fleet.summary(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
