"""Warm engine handoff: replace a serving process without ever serving
from a cold one, the port of ``scripts/warm_handoff.py``.

Starts a SUCCESSOR server (normally ``python -m tpu_bfs_torch.serve ...
--preheat DIR`` over a store the old server populated with
``--export-aot DIR``), waits for its READY line — every ladder rung
warmed, artifacts adopted — and only THEN SIGTERMs the old server, whose
graceful drain flushes in-flight batches and resolves queued queries. If
the successor dies or never reports ready, the old server is left
untouched and the handoff exits non-zero: the fleet keeps serving from the
warm process.

Usage::

    python -m tpu_bfs_torch.tools.warm_handoff --old-pid PID \
        [--ready-timeout S] [--term-wait S] -- <successor argv...>

``--old-pid 0`` skips the SIGTERM (first bring-up: just gate on READY).
The handoff's stdin/stdout pass through to the successor, so a fleet
manager (or the preheat smoke) can pipe traffic straight into the new
process. Prints one JSON line (value = seconds to ready) on success.
"""

import argparse
import errno
import json
import os
import signal
import subprocess
import sys
import threading
import time

READY_MARKER = "# READY"


def log(msg: str) -> None:
    print(f"[warm-handoff] {msg}", file=sys.stderr, flush=True)


def pid_alive(pid: int) -> bool:
    # A drained server whose parent hasn't reaped it yet is a zombie:
    # os.kill(pid, 0) still succeeds there, so consult the process state
    # where /proc exists (the smoke holds the old server as an unreaped
    # child for exactly this window).
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state != "Z"
    except (OSError, IndexError):
        pass
    try:
        os.kill(pid, 0)
    except OSError as exc:
        return exc.errno == errno.EPERM
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="drain the old server only after the new one is ready"
    )
    ap.add_argument("--old-pid", type=int, required=True,
                    help="PID of the serving process to drain once the "
                    "successor is ready (0 = none: first bring-up)")
    ap.add_argument("--ready-timeout", type=float, default=600.0,
                    help="seconds to wait for the successor's READY line "
                    "before giving up (default 600)")
    ap.add_argument("--term-wait", type=float, default=60.0,
                    help="seconds to wait for the old server to exit "
                    "after SIGTERM (0 = don't wait; default 60)")
    ap.add_argument("successor", nargs=argparse.REMAINDER,
                    help="successor server argv (prefix with --)")
    args = ap.parse_args(argv)
    succ = args.successor
    if succ and succ[0] == "--":
        succ = succ[1:]
    if not succ:
        ap.error("no successor argv given (append: -- <server argv...>)")
    if args.old_pid and not pid_alive(args.old_pid):
        log(f"old pid {args.old_pid} is not alive; treating as first "
            f"bring-up")
        args.old_pid = 0

    t0 = time.perf_counter()
    log(f"starting successor: {' '.join(succ)}")
    # stderr is piped so the READY line can be watched; every line is
    # forwarded, so the successor's logs still reach the operator.
    proc = subprocess.Popen(succ, stderr=subprocess.PIPE, text=True)

    ready = threading.Event()

    def watch_stderr() -> None:
        for line in proc.stderr:
            sys.stderr.write(line)
            sys.stderr.flush()
            if READY_MARKER in line:
                ready.set()

    watcher = threading.Thread(target=watch_stderr, daemon=True)
    watcher.start()

    deadline = time.monotonic() + args.ready_timeout
    while not ready.is_set():
        if proc.poll() is not None:
            log(f"successor exited rc={proc.returncode} before READY; "
                f"old server untouched")
            return 1
        if time.monotonic() >= deadline:
            log(f"successor not READY within {args.ready_timeout:.0f}s; "
                f"terminating it — old server untouched")
            proc.terminate()
            return 1
        ready.wait(0.2)
    ready_s = time.perf_counter() - t0
    log(f"successor READY in {ready_s:.2f}s")

    drained = None
    if args.old_pid:
        log(f"SIGTERM -> old server pid {args.old_pid} (graceful drain)")
        try:
            os.kill(args.old_pid, signal.SIGTERM)
        except OSError as exc:
            log(f"SIGTERM failed ({exc!r})")
            return 1
        if args.term_wait > 0:
            stop = time.monotonic() + args.term_wait
            while pid_alive(args.old_pid) and time.monotonic() < stop:
                time.sleep(0.2)
            drained = not pid_alive(args.old_pid)
            log("old server exited" if drained
                else f"old server still alive after {args.term_wait:.0f}s "
                     f"(drain may still be flushing)")

    # Hand the foreground to the successor: the handoff lives until the
    # new server exits, so pipelines (smoke, systemd-style supervisors)
    # see one continuous process tree. The handoff JSON is printed LAST,
    # after the successor's protocol stream has closed, so a stage
    # tail-line reader gets it cleanly.
    rc = proc.wait()
    print(json.dumps({
        "metric": "warm handoff: successor ready-to-serve seconds "
                  "(old server drained only after)",
        "value": round(ready_s, 3),
        "unit": "s",
        "old_pid": args.old_pid,
        "old_drained": drained,
        "successor_rc": rc,
    }), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
