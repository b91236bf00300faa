"""The span/event ring buffer and the flight recorder.

Stdlib-only at import time (the same constraint :mod:`tpu_bfs_torch.faults`
keeps): arming telemetry must not drag torch or numpy into processes that
only wanted the guard. One lock serializes writers — scheduler thread,
extraction worker, client threads, engine dispatch — which is fine
because every record is one dict append at human-noise rates next to a
device dispatch.

Record shape (one dict per event, the JSONL/Perfetto exporters consume
it directly)::

    {"seq": int,            # process-wide monotonic ordinal
     "t": float,            # time.monotonic() at record time
     "ph": "i"|"b"|"e",     # instant | span begin | span end
     "name": str,           # e.g. "query", "dispatch", "fault_injected"
     "cat": str,            # e.g. "serve.query", "serve.batch", "engine"
     "id": str|None,        # span correlation id ("q7", "b3", ...)
     "tid": str,            # recording thread's name
     "args": dict}          # site context (query/batch/width/attempt/...)

Span ids are caller-chosen strings so one logical span can cross
threads (a query is admitted on a client thread and resolved on the
extraction worker); ``begin``/``end`` pairs match on (cat, id, name).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 65536
DEFAULT_WINDOW_S = 30.0
DEFAULT_MAX_DUMPS = 16


class Recorder:
    """Thread-safe bounded event recorder with flight-dump support.

    ``capacity`` bounds the ring (oldest events drop first);
    ``window_s`` is how far back a flight dump reaches; ``dump_dir`` is
    where dumps land (created on first dump); ``max_dumps`` bounds how
    many dump files one process may write (a chaos soak tripping the
    watchdog per batch must not fill the disk); ``now`` is injectable
    for tests."""

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 window_s: float = DEFAULT_WINDOW_S,
                 dump_dir: str = ".", max_dumps: int = DEFAULT_MAX_DUMPS,
                 now=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._now = now
        self.t0 = now()
        self.window_s = float(window_s)
        self.dump_dir = dump_dir
        self.max_dumps = int(max_dumps)
        self.capacity = int(capacity)  # immutable; lock-free reads OK
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)  # guarded-by: _lock
        self._seq = itertools.count(1)  # itertools.count is GIL-atomic
        self.dropped = 0  # guarded-by: _lock — events pushed out of the ring
        self.dumps: list[str] = []  # guarded-by: _lock — dump paths written
        self._dumps_started = 0  # guarded-by: _lock — reserved at trigger

    # --- recording --------------------------------------------------------

    def _push(self, ph: str, name: str, cat: str, span_id, args: dict) -> dict:
        ev = {
            "seq": next(self._seq),
            "t": self._now(),
            "ph": ph,
            "name": name,
            "cat": cat,
            "id": span_id,
            "tid": threading.current_thread().name,
            "args": args,
        }
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
        return ev

    def event(self, name: str, *, cat: str = "event", id=None, **args):
        """One instant event."""
        return self._push("i", name, cat, id, args)

    def begin(self, name: str, span_id: str, *, cat: str = "span", **args):
        """Open one span; close it with :meth:`end` (any thread)."""
        return self._push("b", name, cat, span_id, args)

    def end(self, name: str, span_id: str, *, cat: str = "span", **args):
        return self._push("e", name, cat, span_id, args)

    @contextlib.contextmanager
    def span(self, name: str, span_id: str, *, cat: str = "span", **args):
        self.begin(name, span_id, cat=cat, **args)
        try:
            yield
        finally:
            self.end(name, span_id, cat=cat)

    # --- reading ----------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """A consistent copy of the ring, oldest first."""
        with self._lock:
            return list(self._events)

    def events_since(self, t: float) -> list[dict]:
        with self._lock:
            return [ev for ev in self._events if ev["t"] >= t]

    # --- flight recorder --------------------------------------------------

    def flight_dump(self, reason: str, *, path: str | None = None) -> str | None:
        """Write the last ``window_s`` seconds of events to a timestamped
        JSONL file and record the trigger as an event itself (so later
        dumps see earlier trips). Returns the path, or None when the
        per-process ``max_dumps`` budget is spent (the budget exists so a
        wedged device tripping the watchdog per batch cannot fill the
        disk). Best-effort: an unwritable dump dir is reported as an
        event, never raised into the serving path that tripped it."""
        with self._lock:
            if self._dumps_started >= self.max_dumps:
                return None
            self._dumps_started += 1
            n = self._dumps_started
            # Captured under the lock: the header below is built outside it.
            dropped = self.dropped
        self.event("flight_dump", cat="obs", reason=reason, n=n)
        now = self._now()
        events = self.events_since(now - self.window_s)
        if path is None:
            stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
            path = os.path.join(
                self.dump_dir,
                f"flightrec-{stamp}-{safe}-p{os.getpid()}-{n}.jsonl",
            )
        header = {
            "flight_recorder": reason,
            "t": now,
            "t0": self.t0,
            "window_s": self.window_s,
            "wall_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "pid": os.getpid(),
            "events": len(events),
            "dropped": dropped,
        }
        try:
            os.makedirs(self.dump_dir or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps(header) + "\n")
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
        except OSError as exc:
            self.event("flight_dump_failed", cat="obs", reason=reason,
                       error=repr(exc))
            return None
        with self._lock:
            self.dumps.append(path)
        return path
