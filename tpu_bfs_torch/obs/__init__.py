"""Telemetry: span tracing, exporters and the flight recorder, the port of
``tpu_bfs/obs``.

Every production instrumentation site is a single module-attribute check
(``if obs.ACTIVE is not None``) against a global that stays ``None`` unless
a recorder was armed: through ``--obs``/``--trace-out`` (the serve
entry point), the ``TPU_BFS_OBS`` environment variable, or :func:`arm`.
The unarmed hot path pays one attribute read per site and allocates
nothing.

What the armed recorder collects:

- **spans/events** (:class:`~tpu_bfs_torch.obs.recorder.Recorder`): a
  thread-safe ring buffer of ``time.monotonic``-stamped records through the
  serve lifecycle (admit, enqueue, coalesce, dispatch, fetch, extract,
  resolve, registry build and warm, every retry, degrade and shed), keyed
  so each query id's chain carries its batch id, width rung and attempts;
- **flight recorder**: the ring buffer dumps its last ``window_s`` seconds
  to a timestamped JSONL file on a watchdog trip, breaker open, requeue
  shed, uncaught executor error or SIGTERM drain;
- **exporters** (:mod:`~tpu_bfs_torch.obs.exporters`): Chrome/Perfetto
  trace-event JSON (``--trace-out``), Prometheus-style text (``/metricz``
  via ``BfsService.metricz`` and ``--metricz-out``) and plain JSONL.

The engines' per-level traces (``last_run_trace``, JAX's
``obs/engine_trace.py``) are not ported yet (ROADMAP Queue 1 item 3.6).

Spec grammar (``--obs`` / ``TPU_BFS_OBS``)::

    spec  := "1" | "true" | "0" | "off" | kv ("," kv)*
    kv    := "capacity=" INT | "window=" FLOAT (seconds)
           | "dump_dir=" PATH | "max_dumps=" INT

Falsy values (``0``/``false``/``off``/``no``) leave telemetry disarmed.
"""

from __future__ import annotations

import contextlib
import os

from tpu_bfs_torch.obs.recorder import Recorder

__all__ = [
    "ACTIVE",
    "ENV_VAR",
    "Recorder",
    "arm",
    "arm_for_run",
    "arm_from_env",
    "arm_from_spec",
    "arm_from_spec_or_env",
    "disarm",
    "maybe_span",
]

# THE guard production sites check: None (the default) keeps every
# instrumentation site a single attribute test with no further work.
ACTIVE: Recorder | None = None

ENV_VAR = "TPU_BFS_OBS"

_TRUTHY = ("1", "true", "on", "yes")
_FALSY = ("0", "false", "off", "no")


def _parse_spec(spec: str) -> dict:
    spec = spec.strip()
    kw: dict = {}
    if not spec or spec.lower() in _TRUTHY:
        return kw
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, eq, v = item.partition("=")
        k = k.strip()
        try:
            if k == "capacity":
                kw["capacity"] = int(v)
            elif k == "window":
                kw["window_s"] = float(v)
            elif k == "dump_dir":
                kw["dump_dir"] = v.strip()
            elif k == "max_dumps":
                kw["max_dumps"] = int(v)
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad obs spec item {item!r} (capacity=INT, window=FLOAT, "
                f"dump_dir=PATH, max_dumps=INT)"
            ) from None
        if not eq:
            raise ValueError(f"obs spec item {item!r} must be key=value")
    return kw


def arm(recorder: Recorder | None = None, **kw) -> Recorder:
    """Install ``recorder`` (or a fresh one built from ``kw``) as the
    process-wide ACTIVE recorder. Idempotent-friendly: re-arming replaces
    the previous recorder (its events are dropped with it)."""
    global ACTIVE
    ACTIVE = recorder if recorder is not None else Recorder(**kw)
    return ACTIVE


def arm_from_spec(spec: str) -> Recorder | None:
    """Arm from one spec string; an explicitly-falsy spec (``0``,
    ``false``, ``off``, ``no``) returns None WITHOUT arming — and, via
    arm_from_spec_or_env, without falling through to the env var (an
    explicit ``--obs 0`` overrides a fleet-set TPU_BFS_OBS)."""
    if spec.strip().lower() in _FALSY:
        return None
    return arm(**_parse_spec(spec))


def arm_from_env(env: str = ENV_VAR) -> Recorder | None:
    spec = os.environ.get(env, "").strip()
    return arm_from_spec(spec) if spec else None


def arm_from_spec_or_env(spec: str | None, env: str = ENV_VAR) -> Recorder | None:
    """The entry points' shared precedence (same contract as
    faults.arm_from_spec_or_env): an explicit ``--obs`` spec wins over the
    environment variable; neither set = stay disarmed."""
    return arm_from_spec(spec) if spec is not None else arm_from_env(env)


def arm_for_run(spec: str | None, trace_out: str | None = None,
                env: str = ENV_VAR) -> Recorder | None:
    """The entry-point arming (the serve server): an explicit
    ``--obs`` spec wins, else the env var; ``--trace-out`` needs a
    recorder, so it arms one with defaults when nothing else did."""
    rec = arm_from_spec_or_env(spec, env)
    if rec is None and trace_out:
        rec = arm()
    return rec


def maybe_span(name: str, span_id: str, *, cat: str = "span", **args):
    """``ACTIVE.span(...)`` when armed, a no-op context otherwise — for
    COLD paths (graph load, engine build/warm) where the armed/disarmed
    fork would otherwise be written out twice. Hot loops keep the
    explicit ``if obs.ACTIVE is not None`` guard: one attribute read,
    no context-manager allocation."""
    rec = ACTIVE
    if rec is None:
        return contextlib.nullcontext()
    return rec.span(name, span_id, cat=cat, **args)


def disarm() -> None:
    global ACTIVE
    ACTIVE = None
