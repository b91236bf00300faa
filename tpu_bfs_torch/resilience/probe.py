"""The mesh health probe, the port of ``tpu_bfs/resilience/probe.py``.

A mesh fault is detected where it bites (a serving batch), but restoring a
wider mesh needs the opposite signal: proof that the mesh shape is healthy
again. The heartbeat is the smallest program that fails as a serving
batch's exchange would: an all-reduce (sum) of one 1 from every rank of
the probed rung. ``mesh_heartbeat`` is the one-shot form (the degraded
service's ``mesh_restore`` gates each promotion on it);
:class:`MeshHealthProbe` is the background prober a long-lived server arms
(``--mesh-probe-interval-s``). Both consult the ``probe`` fault site first,
so a chaos schedule can hold a mesh "dead" past its injected fault.

JAX runs the heartbeat as a ``shard_map`` psum from its one controller.
Here it is one command of the mesh controller's ordered stream
(``parallel/mesh.MeshController.heartbeat``): the ranks of the rung join
the all-reduce when they reach it, in the order every rank replays.
"""

from __future__ import annotations

import threading
import time

from tpu_bfs_torch import faults as _faults


def mesh_heartbeat(devices: int) -> float:
    """One all-reduce heartbeat across the first ``devices`` ranks of the
    mesh controller; returns its latency in seconds. Raises what the
    collective raised on an unhealthy mesh, ``DATA_LOSS`` when the sum is
    not ``devices``, and ValueError when fewer ranks exist."""
    if _faults.ACTIVE is not None:
        # The fault site "probe": a mesh kind scheduled here makes this
        # mesh shape report dead, holding a degraded service off it.
        _faults.ACTIVE.hit("probe", devices=devices)
    from tpu_bfs_torch.parallel.mesh import active_controller

    ctl = active_controller()
    have = 1 if ctl is None else ctl.num_ranks
    if devices > have:
        raise ValueError(f"heartbeat over {devices} devices: only {have} attached")
    t0 = time.perf_counter()
    got = 1 if devices == 1 else ctl.heartbeat(devices)
    if got != devices:
        # A sum short of the rank count: a participant's contribution
        # vanished, which is a device loss.
        raise RuntimeError(
            f"DATA_LOSS: mesh heartbeat psum returned {got}, "
            f"expected {devices} (a participant is missing)"
        )
    return time.perf_counter() - t0


class MeshHealthProbe:
    """Background prober of a degraded service: every ``interval_s`` it
    asks ``current()`` for the live device count and, below
    ``target_devices``, heartbeats the rungs above (widest first) and calls
    ``on_healthy(devices)`` for the widest that answers. Probe failures are
    expected (the mesh is still dead) and only logged. Daemon thread;
    ``stop()`` is idempotent and joins."""

    def __init__(self, target_devices: int, *, interval_s: float,
                 current, on_healthy, log=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.target_devices = int(target_devices)
        self.interval_s = float(interval_s)
        self._current = current
        self._on_healthy = on_healthy
        self._log = log or (lambda msg: None)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="bfs-mesh-probe", daemon=True
        )

    def start(self) -> "MeshHealthProbe":
        self._thread.start()
        return self

    def _rungs_above(self, devices: int) -> list[int]:
        from tpu_bfs_torch.resilience.failover import degrade_ladder

        return [d for d in degrade_ladder(self.target_devices) if d > devices]

    def probe_once(self) -> int | None:
        """One probe pass (also the test hook): the device count promoted
        to, or None when nothing changed."""
        devices = self._current()
        if devices >= self.target_devices:
            return None
        for d in self._rungs_above(devices):
            try:
                latency = mesh_heartbeat(d)
            except Exception as exc:  # noqa: BLE001 — a dead mesh is expected
                self._log(
                    f"mesh probe: {d}-device heartbeat failed "
                    f"({type(exc).__name__}: {str(exc)[:120]})"
                )
                continue
            self._log(
                f"mesh probe: {d}-device heartbeat healthy "
                f"({latency * 1e3:.1f} ms); promoting"
            )
            self._on_healthy(d)
            return d
        return None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception as exc:  # noqa: BLE001 — the prober must survive
                self._log(f"mesh probe pass failed ({exc!r})")

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
