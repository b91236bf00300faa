"""The degraded-mesh failover ladder, the port of
``tpu_bfs/resilience/failover.py`` (host code, copied).

A mesh fault invalidates every collective of the dead mesh shape, while
the graph, the registry and the smaller meshes stay intact: the service
rebuilds one rung down (full mesh, half mesh, ..., one device). The width
ladder re-derives at the new device count, and the circuit breaker is
keyed ``(width, devices)``, so the degraded dispatches use new keys.
"""

from __future__ import annotations


def degrade_ladder(devices: int) -> list[int]:
    """The mesh rungs a ``devices``-wide service fails over across,
    descending: the full mesh, then successive halvings, down to one
    device. ``degrade_ladder(8) == [8, 4, 2, 1]``; ``degrade_ladder(1) ==
    [1]``."""
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    rungs = []
    d = int(devices)
    while d >= 1:
        rungs.append(d)
        if d == 1:
            break
        d //= 2
    return rungs


def next_mesh_rung(devices: int) -> int | None:
    """The rung below ``devices`` (None at the single-device floor)."""
    ladder = degrade_ladder(devices)
    return ladder[1] if len(ladder) > 1 else None


def floor_config(engine: str, exchange: str) -> tuple[str, str]:
    """``(engine, exchange)`` of a mesh engine config degraded to ONE
    device. The 1D-partition engines (wide, hybrid) have single-device
    twins of the same name; the 2D serve engine is mesh-only, so its floor
    serves through the wide engine (every engine over one graph answers
    alike). Exchange families describe mesh collectives and drop."""
    if engine == "dist2d":
        return "wide", ""
    return engine, ""
