"""The dtype pass, the port of ``tpu_bfs/analysis/dtypes.py``: no 64-bit
node output in an exported hot program.

The engines are sized to 32-bit words end to end (packed frontier and
plane words int32, distances int32 or uint8, ids int32); an accidental
int64 or float64 doubles a hot buffer and halves the bandwidth it is
read at. The scan reads every node of a program's FX graph
(``analysis/graph.walk_program``), nested graphs and the registered
kernel ops included, and flags each node output of a wide dtype, once a
program and op. Torch ops that need an int64 index take a cast at the
edge where that keeps the batch bit-equal; what cannot is parked in the
port's baseline, one fingerprint a line with its reason.
"""

from __future__ import annotations

from tpu_bfs_torch.analysis import Finding

WIDE = ("float64", "int64", "uint64", "complex128")


def check_walk(name: str, walk) -> list[Finding]:
    """Every wide node output of the walked program ``name``."""
    findings: list[Finding] = []
    seen = set()
    for node in walk.nodes:
        wide = next((d for d in node.dtypes if d in WIDE), None)
        if wide is None:
            continue
        where = f"{name}:{node.target}"
        if where in seen:
            continue
        seen.add(where)
        findings.append(Finding(
            "dtype", where,
            f"`{node.target}` produces a {wide} value in a compiled hot program — 64-bit "
            f"never belongs on the device hot path (distances are u8/i32, frontiers "
            f"pred/u32). Cast explicitly or fix the widening input."))
    return findings

