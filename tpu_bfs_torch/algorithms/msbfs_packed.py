"""Bit-sliced distance counters shared by the packed engines (the port of
``tpu_bfs/algorithms/msbfs_packed.py``'s ``ripple_increment`` and
``UNREACHED``; the 512-lane ``PackedMsBfsEngine`` is not ported yet)."""

from __future__ import annotations

import numpy as np

UNREACHED = np.uint8(255)  # uint8 distance sentinel; see distances_int32()


def ripple_increment_(planes, carry_bits) -> None:
    """Bit-sliced ripple-carry: planes + 1 wherever carry_bits is set. The
    JAX ``ripple_increment`` returns new planes; this one updates each plane
    tensor in place (one carry transient instead of a second set of planes)."""
    for p in planes:
        nxt = p & carry_bits
        p ^= carry_bits
        carry_bits = nxt
