"""Batched BFS-tree extraction on the device, the port of
``tpu_bfs/algorithms/parent_scan.py``.

The packed level loop labels distances only; parent trees are derived
afterwards as one bucketed-ELL ``min`` expansion per 128 lanes. Along any
edge u->v BFS guarantees ``dist(u) >= dist(v) - 1``, and every reached v
with ``dist(v) >= 1`` has an in-neighbor at exactly ``dist(v) - 1``. So the
minimum over v's in-neighbors of the 32-bit key

    key(u) = (dist(u) << idbits) | orig_id(u)

sits at a neighbor of distance ``dist(v) - 1`` with the least original id:
the deterministic min-parent tree (``validate.min_parent_from_dist``), the
race-free replacement of the reference's atomicMin winner (bfs.cu:146-147,
940). The expansion is ``make_expand(spec, 128, op="min")``: K1
(``ell_expand``) once per bucket and the heavy rows' fold pyramid through
``umin``, the cost of about one BFS level per 128 lanes.

Keys are uint32 bit patterns carried in int32 (the port's packed-word rule),
and bit 31 is set wherever ``dist << idbits >= 2**31``: for every
UNREACHED key once V > 2**23, and for real distances >= 128 at 24 id bits.
They are built in int64 and wrapped to int32 bits explicitly, compared
unsigned (``op="min"``), and decoded from the unsigned value
(``& 0xFFFFFFFF`` before ``>>``): an arithmetic shift of a negative int32
would corrupt the distance field. The sentinel row ``act``, the gather
target of every pad slot, is all ``-1`` (0xFFFFFFFF), the ``min`` identity,
so pad slots never win.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import (
    UNREACHED,
    expand_arrays,
    make_expand,
    resolve_device,
)
from tpu_bfs_torch.algorithms.msbfs_wide import expand_spec
from tpu_bfs_torch.graph.ell import EllGraph

# Lanes decoded per device pass: four 32-lane word columns, about the cost
# of one BFS level at 128 words.
LANES_PER_PASS = 128


class ParentScanUnavailable(ValueError):
    """The key encoding cannot represent this graph (id field too wide for
    the distance field). The engine then has no scanner: on the CPU,
    ``parents_into(device='auto')`` takes the host path; on the card, only
    ``device='host'`` serves the trees."""


class ParentScanner:
    """Batched min-key parent extraction over a full in-neighbor ELL.

    ``ell`` must cover ALL edges (the wide engine's own ELL does, and its
    device tables can be lent through ``arrs``; the hybrid engine's residual
    ELL does not). Borrowed tables must pad with the sentinel row
    ``num_active``. ``max_dist`` is the largest distance the key must hold
    exactly (the engine's level cap); ids and distances share 32 bits, so a
    huge graph with a deep cap raises :class:`ParentScanUnavailable`.
    ``device`` is CUDA unless named (``arrs``' device when they are lent)."""

    lanes_per_pass = LANES_PER_PASS

    def __init__(self, ell: EllGraph, *, arrs=None, max_dist: int = 254, device=None):
        act = ell.num_active
        self.ell = ell
        self.idbits = max(int(ell.num_vertices - 1).bit_length(), 1)
        # Distances live in the top (32 - idbits) bits. UNREACHED and anything
        # else the field cannot hold clamps to the field's max, which must
        # exceed every real distance, so clamped keys never decode as valid.
        self.dumax = (1 << (32 - self.idbits)) - 1
        if self.dumax < max_dist + 1:
            raise ParentScanUnavailable(
                f"V={ell.num_vertices} needs {self.idbits} id bits, leaving "
                f"a distance field of at most {self.dumax} < cap {max_dist}+1"
            )
        if arrs is None:
            self.device = resolve_device(device)
            self.arrs = expand_arrays(ell, act, self.device)
        else:
            self.device = arrs[next(k for k in arrs if k.endswith("_gt"))].device
            self.arrs = arrs
            top = max(int(t.max()) for k, t in arrs.items() if k.endswith("_gt"))
            if top > act:
                raise ValueError(
                    f"lent ELL tables name row {top}, past the scanner's sentinel "
                    f"row {act}: pad slots must gather row num_active"
                )
        self._expand_min = make_expand(expand_spec(ell), LANES_PER_PASS, op="min")
        self.ids = torch.from_numpy(ell.old_of_new[:act].astype(np.int64)).to(self.device)
        self._sentinel = torch.full((1, LANES_PER_PASS), -1, dtype=torch.int32,
                                    device=self.device)

    def keys(self, dist_cols: torch.Tensor) -> torch.Tensor:
        """The expansion's input: [num_active + 1, lanes_per_pass] int32
        holding the uint32 keys of ``dist_cols`` (see :meth:`scan`), then
        the all-ones sentinel row."""
        want = (self.ell.num_active, self.lanes_per_pass)
        if dist_cols.dtype != torch.uint8 or tuple(dist_cols.shape) != want:
            raise ValueError(
                f"dist_cols must be {want} uint8, got {tuple(dist_cols.shape)} {dist_cols.dtype}"
            )
        du = dist_cols.long().clamp_(max=self.dumax)
        keys = (du << self.idbits) | self.ids[:, None]  # < 2**32, as int64
        keys = torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(torch.int32)
        return torch.cat([keys, self._sentinel])

    def scan(self, dist_cols: torch.Tensor) -> torch.Tensor:
        """One pass. ``dist_cols`` is [num_active, lanes_per_pass] uint8 on
        the scanner's device (UNREACHED-padded when fewer real columns
        remain); returns [num_active, lanes_per_pass] int32 original-id
        parents, -1 where there is none, sources mapping to themselves."""
        mk = self._expand_min(self.arrs, self.keys(dist_cols))[: self.ell.num_active]
        mk = mk.long() & 0xFFFFFFFF  # the unsigned key again
        dv = dist_cols.long()
        valid = (dv != int(UNREACHED)) & ((mk >> self.idbits) == dv - 1)
        pid = torch.where(valid, mk & ((1 << self.idbits) - 1), -1)
        return torch.where(dv == 0, self.ids[:, None], pid).to(torch.int32)
