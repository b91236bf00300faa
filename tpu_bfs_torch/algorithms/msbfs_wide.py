"""Wide bit-packed multi-source BFS: the gather-only engine, the port of
``tpu_bfs/algorithms/msbfs_wide.py:WidePackedMsBfsEngine`` and the hybrid
engine's fallback.

Every level expands the frontier through one ``ell_expand`` (K1) launch per
ELL bucket; the claim is ``next = hit & ~visited`` on packed words, the
race-free form of the reference's atomicMin claim (bfs.cu:146-150). The
frontier table keeps its all-zero sentinel row (row ``num_active``), the
gather target of every pad slot.
"""

from __future__ import annotations

import numpy as np

from tpu_bfs_torch.algorithms._packed_common import (
    HBM_BUDGET_BYTES,
    ExpandSpec,
    PackedRunProtocol,
    arrs_nbytes,
    auto_lanes,
    expand_arrays,
    make_expand,
    make_packed_loop,
    make_state_kernels,
    pallas_expand_arrays,
    resolve_device,
)
from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.ell import EllGraph, build_ell

LANES = 4096
MAX_LANES = 4 * LANES
DEFAULT_MAX_LANES = 2 * LANES


def expand_spec(ell: EllGraph) -> ExpandSpec:
    """Expansion spec of a full ELL: buckets, then the zero-in-degree active
    rows and the sentinel row as identity rows."""
    return ExpandSpec(
        kcap=ell.kcap,
        heavy=ell.num_heavy > 0,
        num_virtual=ell.num_virtual,
        fold_steps=ell.fold_steps,
        light_meta=tuple((b.k, b.n) for b in ell.light),
        tail_rows=ell.num_active - ell.num_nonzero + 1,
    )


class WidePackedMsBfsEngine(PackedRunProtocol):
    """Up to ``lanes`` concurrent BFS sources over a gather-only bucketed ELL.

    ``num_planes`` bit-sliced counter planes bound the traversal at
    ``2**num_planes`` levels; ``run`` raises when a traversal outlives them.
    ``device`` defaults to CUDA and raises when there is none."""

    def __init__(
        self,
        graph: Graph | EllGraph,
        *,
        lanes: int | str = "auto",
        kcap: int = 64,
        num_planes: int = 5,
        hbm_budget_bytes: int = HBM_BUDGET_BYTES,
        max_lanes: int = DEFAULT_MAX_LANES,
        device=None,
    ):
        if not (1 <= num_planes <= 8):
            raise ValueError("num_planes must be in [1, 8]")
        if max_lanes % 32 or not (32 <= max_lanes <= MAX_LANES):
            raise ValueError(f"max_lanes must be a multiple of 32 in [32, {MAX_LANES}]")
        self.device = resolve_device(device)
        self.num_planes = num_planes
        # A vertex claimed in level i carries counter i and distance i+1, so
        # p planes label distances up to 2**p; 254 keeps them below UNREACHED.
        self.max_levels_cap = min(1 << num_planes, 254)
        self.ell = build_ell(graph, kcap=kcap) if isinstance(graph, Graph) else graph
        # The edge list for the host parent path; a prebuilt ELL has none.
        self.host_graph = graph if isinstance(graph, Graph) else None
        ell = self.ell
        self._act = ell.num_active
        host_tables = pallas_expand_arrays(ell, self._act)
        if lanes == "auto":
            lanes = auto_lanes(
                self._act + 1, num_planes,
                fixed_bytes=arrs_nbytes(host_tables), hbm_budget_bytes=hbm_budget_bytes,
                max_lanes=max_lanes, on_unfit="raise",
            )
        if lanes % 32 or not (32 <= lanes <= MAX_LANES):
            raise ValueError(f"lanes must be a multiple of 32 in [32, {MAX_LANES}]")
        self.w = lanes // 32
        self.lanes = lanes
        self.undirected = ell.undirected
        # Pad slots gather the all-zero sentinel row act, which is also the
        # parent scan's all-ones sentinel row: the scan borrows these tables.
        self.arrs = expand_arrays(ell, self._act, self.device)
        self._table_rows = self._act + 1
        self._core, self._core_from = make_packed_loop(
            make_expand(expand_spec(ell), self.w), num_planes
        )
        in_deg_ranked = ell.in_degree[ell.old_of_new].astype(np.int32)
        self._seed, self._lane_stats, self._extract_word, self._lane_ecc = make_state_kernels(
            ell.num_vertices, self._table_rows, self.w, num_planes,
            active=self._act, in_deg_host=in_deg_ranked, device=self.device,
        )
        self._rank = ell.rank
        self._warmed = False

    @property
    def num_vertices(self) -> int:
        return self.ell.num_vertices

    def _full_parent_ell(self):
        """The parent scan's full-coverage ELL and device tables: this
        engine's own, lent (so a prebuilt-ELL engine, which has no edge
        list for the host path, still exports parents)."""
        return self.ell, self.arrs
