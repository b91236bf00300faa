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
    AdaptivePush,
    ExpandSpec,
    PackedRunProtocol,
    arrs_nbytes,
    auto_lanes,
    build_push_table,
    expand_arrays,
    gate_block_arrays,
    level_step,
    make_expand,
    make_gated_expand,
    make_packed_loop,
    make_state_kernels,
    packed_layout,
    pallas_expand_arrays,
    resolve_device,
)
from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.dynamic import (
    device_overlay_tables,
    empty_overlay_tables,
    make_overlay_fold,
)
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
    ``device`` defaults to CUDA and raises when there is none.

    ``pull_gate=True`` (default off, as in JAX) skips settled rows' bucket
    blocks inside K1 and their state blocks (``make_gated_expand``,
    ``gated_state_update_``): bit-identical distances, reached counts and
    parents; skipped blocks per level land in ``last_gate_level_counts``.

    ``overlay=(rows, kcap)`` arms the dynamic-graph delta overlay
    (``graph/dynamic.py``): the engine builds with empty overlay tables in
    ``arrs`` and folds them over every level's expansion; ``set_overlay``
    swaps in a mutation's tables. It does not compose with the pull gate.

    ``adaptive_push=(row_cap, deg_cap)`` sends light levels (at most
    ``row_cap`` active rows, none of out-degree above ``deg_cap``) through a
    push pass over those rows' out-edges instead of every K1 bucket
    (``_packed_common.AdaptivePush``): bit-identical results; per level run,
    whether it pushed lands in ``last_push_levels``. It needs the edge list
    (an engine built from a ``Graph``) and combines with neither the pull
    gate nor the overlay.

    ``ell``, with ``graph`` a ``Graph``, is its prebuilt ``build_ell(graph,
    kcap=kcap)``, which does not depend on the lanes: the serve registry's
    rungs of one graph share one."""

    def __init__(
        self,
        graph: Graph | EllGraph,
        *,
        lanes: int | str = "auto",
        kcap: int = 64,
        num_planes: int = 5,
        hbm_budget_bytes: int = HBM_BUDGET_BYTES,
        max_lanes: int = DEFAULT_MAX_LANES,
        pull_gate: bool = False,
        overlay: tuple = (),
        adaptive_push: tuple[int, int] | None = None,
        ell: EllGraph | None = None,
        device=None,
    ):
        if not (1 <= num_planes <= 8):
            raise ValueError("num_planes must be in [1, 8]")
        self.overlay = tuple(int(x) for x in overlay) if overlay else ()
        if self.overlay and (pull_gate or adaptive_push is not None):
            # Both choose rows and blocks by BASE-graph keys; overlay edges
            # would escape them and go untraversed.
            raise ValueError("overlay does not compose with pull_gate or adaptive_push")
        if pull_gate and adaptive_push is not None:
            # Both gate the per-level scan, by different keys (JAX's rule).
            raise ValueError("pull_gate and adaptive_push cannot combine (yet): pick one")
        if max_lanes % 32 or not (32 <= max_lanes <= MAX_LANES):
            raise ValueError(f"max_lanes must be a multiple of 32 in [32, {MAX_LANES}]")
        self.device = resolve_device(device)
        self.num_planes = num_planes
        # A vertex claimed in level i carries counter i and distance i+1, so
        # p planes label distances up to 2**p; 254 keeps them below UNREACHED.
        self.max_levels_cap = min(1 << num_planes, 254)
        if ell is None:
            ell = build_ell(graph, kcap=kcap) if isinstance(graph, Graph) else graph
        elif ell.kcap != kcap:
            raise ValueError(f"ell was built with kcap={ell.kcap}, the engine asks {kcap}")
        self.ell = ell
        # The edge list for the host parent path; a prebuilt ELL has none.
        self.host_graph = graph if isinstance(graph, Graph) else None
        ell = self.ell
        self._act = ell.num_active
        host_tables = pallas_expand_arrays(ell, self._act)
        push = None
        if adaptive_push is not None:
            if self.host_graph is None:
                raise ValueError(
                    "adaptive_push needs the edge list: construct the engine "
                    "from a Graph (a prebuilt ELL has dropped it)"
                )
            push = AdaptivePush(
                adaptive_push,
                *build_push_table(self.host_graph, ell.rank, self._act, int(adaptive_push[1])),
                act=self._act, out_rows=self._act + 1,
            )
        if lanes == "auto":
            # The push table is a lane-independent resident, like the ELL.
            push_bytes = push.nbytes() if push is not None else 0
            lanes = auto_lanes(
                self._act + 1, num_planes,
                fixed_bytes=arrs_nbytes(host_tables) + push_bytes,
                hbm_budget_bytes=hbm_budget_bytes,
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
        if self.overlay:
            # Arm the fold with all-pad tables (every row writes the combine
            # identity into the sentinel row); a mutation swaps values.
            self.set_overlay(empty_overlay_tables(self.overlay, self._act))
        self._table_rows = self._act + 1
        spec = expand_spec(ell)
        self._aot_layout = packed_layout(self, spec, heavy_rows=ell.num_heavy)
        if pull_gate:
            # Bucket outputs are table rows in order (no permutation), so
            # the per-row unsettled mask is the needed vector itself.
            nh = ell.num_heavy
            self.arrs.update(gate_block_arrays(spec, self.arrs))
            self._install_gate(
                make_gated_expand(spec, self.w), needed_of=lambda arrs, need: need,
                heavy_rows=nh, heavy_needed_host=lambda need: bool(need[:nh].any()),
            )
        else:
            expand = make_expand(spec, self.w)
            if self.overlay:
                # The delta overlay folds over the bucket outputs, a fresh
                # tensor, in place (plain torch after K1's launches).
                expand = make_overlay_fold(expand, op="or")
            if push is not None:
                self.arrs.update(push.device_arrays(self.device))
                self._install_push(expand, push)
            else:
                self._step = level_step(expand)
                self._core, self._core_from, self._deeper = make_packed_loop(
                    self._call_step, expand, num_planes)
        in_deg_ranked = ell.in_degree[ell.old_of_new].astype(np.int32)
        (self._seed, self._lane_stats, self._extract_word, self._lane_ecc,
         self._in_deg) = make_state_kernels(
            ell.num_vertices, self._table_rows, self.w, num_planes,
            active=self._act, in_deg_host=in_deg_ranked, device=self.device,
        )
        self._rank = ell.rank
        self._warmed = False

    def set_overlay(self, tables) -> None:
        """Swap the delta-overlay tables: the shapes must match the armed
        capacity, and the swap is one atomic dict rebind, so a batch
        dispatched concurrently sees the old tables or the new, never a
        mix."""
        if not self.overlay:
            raise ValueError(
                "engine built without an overlay — pass overlay=(rows, "
                "kcap) at construction to serve a dynamic graph"
            )
        new = device_overlay_tables(tables, self.overlay, self.device)
        self.arrs = {**self.arrs, **new}

    @property
    def num_vertices(self) -> int:
        return self.ell.num_vertices

    def _full_parent_ell(self):
        """The parent scan's full-coverage ELL and device tables: this
        engine's own, lent (so a prebuilt-ELL engine, which has no edge
        list for the host path, still exports parents)."""
        return self.ell, self.arrs
