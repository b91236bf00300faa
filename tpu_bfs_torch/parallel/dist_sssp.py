"""Bucketed delta-stepping SSSP over a 1D or 2D mesh, the port of
``tpu_bfs/parallel/dist_sssp.py``.

The mesh form of ``workloads/sssp.py``'s ``SsspEngine``, on the substrate
of ``DistWideMsBfsEngine``: the sharded bucketed ELL (rows dealt
round-robin over the degree-sorted order) with a weights plane
slot-aligned with it (``graph/ell.build_ell_weights_sharded``), and a
replicated rank-order int32 distance table [v_pad + 1, L] whose last row
is the all-INF sentinel that pad slots gather.

A round on every rank: K1 ``minplus`` over the rank's shard relaxes its
own rows (the light sweep, and when it changes nothing anywhere, the heavy
close over every edge), then the mesh rebuilds the replicated table with
one of the (min, +) exchanges of ``collectives.py``:

- ``ring``: the previous table with the rank's rows substituted (one copy
  of the table, as JAX's ``contrib_of``), ring-reduce-scattered with
  ``minimum`` and all-gathered back into that copy;
- ``allreduce``: the same contribution through an ``all_reduce`` MIN; on a
  2D mesh over the mesh column, then the mesh row (the only exchange a 2D
  mesh takes, as in JAX);
- ``sparse``: the changed rows as (id, distance row) pairs on a cap ladder
  (``delta_bits`` delta-encodes the ids; ``predict`` skips the measuring
  read on rounds that follow a dense one while the changed set grows),
  scatter-MINed into a copy of the previous table, or every rank's rows
  all-gathered when no rung holds them.

The rank-local work of a round is two fixed-shape programs between the
host's collectives (the AOT inventory, ``utils/aot.py``):
``dist_sssp_core``, the light sweep (the bucket mask, own rows, K1
``minplus`` over the light weights, the min and the changed flag), and
``dist_sssp_close``, the heavy close over every edge. The exchanges stay in
the host loop.

JAX runs the loop as one ``lax.while_loop`` with a ``lax.cond`` for the
close. Here the host steers it, as ``SsspEngine`` does: a light round
reads once, the light sweep's changed count after an ``all_reduce`` SUM (a
round that changed something is alive with its bound unchanged); a close
round reads a second time, its ``alive`` from the replicated table; the
sparse exchange's rung read comes on top, except on predicted rounds. The
decisions read only all-reduced or replicated values, so every rank takes
them alike. Distances, rounds and branch counts equal JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import ExpandSpec, make_expand, plain_ints
from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.ell import build_ell_sharded, build_ell_weights_sharded, pad_gate_blocks
from tpu_bfs_torch.parallel.collectives import (
    branch_rung,
    check_delta_bits,
    dense_min_wire_bytes,
    minplus_rows_branch_count,
    minplus_rows_branch_labels,
    minplus_rows_wire_bytes_per_level,
    ring_reduce_scatter,
    row_gather_flags,
    rows_gather_branch,
    sparse_rows_exchange_min,
)
from tpu_bfs_torch.parallel.dist_msbfs_wide import (
    MeshAotHost,
    resolve_mesh,
    resolve_row_caps,
    shard_expand_arrays,
)
from tpu_bfs_torch.parallel.mesh import Mesh2D
from tpu_bfs_torch.utils.aot import AotProgramProtocol, ArgSpec
from tpu_bfs_torch.workloads.sssp import INF_W, SsspEngine, _check_kernel_ident

#: Exchanges of the mesh delta-stepping engine. ``sparse`` and ``ring`` are
#: 1D only; a 2D mesh exchanges through ``allreduce``.
EXCHANGES = ("ring", "allreduce", "sparse")


class DistSsspEngine(MeshAotHost, AotProgramProtocol, SsspEngine):
    """Delta-stepping SSSP on a mesh: sharded ELL and weights, replicated
    distance table. Built inside every rank of ``mesh`` (a 1D ``Mesh`` or a
    ``Mesh2D``; default: this process's rank group, CUDA unless ``device``
    names another). ``lanes``, ``kcap``, ``delta`` and ``max_rounds`` as
    ``SsspEngine``; ``exchange`` one of :data:`EXCHANGES` (``allreduce`` on
    a 2D mesh); ``sparse_caps`` (default ``default_row_gather_caps``),
    ``delta_bits`` and ``predict`` shape the sparse exchange. ``shard`` is
    ``build_ell_sharded`` of ``graph`` for the mesh's size and ``weights``
    ``build_ell_weights_sharded`` of both, to build several engines over
    one graph without repeating the host builds.

    Device memory a rank: the replicated table, (v_pad + 1) x 4L bytes,
    three times in a round (the table, its bucket-masked copy, the next
    table), the rank's own [v_loc, L] expansion outputs (two on a close
    round) and its ELL and weight shards. ``last_host_reads``,
    ``last_closes`` and the exchange counters describe the last batch."""

    kind = "sssp"

    def __init__(self, graph: Graph, mesh=None, *, lanes: int = 32, kcap: int = 64,
                 delta: int = 0, max_rounds: int = 4096, exchange: str = "ring",
                 sparse_caps=None, delta_bits=(), predict: bool = False, device=None,
                 shard=None, weights=None):
        if not isinstance(graph, Graph):
            raise ValueError("DistSsspEngine needs the host Graph (the weights plane and "
                             "result extraction both read it)")
        if graph.weights is None:
            raise ValueError("sssp needs a weighted graph (generate with weights=W or "
                             "attach a weights plane)")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}; have {EXCHANGES}")
        _check_kernel_ident()
        if isinstance(mesh, Mesh2D) and exchange != "allreduce":
            raise ValueError(
                f"a 2D mesh exchanges hierarchically — exchange='allreduce', not "
                f"{exchange!r} (the queue-style and ring forms are defined over the "
                "single 1D partition axis)")
        if delta_bits and exchange != "sparse":
            raise ValueError(
                "delta_bits compresses the SPARSE id+value exchange's id stream (the "
                f"exchange planner); exchange={exchange!r} ships whole slabs — use "
                "exchange='sparse'")
        if predict and exchange != "sparse":
            raise ValueError("predict arms the sparse exchange's history predictor — use "
                             "exchange='sparse'")
        if isinstance(mesh, Mesh2D):
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
            world = mesh.world
        else:
            world = mesh = resolve_mesh(mesh, device)
        self.mesh, self._world, self.device = mesh, world, world.device
        p_count, p = world.num_shards, world.rank
        self.sell = sell = (build_ell_sharded(graph, p_count, kcap=kcap) if shard is None
                            else shard)
        if sell.num_shards != p_count:
            raise ValueError(f"ELL built for {sell.num_shards} shards, mesh has {p_count}")
        self.host_graph = graph
        self.lanes = int(lanes)
        self.num_vertices = graph.num_vertices
        self.undirected = graph.undirected
        self.max_rounds = int(max_rounds)
        self._exchange = exchange
        self.predict = bool(predict)
        if delta <= 0:
            delta = max(1, int(round(float(graph.weights.mean())))) \
                if len(graph.weights) else 1
        self.delta = int(delta)
        # The table is rank order (vertex v's row is rank[v]); every vertex
        # has a row, so the table is the result as it stands.
        self._act = sell.v_pad
        self._rank = sell.rank.astype(np.int64)
        self._table_rows = sell.v_pad + 1  # + the all-INF sentinel row
        src, dst = graph.coo
        seen = np.zeros(graph.num_vertices, dtype=bool)
        seen[src] = True
        seen[dst] = True
        self._iso_mask = ~seen
        self.delta_bits = check_delta_bits(delta_bits)
        self.sparse_caps = resolve_row_caps(sparse_caps, sell.v_loc, self.lanes,
                                            self.delta_bits)
        self._nb = (minplus_rows_branch_count(self.sparse_caps, self.delta_bits,
                                              predict=self.predict)
                    if exchange == "sparse" else 1)
        self.arrs = self._build_arrays(
            p, build_ell_weights_sharded(graph, sell) if weights is None else weights)
        spec = ExpandSpec(
            kcap=sell.kcap, heavy=sell.heavy_per_shard > 0, num_virtual=sell.num_virtual,
            fold_steps=sell.fold_steps, light_meta=tuple((k, b.shape[1]) for k, b in sell.light),
            tail_rows=sell.tail_rows,
        )
        self._spec = spec
        self._expand_light = make_expand(spec, self.lanes, op="minplus", wsuf="wl")
        self._expand_full = make_expand(spec, self.lanes, op="minplus", wsuf="w")
        self._dist_core, self._dist_close = self._light_step, self._close_step
        self.last_host_reads = None
        self.last_closes = None
        self.last_exchange_level_counts = None
        self.last_exchange_bytes = None
        self._warmed = False

    def _build_arrays(self, p: int, weights) -> dict:
        """This rank's kernel tables: the index slabs as the wide mesh
        engine builds them (pad slots gather the sentinel row ``v_pad``) and
        per bucket the weight planes slot-aligned with them,
        ``{bucket}_w_gt`` (every edge) and ``{bucket}_wl_gt`` (light edges;
        heavy slots INF_W, absorbed under min), padded with weight 0."""
        sell = self.sell
        heavy = sell.virtual is not None
        arrs = shard_expand_arrays(
            sell.virtual[p].T if heavy else None, sell.fold_pad_map[p] if heavy else None,
            sell.heavy_pick[p] if heavy else None, [b[p].T for _k, b in sell.light],
            sell.v_pad, self.device)
        vw, lw = weights
        planes = ([("virtual", vw[p])] if vw is not None else []) + [
            (f"light{i}", w[p]) for i, w in enumerate(lw)]
        for name, w in planes:
            wt = pad_gate_blocks(w.T, 0)  # pad weight 0 stays 0 in wl (0 <= delta)
            wl = np.where(wt <= self.delta, wt, INF_W).astype(np.int32)
            for suf, plane in (("w", wt), ("wl", wl)):
                arrs[f"{name}_{suf}_gt"] = torch.from_numpy(plane).to(self.device)
        return arrs

    # --- the rank-local programs (the AOT inventory) -------------------------

    @property
    def _aot_world(self):
        return self._world

    def _aot_layout_of(self) -> dict:
        sell = self.sell
        return {"expand": plain_ints(self._spec), "v_loc": int(sell.v_loc),
                "v_pad": int(sell.v_pad), "lanes": self.lanes, "delta": self.delta}

    def _aot_programs(self):
        """The AOT inventory: ``dist_sssp_core`` (JAX's name), the light
        sweep :meth:`_light_step`, and ``dist_sssp_close``, the heavy close
        :meth:`_close_step`, over this rank's tables; the distance tables
        are :class:`ArgSpec`."""
        sell, dev, lanes = self.sell, self.device, self.lanes
        table = ArgSpec((sell.v_pad + 1, lanes), torch.int32, dev)
        own = ArgSpec((sell.v_loc, lanes), torch.int32, dev)

        def orig(attr):
            fn = getattr(self, attr)
            return getattr(fn, "_aot_original", fn)

        return [("dist_sssp_core", "_dist_core", orig("_dist_core"),
                 (self.arrs, table, ArgSpec((), torch.int32, dev))),
                ("dist_sssp_close", "_dist_close", orig("_dist_close"),
                 (self.arrs, table, own))]

    def _light_step(self, arrs, dist, hi):
        """The light sweep on this rank: the current bucket and the settled
        rows of the replicated ``dist`` relax out (later buckets masked to
        INF, the delta-stepping invariant) over the light edges into the
        rank's own rows. Returns ``(masked, new_loc, changed)``: the masked
        table (the heavy close reads it), the own rows' new distances
        (never above the old), and whether any own row changed ([1] int32,
        for the host's all-reduce). ``hi`` is the bucket bound, a 0-d
        device int32."""
        masked = dist.masked_fill(dist >= hi, int(INF_W))
        own_prev = self._own(dist)
        new_loc = self._expand_light(arrs, masked)
        torch.minimum(own_prev, new_loc, out=new_loc)
        return masked, new_loc, (new_loc < own_prev).any().to(torch.int32).reshape(1)

    def _close_step(self, arrs, masked, new_loc):
        """The heavy close: one relaxation of the masked table over every
        edge into the own rows, min'd with the light sweep's."""
        full = self._expand_full(arrs, masked)
        return torch.minimum(new_loc, full, out=full)

    def wire_bytes_per_level(self) -> list[float]:
        """Modeled bytes one rank moves a round, per exchange branch."""
        p, v_loc = self.sell.num_shards, self.sell.v_loc
        if self._exchange == "sparse":
            return minplus_rows_wire_bytes_per_level(p, v_loc, self.lanes, self.sparse_caps,
                                                     self.delta_bits, predict=self.predict)
        return [dense_min_wire_bytes(p, v_loc, self.lanes)]

    def exchange_branch_labels(self) -> list[str]:
        if self._exchange == "sparse":
            return minplus_rows_branch_labels(self.sparse_caps, self.delta_bits,
                                              predict=self.predict)
        return ["dense"]

    def _iso_of(self, sources: np.ndarray):
        # Every vertex has a row, so results are right as they stand; the
        # mask labels the lanes the single-device engine gives no row.
        return self._iso_mask[np.asarray(sources, np.int64)]

    def _own(self, table: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a rank-order table (global rank r lives on
        rank r % P at local row r // P), a [v_loc, L] view."""
        sell = self.sell
        return table[: sell.v_pad].view(sell.v_loc, sell.num_shards, self.lanes)[
            :, self._world.rank]

    def _dense_gather(self, new_loc: torch.Tensor) -> torch.Tensor:
        """The next table from every rank's own rows, all-gathered."""
        sell, p_count = self.sell, self.sell.num_shards
        out = torch.empty((sell.v_pad + 1, self.lanes), dtype=torch.int32, device=self.device)
        out[sell.v_pad] = int(INF_W)
        if p_count == 1:
            out[: sell.v_pad].copy_(new_loc)
        else:
            g = self._world.all_gather_rows(new_loc)  # chip-major
            out[: sell.v_pad].view(sell.v_loc, p_count, self.lanes).copy_(
                g.view(p_count, sell.v_loc, self.lanes).transpose(0, 1))
        return out

    def _exchange_round(self, new_loc, dist, own_prev, prev_biggest: int, growing: bool):
        """The next replicated table from every rank's ``new_loc``: ``(table,
        branch, biggest, host reads)``."""
        world, sell = self._world, self.sell
        if self._exchange == "sparse":
            if self.predict and prev_biggest > self.sparse_caps[-1] and growing:
                return self._dense_gather(new_loc), self._nb - 1, prev_biggest, 0
            changed = (new_loc < own_prev).any(dim=1)
            vals = world.all_reduce_(row_gather_flags(changed, self.delta_bits), "max").tolist()
            branch = rows_gather_branch(vals[0], vals[-1], self.sparse_caps, self.delta_bits)
            rung = branch_rung(branch, self.sparse_caps, self.delta_bits)
            if rung is None:
                return self._dense_gather(new_loc), branch, vals[0], 1
            p_count, p = world.num_shards, world.rank
            table = dist.clone()
            sparse_rows_exchange_min(
                world, new_loc, changed, table, cap=rung[0], bits=rung[1], out_rows=sell.v_pad,
                gid_of=lambda ids: ids * p_count + p, ident=int(INF_W),
                gid_of_src=lambda ids, src: ids * p_count + src)
            return table, branch, vals[0], 1
        # The previous table with this rank's rows substituted: the MIN over
        # the ranks is the next table (new <= prev on own rows, and every
        # other rank holds prev there). The sentinel row is INF everywhere.
        table = dist.clone()
        self._own(table).copy_(new_loc)
        if self._exchange == "allreduce":
            for m in (self.mesh.r, self.mesh.c) if isinstance(self.mesh, Mesh2D) else (world,):
                m.all_reduce_(table, "min")
        elif world.num_shards > 1:
            chunk = ring_reduce_scatter(table[: sell.v_pad], world, torch.minimum)
            world.all_gather_rows(chunk, out=table[: sell.v_pad])
        return table, 0, prev_biggest, 0

    def _core(self, dist: torch.Tensor, max_rounds: int):
        """The delta-stepping loop over the replicated ``dist`` (consumed).
        Returns ``(dist, rounds, alive)``; records the host reads, the
        closes and the exchange's branch counts and modeled bytes."""
        inf, delta, world = int(INF_W), self.delta, self._world
        hi, rounds, alive, reads, closes = delta, 0, True, 0, 0
        counts = np.zeros(self._nb, dtype=np.int32)
        # The predictor's carries: the last measured changed-row count, and
        # the changed rows of the last two rounds (replicated: every rank
        # counts them on its copy of the table).
        prev_biggest = 0
        pc = ppc = torch.zeros((), dtype=torch.int32, device=self.device)
        hi_t = torch.full((), hi, dtype=torch.int32, device=self.device)
        while alive and rounds < max_rounds:
            # The programs are read anew each round: adopted ones take over.
            masked, new_loc, changed = self._dist_core(self.arrs, dist, hi_t)
            own_prev = self._own(dist)
            flags = world.all_reduce_(changed, "sum")
            if self.predict:
                flags = torch.cat([flags, (pc > ppc).to(torch.int32).reshape(1)])
            changed_l, *grow = flags.tolist()  # the round's first read
            reads += 1
            if not changed_l:
                # The bucket is stable everywhere, so ``masked`` is the
                # post-light table's: one relaxation over ALL edges (the
                # heavy close) before the bound advances.
                new_loc = self._dist_close(self.arrs, masked, new_loc)
            del masked
            nxt, branch, prev_biggest, xreads = self._exchange_round(
                new_loc, dist, own_prev, prev_biggest, bool(grow and grow[0]))
            del new_loc, own_prev
            counts[branch] += 1
            reads += xreads
            if self.predict:
                ppc, pc = pc, (nxt < dist).any(dim=1).sum(dtype=torch.int32)
            if not changed_l:
                hi += delta
                hi_t = hi_t + delta
                # Finite distances at or above the bound still need
                # bucketing; with none and no change, the loop is done.
                # The close round's second read, of tables every rank holds
                # replicated after the exchange.
                alive = bool(torch.stack([  # uniform: nxt and dist are replicated tables
                    (nxt < dist).any(), ((nxt < inf) & (nxt >= hi)).any(),
                ]).any())
                reads += 1
                closes += 1
            dist = nxt
            rounds += 1
        self.last_host_reads, self.last_closes = reads, closes
        self.last_exchange_level_counts = counts
        self.last_exchange_bytes = float(np.dot(counts, self.wire_bytes_per_level()))
        return dist, rounds, alive
