"""Dynamic graphs: streaming edge updates over the frozen ELL base, the
port of ``tpu_bfs/graph/dynamic.py``.

Every engine's bucketed ELL tables are immutable: rebuilding them per edge
update would cost an ELL build per batch. The serve tier mutates a
two-layer representation instead:

- the **base**: the immutable ELL generation every engine was built over;
- a **bounded dense delta overlay**: up to ``rows`` mutated rank-rows of up
  to ``kcap`` neighbor slots each, uploaded as fixed-shape device tables
  (``ov_rows``/``ov_idx``/``ov_override``, plus the ``ov_w`` weights plane
  for sssp), which the expansion folds in AFTER the base expansion: an
  *augment* row ORs (mins) its added neighbors into the base row's output,
  an *override* row REPLACES the base row's output with its full current
  neighbor list, the only sound encoding of a removal (an OR or min
  contribution cannot be subtracted).

A mutation batch swaps table VALUES under the engines (one atomic ``arrs``
dict rebind). The overlay is bounded; when a batch would exceed it, or
touch a vertex the base ranked inactive (no table row exists to override),
the mutation forces a COMPACTION: the overlay folds into a new base
generation persisted through the checkpoint files' atomic save and payload
CRC (:class:`GenerationStore`), engines rebuild over the verified artifact,
and the overlay empties. A crash mid-compaction leaves the previous
generation's files and ``CURRENT`` pointer intact; a corrupt new generation
is quarantined ``.corrupt`` at load and serving stays on base + overlay.
The files are the JAX package's: either package loads the other's.

``generation`` bumps on EVERY applied mutation batch: it is the serve
tier's cache and landmark invalidation key, not a compaction counter.
Compaction is answer-neutral.

Correctness contract of the fold:

- overlay neighbor ids are RANKS of the base ranking (``graph/ell.py``
  ``rank_vertices``, a pure function of the base edge set shared by every
  engine over the same base), all ``< num_active``;
- pad rows carry ``row = act`` (the engines' all-identity sentinel row)
  with override=1 and all-sentinel neighbor slots, so a pad row folds to
  the combine identity and writes identity back into the sentinel row;
- real overlay rows are unique (the host guarantees it), so the scatter's
  only duplicate targets are pad rows writing identical identity values.

Scope: undirected bases and single-device engines (the wide engine the
bfs, cc and khop kinds ride, and ``SsspEngine``). The pull gate does not
compose with an overlay (it would skip overlay edges) and raises at engine
construction. The fold is plain PyTorch after K1's bucket launches, as it
is a ``jnp`` epilogue outside any Pallas kernel in JAX.
"""

from __future__ import annotations

import os
import threading
import zlib

import numpy as np
import torch

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch import obs as _obs
from tpu_bfs_torch.graph.csr import Graph, build_csr
from tpu_bfs_torch.graph.ell import rank_vertices
from tpu_bfs_torch.ops.ell_expand import MINPLUS_IDENT

#: Overlay table keys every folding engine consumes ("or" kinds).
OVERLAY_KEYS = ("ov_rows", "ov_idx", "ov_override")
#: The sssp engine also consumes the weights plane (it derives its own
#: light plane ``ov_wl`` from ``ov_w`` and its delta).
WEIGHTED_OVERLAY_KEYS = OVERLAY_KEYS + ("ov_w",)

#: Default overlay capacity: (mutated rows, neighbor slots per row).
DEFAULT_CAPACITY = (256, 16)


class OverlayCapacityError(RuntimeError):
    """A mutation batch does not fit the bounded overlay (too many dirty
    rows, a row past ``kcap`` slots, or a base-inactive vertex touched):
    the caller must compact into a new base generation and retry."""


def empty_overlay_tables(capacity, act: int, *, weighted: bool = False):
    """All-pad host tables for an engine built with an overlay but no
    mutations yet: every row targets the sentinel row ``act`` with
    override=1 and all-sentinel slots, so the fold computes the combine
    identity and writes it into the row that is already identity."""
    rows, kcap = int(capacity[0]), int(capacity[1])
    out = {
        "ov_rows": np.full(rows, act, np.int32),
        "ov_idx": np.full((rows, kcap), act, np.int32),
        "ov_override": np.ones(rows, np.int32),
    }
    if weighted:
        # Pad weight 0: the slot gathers the all-INF sentinel row and
        # INF + 0 absorbs under min.
        out["ov_w"] = np.zeros((rows, kcap), np.int32)
    return out


def overlay_crc32(tables: dict) -> int:
    """CRC32 over the staged overlay tables, computed when the host stages
    a mutation batch and checked again just before the swap, so a
    corruption in between (the ``corrupt_overlay`` fault kind, or a real
    host-memory flip) is caught before any engine folds a torn table."""
    crc = 0
    for name in sorted(tables):
        arr = np.ascontiguousarray(tables[name])
        crc = zlib.crc32(f"{name}:{arr.dtype.str}:{arr.shape}".encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    return crc


def device_overlay_tables(tables: dict, capacity, device, *, weighted: bool = False) -> dict:
    """The engine-side copy of host overlay tables: shapes checked against
    the armed ``capacity``, index tables as int64 (torch's gather and
    scatter index type), the override flags and weights as int32."""
    rows, kcap = int(capacity[0]), int(capacity[1])
    keys = WEIGHTED_OVERLAY_KEYS if weighted else OVERLAY_KEYS
    out = {}
    for name in keys:
        arr = np.asarray(tables[name], np.int32)
        want = (rows, kcap) if name in ("ov_idx", "ov_w") else (rows,)
        if arr.shape != want:
            raise ValueError(f"{name} shape {arr.shape} != armed capacity {want}")
        dtype = torch.int64 if name in ("ov_rows", "ov_idx") else torch.int32
        out[name] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return out


def make_overlay_fold(expand, *, op: str, weights_key: str | None = None):
    """Wrap a bucketed-ELL ``expand(arrs, fw) -> [rows, w]`` (a fresh
    tensor) with the overlay fold:

    - gather the base output at the overlay rows;
    - override rows replace it with the combine identity;
    - fold the overlay neighbor slots (``op='or'``: OR of frontier rows;
      ``op='minplus'``: min of ``dist[nbr] + w`` over the ``weights_key``
      plane);
    - scatter ``combine(current, folded)`` back into the overlay rows, in
      place in the expansion's output.

    Pad rows (sentinel row, override=1, all-sentinel slots) compute the
    identity and write it into the already-identity sentinel row."""
    if op not in ("or", "minplus"):
        raise ValueError(f"op must be 'or' or 'minplus', got {op!r}")
    if op == "minplus" and not weights_key:
        raise ValueError("op='minplus' needs a weights_key plane")
    inf = MINPLUS_IDENT

    def folded(arrs, fw):
        base = expand(arrs, fw)
        rows = arrs["ov_rows"]  # [D] int64
        idx = arrs["ov_idx"]  # [D, ko] int64
        ovr = (arrs["ov_override"] != 0)[:, None]  # [D, 1]
        d, ko = idx.shape
        # One gather of every slot's frontier (or distance) row, [D, ko, w].
        nbr = fw.index_select(0, idx.reshape(-1)).view(d, ko, fw.shape[1])
        cur = base.index_select(0, rows)
        if op == "or":
            # OR over the slots as a halving tree (bitwise OR has no torch
            # reduction): an odd middle slot waits for the next halving.
            n = ko
            while n > 1:
                h = n // 2
                nbr[:, :h] |= nbr[:, n - h:n]
                n -= h
            merged = cur.masked_fill_(ovr, 0) | nbr[:, 0]
        else:
            # min over the slots of dist[nbr] + w, no larger than the
            # identity (as JAX's loop from INF_W, which equals MINPLUS_IDENT).
            add = (nbr + arrs[weights_key][:, :, None]).amin(dim=1).clamp_(max=inf)
            merged = torch.minimum(cur.masked_fill_(ovr, inf), add)
        return base.index_copy_(0, rows, merged)

    return folded


class DynamicGraph:
    """Host-side truth of a mutating graph: the immutable base plus the
    current overlay rows, with ``apply`` staging bounded device tables and
    ``compact`` folding them into a new persisted base generation.

    Thread-safe: the serve tier applies mutation batches from request
    threads while the staleness auditor materializes oracles; one lock
    guards the host state."""

    def __init__(self, graph: Graph, *, capacity=DEFAULT_CAPACITY, log=None):
        if not graph.undirected:
            raise ValueError(
                "dynamic graphs support undirected bases (v1): the "
                "overlay encodes symmetric row updates; a directed "
                "in-neighbor overlay needs the reverse-CSR plumbing"
            )
        rows, kcap = int(capacity[0]), int(capacity[1])
        if rows < 1 or kcap < 1:
            raise ValueError(f"overlay capacity must be >= (1, 1), got {capacity}")
        self.capacity = (rows, kcap)
        self.log = log or (lambda msg: None)
        self.generation = 0
        self.compactions = 0
        self._lock = threading.RLock()
        with self._lock:
            self._set_base(graph)

    # --- base bookkeeping -------------------------------------------------

    def _set_base(self, graph: Graph) -> None:  # requires-lock: _lock
        self.base = graph
        src, dst = graph.coo
        _, self._act, _, self._rank = rank_vertices(src, dst, graph.num_vertices)
        self._cur: dict = {}  # dirty vertex -> {neighbor: weight}
        self._edges_delta = 0
        self._graph_cache = graph
        # materialize splices rows of a base whose rows list their neighbors
        # in ascending order; an unsorted base is sorted once here (a stable
        # (row, neighbor) sort, so parallel slots keep their order, which
        # gives build_csr's arrays).
        ci = np.asarray(graph.col_idx)
        starts = np.zeros(len(ci) + 1, dtype=bool)
        starts[graph.row_ptr] = True
        if starts[np.flatnonzero(ci[1:] < ci[:-1]) + 1].all():
            self._sorted_base = graph
        else:
            self._sorted_base = build_csr(
                src, dst, graph.num_vertices, num_input_edges=graph.num_input_edges,
                undirected=True, weights=graph.weights,
            )

    def _base_row(self, v: int) -> dict:
        """Canonical base neighbor map of ``v``: parallel slots collapse to
        their minimum weight (idempotent under OR and min-plus alike)."""
        g = self.base
        lo, hi = int(g.row_ptr[v]), int(g.row_ptr[v + 1])
        nbrs = g.col_idx[lo:hi]
        if g.weights is None:
            return {int(n): 1 for n in nbrs}
        row: dict = {}
        for n, w in zip(nbrs.tolist(), g.weights[lo:hi].tolist()):
            n = int(n)
            if n not in row or w < row[n]:
                row[n] = int(w)
        return row

    @property
    def weighted(self) -> bool:
        return self.base.weights is not None

    def overlay_rows_used(self) -> int:
        with self._lock:
            return sum(1 for v in self._cur if self._cur[v] != self._base_row(v))

    # --- mutation ---------------------------------------------------------

    def apply(self, add=(), remove=()):
        """Apply one mutation batch to the host truth and stage the full
        overlay tables. ``add`` items are ``(u, v)`` or ``(u, v, w)``;
        ``remove`` items are ``(u, v)`` (all parallel slots of the pair go).
        Adding an existing edge with a new weight re-weights it. Returns
        ``(tables, stats)`` and bumps ``generation``. Raises
        :class:`OverlayCapacityError` when the batch needs a compaction
        first (the caller compacts and re-applies); the overlay, the
        generation and the tables are then unchanged, but the edge count
        has already moved by the batch's edges, as in the JAX package
        (ROADMAP Queue 3)."""
        with self._lock:
            staged = self._stage(add, remove)
            tables, used = self._build_tables(staged)
            # Commit only after staging fit: host truth and the staged
            # tables flip together or not at all.
            self._cur = staged
            self.generation += 1
            self._graph_cache = None
            stats = {
                "generation": self.generation,
                "overlay_rows": used,
                "capacity": self.capacity,
            }
            return tables, stats

    def _stage(self, add, remove) -> dict:  # requires-lock: _lock
        n = self.base.num_vertices
        staged = {v: dict(row) for v, row in self._cur.items()}

        def row_of(v):
            row = staged.get(v)
            if row is None:
                row = staged[v] = self._base_row(v)
            return row

        def check_active(v):
            v = int(v)
            if not (0 <= v < n):
                raise ValueError(f"vertex {v} out of range [0, {n})")
            if self._rank[v] >= self._act:
                raise OverlayCapacityError(
                    f"vertex {v} is inactive in the base ranking (no "
                    f"table row to override) — compaction required"
                )
            return v

        for edge in add:
            u, v = check_active(edge[0]), check_active(edge[1])
            w = int(edge[2]) if len(edge) > 2 else 1
            if w < 1:
                raise ValueError(f"edge weight must be >= 1, got {w}")
            if self.weighted:
                if row_of(u).get(v) != w:
                    row_of(u)[v] = w
                    row_of(v)[u] = w
                    self._edges_delta += 1
            elif v not in row_of(u):
                row_of(u)[v] = 1
                row_of(v)[u] = 1
                self._edges_delta += 1
        for edge in remove:
            u, v = check_active(edge[0]), check_active(edge[1])
            if v in row_of(u):
                row_of(u).pop(v, None)
                row_of(v).pop(u, None)
                self._edges_delta -= 1
        # The edge count moves as the batch stages, as in JAX, even when
        # the batch then raises (ROADMAP Queue 3): materialize's
        # num_input_edges stays the reference's.
        # Drop rows that reverted to their base content.
        return {v: row for v, row in staged.items() if row != self._base_row(v)}

    def _build_tables(self, cur: dict):  # requires-lock: _lock
        rows_cap, kcap = self.capacity
        weighted = self.weighted
        tables = empty_overlay_tables(self.capacity, self._act, weighted=weighted)
        used = 0
        for v, row in sorted(cur.items()):
            base_row = self._base_row(v)
            if row == base_row:
                continue
            added = {n: w for n, w in row.items() if base_row.get(n) != w}
            removed = any(n not in row for n in base_row)
            override = removed or any(
                n in base_row and base_row[n] != w for n, w in added.items()
            )
            slots = row if override else added
            if len(slots) > kcap:
                raise OverlayCapacityError(
                    f"vertex {v} needs {len(slots)} overlay slots "
                    f"(kcap={kcap}) — compaction required"
                )
            if used >= rows_cap:
                raise OverlayCapacityError(
                    f"mutation set needs more than {rows_cap} overlay "
                    f"rows — compaction required"
                )
            tables["ov_rows"][used] = self._rank[v]
            tables["ov_override"][used] = 1 if override else 0
            for j, (nbr, w) in enumerate(sorted(slots.items())):
                tables["ov_idx"][used, j] = self._rank[nbr]
                if weighted:
                    tables["ov_w"][used, j] = w
            used += 1
        return tables, used

    # --- the from-scratch oracle -----------------------------------------

    def materialize(self) -> Graph:
        """The current graph as an immutable :class:`Graph`: what a
        from-scratch rebuild would serve, and what the parity tests build
        fresh engines over."""
        with self._lock:
            if self._graph_cache is None:
                self._graph_cache = self._splice()
            return self._graph_cache

    def _num_input_edges(self) -> int:  # requires-lock: _lock
        return max(self.base.num_input_edges + self._edges_delta, 0)

    def _splice(self) -> Graph:  # requires-lock: _lock
        """``build_csr``'s graph over the untouched base slots and the dirty
        rows, without its sort: untouched rows of the row-sorted base move
        whole to their new offsets (a stable sort by (row, neighbor) keeps
        their slots, parallel ones too, in order) and each dirty row is
        written from its sorted neighbor map."""
        g = self._sorted_base
        deg = np.diff(g.row_ptr)
        dirty = np.asarray(sorted(self._cur), dtype=np.int64)
        new_deg = deg.copy()
        new_deg[dirty] = [len(self._cur[int(v)]) for v in dirty]
        row_ptr = np.zeros(g.num_vertices + 1, dtype=np.int64)
        np.cumsum(new_deg, out=row_ptr[1:])
        col_idx = np.empty(int(row_ptr[-1]), dtype=np.int32)
        weights = None if g.weights is None else np.empty(len(col_idx), dtype=np.int32)
        keep = np.ones(g.num_vertices, dtype=bool)
        keep[dirty] = False
        slot_keep = np.repeat(keep, deg)
        src = np.flatnonzero(slot_keep)
        dst = src + np.repeat(row_ptr[:-1] - g.row_ptr[:-1], deg)[slot_keep]
        col_idx[dst] = g.col_idx[src]
        if weights is not None:
            weights[dst] = g.weights[src]
        for v in dirty.tolist():
            row = self._cur[v]
            nbrs = sorted(row)
            lo, hi = int(row_ptr[v]), int(row_ptr[v + 1])
            col_idx[lo:hi] = nbrs
            if weights is not None:
                weights[lo:hi] = [row[n] for n in nbrs]
        return Graph(row_ptr=row_ptr, col_idx=col_idx, num_input_edges=self._num_input_edges(),
                     undirected=True, weights=weights)

    # --- compaction -------------------------------------------------------

    def compact(self, store: "GenerationStore") -> Graph:
        """Fold the overlay into a new persisted base generation:
        materialize, atomic CRC save, verified load, adopt as base (the
        overlay empties). The ``CURRENT`` pointer only advances after the
        reloaded artifact verified, so every failure rolls back: a crash
        (or the raising ``compaction_crash`` fault kind at the ``compact``
        site) before the pointer leaves the previous generation intact,
        and a corrupt new generation is quarantined ``.corrupt`` at load
        (CorruptCheckpointError) with the pointer still on the old files.
        Returns the VERIFIED loaded graph: engines rebuild from the
        artifact that proved round-trippable, not the in-memory twin."""
        with self._lock:
            gen_id = store.next_generation_id()
            g = self.materialize()
            with _obs.maybe_span("compact", f"gen{gen_id}", cat="graph.dynamic",
                                 generation=gen_id):
                path = store.save(gen_id, g)
                if _faults.ACTIVE is not None:
                    # The fault site "compact": compaction_crash raises here,
                    # after the new generation's files are on disk and before
                    # CURRENT advances, the window a real crash leaves.
                    _faults.ACTIVE.hit("compact", generation=gen_id)
                loaded = store.load(gen_id)  # raises CorruptCheckpointError
                store.set_current(gen_id)
            self.compactions += 1
            self._set_base(loaded)
            self._graph_cache = loaded
            self.log(
                f"compacted into generation artifact {path} "
                f"(gen_id={gen_id}, V={loaded.num_vertices}, "
                f"E={loaded.num_edges})"
            )
            return loaded

    def overlay_tables(self):
        """Re-stage the CURRENT overlay from host truth (no generation
        bump): the recovery after a staged-table corruption caught by
        :func:`overlay_crc32`, and the torn-flip heal."""
        with self._lock:
            tables, _used = self._build_tables(self._cur)
            return tables


class GenerationStore:
    """On-disk base generations through the checkpoint machinery:
    ``gen_NNNN.npz`` written by ``_atomic_savez`` (temp file, rename,
    payload CRC embedded, ``ckpt_save`` fault site inside), loaded by
    ``_load_npz_verified`` (decode or CRC failures rename ``.corrupt`` and
    raise), with a ``CURRENT`` pointer file replaced atomically LAST: the
    commit point a crash can only land before."""

    def __init__(self, root: str, *, log=None):
        self.root = root
        self.log = log or (lambda msg: None)
        os.makedirs(root, exist_ok=True)

    def _path(self, gen_id: int) -> str:
        return os.path.join(self.root, f"gen_{gen_id:04d}.npz")

    def next_generation_id(self) -> int:
        cur = self.current()
        return (cur if cur is not None else 0) + 1

    def save(self, gen_id: int, graph: Graph) -> str:
        from tpu_bfs_torch.utils.checkpoint import _atomic_savez

        path = self._path(gen_id)
        arrays = {
            "row_ptr": np.asarray(graph.row_ptr),
            "col_idx": np.asarray(graph.col_idx),
            "meta": np.asarray([graph.num_input_edges, int(graph.undirected)], np.int64),
        }
        if graph.weights is not None:
            arrays["weights"] = np.asarray(graph.weights)
        _atomic_savez(path, **arrays)
        return path

    def load(self, gen_id: int) -> Graph:
        from tpu_bfs_torch.utils.checkpoint import _load_npz_verified

        arrays = _load_npz_verified(self._path(gen_id))
        meta = arrays["meta"]
        return Graph(
            row_ptr=np.asarray(arrays["row_ptr"]),
            col_idx=np.asarray(arrays["col_idx"]),
            num_input_edges=int(meta[0]),
            undirected=bool(meta[1]),
            weights=(np.asarray(arrays["weights"]) if "weights" in arrays else None),
        )

    def set_current(self, gen_id: int) -> None:
        """Advance the commit pointer, atomically, and only ever AFTER the
        generation's payload verified (the caller's contract)."""
        tmp = os.path.join(self.root, ".CURRENT.tmp")
        with open(tmp, "w") as f:
            f.write(f"{gen_id}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, "CURRENT"))

    def current(self) -> int | None:
        try:
            with open(os.path.join(self.root, "CURRENT")) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def quarantine_orphans(self) -> list:
        """Crash recovery: a compactor that died after ``save`` but before
        ``set_current`` (the ``compaction_crash`` window) leaves generation
        files NEWER than the commit pointer. They never verified, so they
        are renamed ``.corrupt`` and never served; returns their paths."""
        cur = self.current() or 0
        out = []
        for name in sorted(os.listdir(self.root)):
            if not (name.startswith("gen_") and name.endswith(".npz")):
                continue
            try:
                gen_id = int(name[4:-4])
            except ValueError:
                continue
            if gen_id <= cur:
                continue
            path = os.path.join(self.root, name)
            corrupt = path + ".corrupt"
            try:
                os.replace(path, corrupt)
            except OSError:
                continue
            self.log(
                f"quarantined orphan generation artifact {name} -> "
                f"{corrupt} (newer than the CURRENT pointer: a dead "
                f"compactor's uncommitted write)"
            )
            out.append(corrupt)
        return out
