"""The rank group of the mesh engines and its launcher, the port of
``tpu_bfs/parallel/dist_bfs.py:make_mesh``.

JAX drives a mesh from one controller: ``make_mesh(n)`` names n devices
and one ``shard_map`` program runs on all of them. Here every rank is a
process of its own, holding one device: NCCL with rank r on ``cuda:r``, or
gloo on the CPU. Each rank builds its own shard and runs the same code.

- :func:`make_mesh` is called inside a rank: it joins the default process
  group that exists (``launch``'s children, or ``torchrun``), or, for one
  rank, creates a one-rank group through a ``file://`` rendezvous.
- :func:`launch` (and :func:`start`, which returns before the ranks end)
  spawns n ranks, runs ``fn(mesh, *args)`` in each and returns rank 0's
  value: the counterpart of JAX's single-controller ``make_mesh(n)`` for
  the CLI, Graph500, the tests and ``chip_smoke.py``.
- :func:`serve_mesh` makes the calling process rank 0 and spawns ranks
  1 .. n-1 as followers that replay rank 0's ordered command stream
  (:class:`MeshController`, :class:`Remote`): the serve tier's mesh, whose
  rank 0 keeps stdin and its threads.

Asking for more CUDA ranks than there are cards raises, as JAX's
``make_mesh`` does; nothing moves to the CPU. Several ranks may share one
card only when its index is named (``device="cuda:0"``), on gloo: NCCL
refuses two ranks on one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import inspect
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

#: Collective time limit of a group (gloo and NCCL both honour it).
GROUP_TIMEOUT_S = 600

# all_gather_single is all_gather_into_tensor's newer name (same signature).
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}

#: The wire tap of this process (``analysis/graph.WireTap``), or None: when
#: set, each of :class:`Mesh`'s four collectives records one
#: ``analysis/graph.Collective`` before it runs; when None, it costs one
#: check a call.
_TAP = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1D mesh: ``num_shards`` ranks of one process
    group, this process being ``rank`` on ``device``. ``group`` is the
    process group (None: the default one) and ``members`` its global ranks
    in group order (None: 0 .. num_shards - 1); a 2D mesh's row and column
    views (:class:`Mesh2D`) are meshes over subgroups."""

    num_shards: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    members: tuple | None = None

    def _peer(self, idx: int) -> int:
        """The global rank of group member ``idx``."""
        return idx if self.members is None else self.members[idx]

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether a send, recv or all-to-all of ``t`` goes through host
        memory: that of gloo ranks sharing a card (their all-gathers and
        all-reduces take the CUDA tensors directly)."""
        return self.backend == "gloo" and t.is_cuda

    def all_gather_rows(self, t: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """[P * n, ...]: every rank's ``t`` ([n, ...], the same shape on
        every rank) stacked in rank order (the JAX ``lax.all_gather``
        flattened on its leading axis), into ``out`` (contiguous) if given."""
        if _TAP is not None:
            _TAP.record(self, "all-gather", t)
        if out is None:
            out = torch.empty((self.num_shards * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
        if self.num_shards == 1 and self.group is not None:
            out.copy_(t)  # a one-rank subgroup: nothing crosses a wire
            return out
        _all_gather_single(out, t.contiguous(), group=self.group)
        return out

    def all_reduce_(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced in place over the ranks (``op`` 'max', 'sum' or
        'min'; the JAX ``lax.pmax``/``psum``/``pmin``); returns ``t``."""
        if _TAP is not None:
            _TAP.record(self, "all-reduce", t)
        if self.num_shards == 1 and self.group is not None:
            return t
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The JAX ``lax.all_to_all`` of a [P, ...] tensor: row j goes to
        rank j, and row j of the result came from rank j."""
        if _TAP is not None:
            _TAP.record(self, "all-to-all", t)
        if self.num_shards == 1:
            return t.clone()
        src = t.contiguous()
        if self._staged(src):  # one payload on the wire, recorded once above
            return self._all_to_all(src.cpu()).to(t.device)
        return self._all_to_all(src)

    def _all_to_all(self, src: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ring rotation of the JAX ``lax.ppermute`` with pairs
        (i, i + 1): ``t`` goes to rank + 1 and the returned tensor came
        from rank - 1. The identity on one rank."""
        if _TAP is not None:
            _TAP.record(self, "collective-permute", t)
        if self.num_shards == 1:
            return t
        if self._staged(t):  # one payload on the wire, recorded once above
            return self._ring_shift(t.cpu()).to(t.device)
        return self._ring_shift(t)

    def _ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        p = self.num_shards
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t.contiguous(), self._peer((self.rank + 1) % p),
                          self.group),
               dist.P2POp(dist.irecv, out, self._peer((self.rank - 1) % p), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's view of an R x C mesh, the counterpart of JAX's
    ``make_mesh_2d`` with axes ('r', 'c'). Global rank k sits at (k // C,
    k % C), row-major. ``r`` is the mesh over this rank's mesh column (the
    ranks that differ in row index; its rank is i), the axis of the column
    all-gather; ``c`` is the mesh over its mesh row (rank j), the axis of
    the row reduce-scatter; ``world`` spans the whole mesh."""

    rows: int
    cols: int
    world: Mesh
    r: Mesh
    c: Mesh

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def num_shards(self) -> int:
        """The mesh's rank count (the fault sites' ``devices``)."""
        return self.rows * self.cols


def make_mesh_2d(rows: int, cols: int, *, mesh: Mesh | None = None, device=None,
                 backend: str | None = None) -> Mesh2D:
    """This rank's :class:`Mesh2D` over ``mesh`` (default: this process's
    group, :func:`make_mesh`), which must have ``rows * cols`` ranks. The
    row and column subgroups come from ``dist.new_group``: every rank calls
    this, and so creates every group in the same order (rows, then
    columns), as NCCL requires. Each call makes new groups: make the view
    once and share it among a rank's engines."""
    if rows < 1 or cols < 1:
        raise ValueError(f"mesh {rows}x{cols} needs positive dimensions")
    if mesh is None:
        mesh = make_mesh(rows * cols, device=device, backend=backend)
    if mesh.num_shards != rows * cols:
        raise ValueError(f"mesh {rows}x{cols} needs {rows * cols} devices, "
                         f"the process group has {mesh.num_shards}")
    return _view_2d(rows, cols, mesh, *_groups_2d(rows, cols))


def _groups_2d(rows: int, cols: int) -> tuple[list, list]:
    """The row and column subgroups of an R x C mesh over global ranks
    0 .. R*C - 1, created in the order every rank follows (rows, then
    columns). ``dist.new_group`` is collective over the default group:
    every rank of it calls this, members or not."""
    row_groups = [dist.new_group([i * cols + j for j in range(cols)]) for i in range(rows)]
    col_groups = [dist.new_group([i * cols + j for i in range(rows)]) for j in range(cols)]
    return row_groups, col_groups


def _view_2d(rows: int, cols: int, mesh: Mesh, row_groups, col_groups) -> Mesh2D:
    """Rank ``mesh.rank``'s :class:`Mesh2D` over the subgroups of
    :func:`_groups_2d`."""
    i, j = divmod(mesh.rank, cols)
    over_r = Mesh(rows, i, mesh.device, mesh.backend, col_groups[j],
                  tuple(ii * cols + j for ii in range(rows)))
    over_c = Mesh(cols, j, mesh.device, mesh.backend, row_groups[i],
                  tuple(i * cols + jj for jj in range(cols)))
    return Mesh2D(rows, cols, mesh, over_r, over_c)


def _device_of(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` for a bare 'cuda' (or None),
    the named device otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to run "
                "the mesh on gloo with the plain PyTorch versions of the kernels"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def _check_ranks(num_ranks: int, device, backend: str) -> None:
    """Too many CUDA ranks for the cards raises (rank r holds cuda:r); a
    named card shared by several ranks needs gloo."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return
    if dev.index is None:
        have = torch.cuda.device_count()
        if num_ranks > have:
            raise ValueError(f"requested {num_ranks} devices, only {have} available")
    elif num_ranks > 1 and backend == "nccl":
        raise ValueError(
            f"{num_ranks} NCCL ranks cannot share {dev}: NCCL takes one rank a "
            "device; use backend='gloo' or one device a rank"
        )


def _backend_of(device: torch.device, backend: str | None) -> str:
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def make_mesh(num_devices: int | None = None, *, device=None,
              backend: str | None = None) -> Mesh:
    """This rank's :class:`Mesh`. Joins the default process group when one
    exists, or torchrun's (``WORLD_SIZE`` set; ``num_devices``, if given,
    must be its size); otherwise creates a one-rank group (``num_devices``
    None or 1). ``device`` is CUDA unless named; a bare 'cuda' puts rank r
    on ``cuda:r`` (``LOCAL_RANK`` under torchrun)."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        # A torchrun rank: the launcher's group, through env:// rendezvous.
        dev = _device_of(device, int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(_backend_of(dev, backend),
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if num_devices is not None and num_devices != world:
            raise ValueError(f"the process group has {world} ranks, not {num_devices}")
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = _device_of(device, local)
        _check_ranks(world, device, dist.get_backend())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return Mesh(world, rank, dev, dist.get_backend())
    if num_devices not in (None, 1):
        raise ValueError(
            f"a mesh of {num_devices} ranks runs one process a rank: start it with "
            "tpu_bfs_torch.parallel.mesh.launch or torchrun"
        )
    dev = _device_of(device, 0)
    backend = _backend_of(dev, backend)
    # The rendezvous file lives as long as the group: NCCL reads the store
    # when its communicator starts, at the first collective.
    global _ONE_RANK_DIR
    _ONE_RANK_DIR = tempfile.mkdtemp(prefix="tpu_bfs_torch_mesh_")
    dist.init_process_group(
        backend, init_method=f"file://{_ONE_RANK_DIR}/rendezvous", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(1, 0, dev, backend)


_ONE_RANK_DIR = None


def close_mesh() -> None:
    """Leave the default process group (no-op when there is none)."""
    global _ONE_RANK_DIR
    if dist.is_initialized():
        dist.destroy_process_group()
    if _ONE_RANK_DIR is not None:
        shutil.rmtree(_ONE_RANK_DIR, ignore_errors=True)
        _ONE_RANK_DIR = None


def _rank_main(rank: int, num_ranks: int, work_dir: str, fn, args, device,
               backend: str) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, and on
    rank 0 write its value; a failure writes the traceback instead."""
    out = Path(work_dir)
    try:
        dev = _device_of(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        dist.init_process_group(
            backend, init_method=f"file://{out / 'rendezvous'}", world_size=num_ranks,
            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        )
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        value = fn(Mesh(num_ranks, rank, dev, backend), *args)
        # No rank leaves before every rank has joined and finished: a rank
        # that exits early closes its sockets while a slower peer may still
        # be connecting, and that peer fails in init_process_group.
        dist.barrier()
        if rank == 0:
            tmp = out / "result.tmp"
            tmp.write_bytes(pickle.dumps(value))
            tmp.replace(out / "result.pkl")
        dist.destroy_process_group()
    except BaseException:
        (out / f"error{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


class RankGroup:
    """Spawned ranks running one function; :meth:`result` waits for them."""

    def __init__(self, procs, work_dir: str):
        self._procs = procs
        self._dir = Path(work_dir)

    def result(self):
        """Rank 0's value. When a rank fails the others are stopped and
        this raises with every failed rank's traceback."""
        try:
            while True:
                codes = [p.exitcode for p in self._procs]
                if any(c not in (None, 0) for c in codes):
                    time.sleep(1.0)  # let the other ranks record their errors
                    for p in self._procs:
                        if p.exitcode is None:
                            p.terminate()
                    errs = sorted(self._dir.glob("error*.txt"))
                    text = "\n".join(f"--- {e.stem} ---\n{e.read_text()}" for e in errs)
                    raise RuntimeError(
                        f"mesh rank(s) failed (exit codes {[p.exitcode for p in self._procs]})"
                        f"\n{text}")
                if all(c == 0 for c in codes):
                    result = self._dir / "result.pkl"
                    if not result.is_file():
                        raise RuntimeError("mesh rank 0 exited without a result (a "
                                           "spawned rank re-imports the main file: "
                                           "guard it with if __name__ == '__main__')")
                    return pickle.loads(result.read_bytes())
                self._procs[0].join(0.05)
        finally:
            for p in self._procs:
                if p.exitcode is None:
                    p.terminate()
                p.join()
            shutil.rmtree(self._dir, ignore_errors=True)


def start(num_ranks: int, fn, *args, device=None, backend: str | None = None) -> RankGroup:
    """Spawn ``num_ranks`` processes, each running ``fn(mesh, *args)`` in a
    fresh process group (``file://`` rendezvous); returns at once. ``fn``
    must be importable (a module-level function) and ``args`` picklable."""
    import multiprocessing as mp

    if num_ranks < 1:
        raise ValueError(f"need at least one rank, got {num_ranks}")
    dev = _device_of(device, 0)
    named = None if device is None else str(device)
    backend = _backend_of(dev, backend)
    _check_ranks(num_ranks, device, backend)
    work_dir = tempfile.mkdtemp(prefix="tpu_bfs_torch_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, num_ranks, work_dir, fn, args, named, backend), daemon=True)
             for r in range(num_ranks)]
    for p in procs:
        p.start()
    return RankGroup(procs, work_dir)


def launch(num_ranks: int, fn, *args, device=None, backend: str | None = None):
    """:func:`start`, then rank 0's value."""
    return start(num_ranks, fn, *args, device=device, backend=backend).result()


# --- serving a mesh from one controller -------------------------------------
#
# JAX serves a mesh from one controller: any of its threads may launch a
# sharded program. Here every rank is a process, and every rank must make
# the same collective calls in the same order. The serve tier therefore
# runs in the calling process as rank 0 (it keeps stdin, the threads and
# the queries) and spawns ranks 1 .. N-1 as followers, each holding a
# replica of every mesh object rank 0 creates. Every mesh-touching call of
# rank 0 (an engine build and warm-up, a dispatch, a fetch, each extraction
# gather, a heartbeat) goes through one lock: it is posted to every
# follower's inbox (a pipe, never a collective a follower waits in while
# idle) and then run by rank 0 itself, and each follower runs the same call
# on its replica in the order it was posted. The groups of every rung of the
# degrade ladder are made once at start, in one order on every rank.
#
# A command that fails on any rank ends the followers of its rung: a
# follower cannot tell a failure every rank shares from one of its own (an
# out-of-memory on one of several ranks sharing a card), and after the
# latter its replicas, or the collectives it waits in, no longer match
# rank 0's. So a failed follower exits, which fails its peers' pending
# collectives at once (gloo sees the closed connection), and rank 0, when
# its own run of a command fails, stops the rung's followers. Either way
# rank 0 raises DATA_LOSS, which the serve tier reads as a mesh fault and
# answers by degrading onto a rung of live ranks.
#
# Fault injection stays rank 0's: a call that would visit fault sites names
# them (``Remote`` ``sites``), rank 0 consults them before the call is
# posted, and a fault raises before any rank starts the call. Inside the
# call rank 0's sites are silenced (``faults.decided``), so no rank stops
# where the others go on into a collective.

#: Ops every follower runs; the others only the ranks of their rung.
_ALL_RANK_OPS = ("share", "rung", "groups2d")

_MISSING = object()


def square_shape(devices: int) -> tuple[int, int]:
    """The most-square (rows, cols) factorization of ``devices``."""
    r = int(devices ** 0.5)
    while devices % r:
        r -= 1
    return r, devices // r


class RankContext:
    """One serving rank's view of the mesh: its global ``rank``, its
    ``device`` and the meshes of every rung (the first ``d`` ranks of the
    default group) that it belongs to."""

    def __init__(self, rank: int, num_ranks: int, device: torch.device, backend: str):
        from tpu_bfs_torch.resilience.failover import degrade_ladder

        self.rank, self.num_ranks = rank, num_ranks
        self.device, self.backend = device, backend
        self._meshes: dict = {}  # d -> Mesh, or None off the rung
        self._meshes_2d: dict = {}  # (rows, cols) -> Mesh2D, or None
        for d in degrade_ladder(num_ranks):
            if d > 1:
                self._add_rung(d)
                self.ensure_2d(*square_shape(d))

    def _add_rung(self, d: int) -> None:
        full = d == self.num_ranks
        group = None if full else dist.new_group(list(range(d)))
        self._meshes[d] = (
            Mesh(d, self.rank, self.device, self.backend, group,
                 None if full else tuple(range(d)))
            if self.rank < d else None)

    def mesh(self, devices: int) -> Mesh:
        """This rank's 1D mesh over the first ``devices`` ranks."""
        if devices not in self._meshes:
            raise ValueError(f"no mesh rung of {devices} ranks (ladder of {self.num_ranks})")
        m = self._meshes[devices]
        if m is None:
            raise ValueError(f"rank {self.rank} is not on the {devices}-rank rung")
        return m

    def ensure_rung(self, devices: int) -> None:
        """Create the group of the first ``devices`` ranks (every rank, in
        one order) when the degrade ladder did not."""
        if devices not in self._meshes:
            self._add_rung(devices)

    def ensure_2d(self, rows: int, cols: int) -> None:
        """Create the R x C mesh's groups (every rank, in one order)."""
        if (rows, cols) in self._meshes_2d:
            return
        d = rows * cols
        self.ensure_rung(d)
        row_groups, col_groups = _groups_2d(rows, cols)
        self._meshes_2d[(rows, cols)] = (
            _view_2d(rows, cols, self._meshes[d], row_groups, col_groups)
            if self.rank < d else None)

    def mesh_2d(self, rows: int, cols: int) -> Mesh2D:
        """This rank's R x C mesh over the first R*C ranks."""
        m = self._meshes_2d.get((rows, cols))
        if m is None:
            raise ValueError(f"rank {self.rank} has no {rows}x{cols} mesh")
        return m


def is_plain(value) -> bool:
    """Whether a call's result is a host value rank 0 keeps for itself
    (numbers, strings, numpy arrays, and containers and dataclasses of
    them) rather than an object whose replicas the followers keep. A tensor
    is never plain: each rank's is its own shard or state, and a later call
    must get each rank's own."""
    if value is None or isinstance(value, (bool, int, float, complex, str, bytes,
                                           np.ndarray, np.generic, torch.device,
                                           torch.dtype)):
        return True
    if isinstance(value, (tuple, list)):
        return all(is_plain(v) for v in value)
    if isinstance(value, dict):
        return all(is_plain(v) for v in value.values())
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return all(is_plain(getattr(value, f.name)) for f in dataclasses.fields(value))
    return False


@dataclasses.dataclass(frozen=True)
class _Ref:
    """A follower-side reference to the replica stored under ``hid``."""

    hid: int


def _resolve(x, objs: dict):
    """``x`` with every :class:`_Ref` replaced by its replica."""
    if isinstance(x, _Ref):
        return objs[x.hid]
    if isinstance(x, tuple):
        return tuple(_resolve(v, objs) for v in x)
    if isinstance(x, list):
        return [_resolve(v, objs) for v in x]
    if isinstance(x, dict):
        return {k: _resolve(v, objs) for k, v in x.items()}
    return x


def _split(x):
    """(wire form, rank 0's local form) of call arguments: a
    :class:`Remote` becomes a :class:`_Ref` on the wire and its local
    replica on rank 0."""
    if isinstance(x, Remote):
        return _Ref(x._hid), x._local
    if isinstance(x, (tuple, list)):
        parts = [_split(v) for v in x]
        kind = type(x) if isinstance(x, list) else tuple
        return kind(p[0] for p in parts), kind(p[1] for p in parts)
    if isinstance(x, dict):
        parts = {k: _split(v) for k, v in x.items()}
        return {k: p[0] for k, p in parts.items()}, {k: p[1] for k, p in parts.items()}
    return x, x


def _run_op(ctx: RankContext, objs: dict, op: str, payload):
    """One command on one rank (rank 0 passes its local objects, followers
    their replicas). Non-plain results are kept under their handle."""
    if op == "share":
        hid, value = payload
        objs[hid] = value
        return value
    if op == "rung":
        ctx.ensure_rung(payload)
        return None
    if op == "groups2d":
        ctx.ensure_2d(*payload)
        return None
    if op == "beat":
        t = torch.ones(1, dtype=torch.int32, device=ctx.device)
        return int(ctx.mesh(payload).all_reduce_(t, "sum").item())
    if op == "aot":
        from tpu_bfs_torch.utils.aot import rank_aot

        target, what, store, key, log = payload
        return rank_aot(_resolve(target, objs), what, store, key, log)
    if op == "build":
        hid, fn, args, kw = payload
        out = fn(ctx, *_resolve(args, objs), **_resolve(kw, objs))
    elif op == "call":
        hid, target, name, args, kw = payload
        out = getattr(_resolve(target, objs), name)(*_resolve(args, objs), **_resolve(kw, objs))
    elif op == "getattr":
        hid, target, name = payload
        out = getattr(_resolve(target, objs), name)
    else:
        raise ValueError(f"unknown mesh command {op!r}")
    if hid is not None and not is_plain(out):
        objs[hid] = out
    return out


def _follower_main(rank: int, num_ranks: int, work_dir: str, device, backend: str,
                   inbox, parent: int) -> None:
    """A follower rank: join the group, make every rung's groups, then run
    the commands of rank 0's stream in order until told to close, or until
    rank 0's process (``parent``) is gone. A failed command is reported on
    stderr and ends the rank (see the section comment above)."""
    import queue
    import sys

    try:
        dev = _device_of(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group(
            backend, init_method=f"file://{work_dir}/rendezvous", world_size=num_ranks,
            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        )
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        ctx = RankContext(rank, num_ranks, dev, backend)
        objs: dict = {}
        while True:
            try:
                blob = inbox.get(timeout=5.0)
            except queue.Empty:
                if os.getppid() != parent:
                    break  # rank 0 died without closing: nothing more comes
                continue
            op, devices, payload, frees = pickle.loads(blob)
            for hid in frees:
                objs.pop(hid, None)
            if op == "close":
                break
            if op not in _ALL_RANK_OPS and rank >= devices:
                continue  # not on this command's rung
            try:
                _run_op(ctx, objs, op, payload)
            except Exception as exc:  # noqa: BLE001 — reported, then the rank ends
                print(f"# mesh rank {rank}: {op} failed, leaving the mesh: "
                      f"{type(exc).__name__}: {str(exc)[:300]}", file=sys.stderr, flush=True)
                os._exit(1)  # no teardown: the group may be wedged mid-collective
        objs.clear()
        dist.destroy_process_group()
    except BaseException:
        (Path(work_dir) / f"error{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


class Remote:
    """Rank 0's handle on an object of which every rank of a rung holds a
    replica. Plain instance data and class constants read from rank 0's
    replica; a method call or a computed attribute is a command of the
    stream. ``sites`` names the fault sites a method visits: rank 0
    consults them before the call is posted."""

    __slots__ = ("_ctl", "_hid", "_local", "_devices", "_sites", "_owned", "__weakref__")

    def __init__(self, ctl, hid: int, local, devices: int, sites=None, *, owned: bool = True):
        self._ctl, self._hid, self._local = ctl, hid, local
        self._devices = devices
        self._sites = dict(sites or {})
        self._owned = owned  # the replicas go when this handle does

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        local = self._local
        state = getattr(local, "__dict__", None)
        if state is not None and name in state:
            return state[name]
        attr = inspect.getattr_static(local, name, _MISSING)
        if attr is _MISSING:
            if getattr(type(local), "__getattr__", None) is None:
                raise AttributeError(f"{type(local).__name__!r} object has no attribute {name!r}")
            return self._ctl.getattr(self, name)
        if inspect.isfunction(attr) or isinstance(attr, (staticmethod, classmethod)):
            return _RemoteMethod(self, name)
        if hasattr(type(attr), "__get__"):  # a property or another descriptor
            return self._ctl.getattr(self, name)
        return attr  # a class constant

    def __repr__(self) -> str:
        return f"Remote({type(self._local).__name__}, hid={self._hid}, devices={self._devices})"

    def __del__(self):
        if getattr(self, "_owned", False):
            self._ctl._frees.append(self._hid)


class _RemoteMethod:
    __slots__ = ("_obj", "_name")

    def __init__(self, obj: Remote, name: str):
        self._obj, self._name = obj, name

    def __call__(self, *args, **kw):
        return self._obj._ctl.call(self._obj, self._name, args, kw)


def local_of(obj):
    """Rank 0's replica of a :class:`Remote` (``obj`` itself otherwise)."""
    return obj._local if isinstance(obj, Remote) else obj


class MeshController:
    """Rank 0 of a serving mesh: this process joined as rank 0 of
    ``num_ranks``, the followers it spawned, and the ordered command stream
    (see the section comment above). Make one with :func:`serve_mesh`."""

    def __init__(self, num_ranks: int, device, backend: str):
        import collections
        import multiprocessing as mp

        if dist.is_initialized():
            raise RuntimeError("this process already belongs to a process group")
        self.num_ranks = num_ranks
        self.device = _device_of(device, 0)
        self.backend = backend
        self._work_dir = tempfile.mkdtemp(prefix="tpu_bfs_torch_serve_mesh_")
        named = None if device is None else str(device)
        ctx = mp.get_context("spawn")
        self._inboxes = [ctx.Queue() for _ in range(num_ranks - 1)]
        self._procs = [
            ctx.Process(target=_follower_main,
                        args=(r, num_ranks, self._work_dir, named, backend,
                              self._inboxes[r - 1], os.getpid()),
                        daemon=True, name=f"tpu-bfs-mesh-rank{r}")
            for r in range(1, num_ranks)]
        for p in self._procs:
            p.start()
        dist.init_process_group(
            backend, init_method=f"file://{self._work_dir}/rendezvous",
            world_size=num_ranks, rank=0,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        )
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.ctx = RankContext(0, num_ranks, self.device, backend)
        self._lock = threading.Lock()
        self._next_hid = 0
        self._frees = collections.deque()  # appended by Remote.__del__, any thread
        self._shared: dict = {}  # id(value) -> (weakref, hid)
        self.commands = 0  # guarded-by: _lock
        self._closed = False

    # --- the stream ------------------------------------------------------

    def _hid(self) -> int:  # requires-lock: _lock
        self._next_hid += 1
        return self._next_hid

    def _rung_procs(self, op: str, devices: int) -> list:
        """(rank, process) of the followers that run ``op`` on ``devices``."""
        reach = self.num_ranks if op in _ALL_RANK_OPS else devices
        return [(r, p) for r, p in enumerate(self._procs, start=1) if r < reach]

    def _broadcast(self, blob: bytes) -> None:  # requires-lock: _lock
        for p, q in zip(self._procs, self._inboxes):
            if p.is_alive():  # a dead follower's inbox would only fill
                q.put(blob)

    def _post(self, op: str, devices: int, payload) -> None:  # requires-lock: _lock
        if self._closed:
            raise RuntimeError("the mesh controller is closed")
        for r, p in self._rung_procs(op, devices):
            if not p.is_alive():
                # Recovery's classifier reads this as a device loss.
                raise RuntimeError(
                    f"DATA_LOSS: mesh rank {r} exited (code {p.exitcode}); "
                    f"the mesh cannot complete a collective")
        frees = []
        while True:
            try:
                frees.append(self._frees.popleft())
            except IndexError:
                break
        self._broadcast(pickle.dumps((op, devices, payload, frees),
                                     protocol=pickle.HIGHEST_PROTOCOL))
        self.commands += 1

    def _command(self, op: str, devices: int, wire, local, sites=()):
        """Consult ``sites`` on rank 0, post the command, run it here."""
        from tpu_bfs_torch import faults

        with self._lock:
            sched = faults.ACTIVE
            if sched is not None:
                for site, ctx in sites:
                    sched.hit(site, **ctx)
            self._post(op, devices, wire)
            with faults.decided():
                try:
                    return _run_op(self.ctx, {}, op, local)
                except Exception as exc:
                    rung = self._rung_procs(op, devices)
                    if not rung:
                        raise
                    # The followers failed it too (and are leaving), or
                    # passed it, or wait in a collective for rank 0: none
                    # matches rank 0 any more.
                    for _, p in rung:
                        if p.is_alive():
                            p.terminate()
                    for _, p in rung:
                        p.join(10.0)
                    raise RuntimeError(
                        f"DATA_LOSS: mesh command {op!r} failed on rank 0 "
                        f"({type(exc).__name__}); ranks 1-{len(rung)} were stopped") from exc

    def _wrap(self, out, hid: int, devices: int, sites=None):
        return out if is_plain(out) else Remote(self, hid, out, devices, sites)

    def build(self, devices: int, fn, *args, sites=None, **kw):
        """``fn(rank_context, *args, **kw)`` on each of the first ``devices``
        ranks (a module-level function); rank 0's result, as a
        :class:`Remote` unless plain. ``sites`` maps method names to the
        ``(site, context)`` pairs rank 0 consults before each call."""
        self._check_devices(devices)
        (wargs, wkw), (largs, lkw) = _split((args, kw))
        with self._lock:
            hid = self._hid()
        out = self._command("build", devices, (hid, fn, wargs, wkw), (hid, fn, largs, lkw))
        return self._wrap(out, hid, devices, sites)

    def call(self, obj: Remote, name: str, args=(), kw=None):
        """``obj.name(*args, **kw)`` on every replica, in stream order."""
        (wargs, wkw), (largs, lkw) = _split((tuple(args), dict(kw or {})))
        with self._lock:
            hid = self._hid()
        out = self._command(
            "call", obj._devices, (hid, _Ref(obj._hid), name, wargs, wkw),
            (hid, obj._local, name, largs, lkw), obj._sites.get(name, ()))
        return self._wrap(out, hid, obj._devices)

    def getattr(self, obj: Remote, name: str):
        """A computed attribute of every replica (it may gather)."""
        with self._lock:
            hid = self._hid()
        out = self._command("getattr", obj._devices, (hid, _Ref(obj._hid), name),
                            (hid, obj._local, name))
        return self._wrap(out, hid, obj._devices)

    def aot(self, obj: Remote, op: str, store, key: dict, log=None) -> list:
        """Export (``op`` 'export') or adopt ('adopt') the programs of
        ``obj``'s replicas under the program key ``key``, each rank its own
        (``utils/aot.rank_aot``): rank 0 with ``store`` (an
        ``ArtifactStore``) and ``log``, the followers with stores of their
        own over its directory. One command, so every rank of the rung does
        it at the same point of the stream. Returns the names every rank
        exported or adopted. A rank that falls back keeps its eager step and
        joins every later collective as before."""
        if op not in ("export", "adopt"):
            raise ValueError(f"unknown AOT command {op!r}; have 'export', 'adopt'")
        return self._command("aot", obj._devices, (_Ref(obj._hid), op, store.root, key, None),
                             (obj._local, op, store, key, log))

    def share(self, value) -> Remote:
        """Send ``value`` (a graph) to every follower once; later calls
        with the same object return the same handle."""
        import weakref

        with self._lock:
            ent = self._shared.get(id(value))
            if ent is not None and ent[0]() is value:
                return Remote(self, ent[1], value, self.num_ranks, owned=False)
            hid = self._hid()
        self._command("share", self.num_ranks, (hid, value), (hid, value))
        with self._lock:
            # The replicas of a shared value live as long as the controller.
            self._shared[id(value)] = (weakref.ref(value), hid)
        return Remote(self, hid, value, self.num_ranks, owned=False)

    def heartbeat(self, devices: int) -> int:
        """The all-reduce (sum) of one 1 from each of the first ``devices``
        ranks."""
        self._check_devices(devices)
        return self._command("beat", devices, devices, devices)

    def ensure_rung(self, devices: int) -> None:
        """Make the group of the first ``devices`` ranks on every rank (the
        degrade ladder's rungs exist from the start)."""
        if devices > 1 and devices not in self.ctx._meshes:
            self._check_devices(devices)
            self._command("rung", self.num_ranks, devices, devices)

    def ensure_2d(self, rows: int, cols: int) -> None:
        """Make the R x C mesh's groups on every rank (the rungs' square
        shapes exist from the start)."""
        if (rows, cols) not in self.ctx._meshes_2d:
            self._check_devices(rows * cols)
            self._command("groups2d", self.num_ranks, (rows, cols), (rows, cols))

    def _check_devices(self, devices: int) -> None:
        if not 1 <= devices <= self.num_ranks:
            raise ValueError(f"requested {devices} devices, the mesh has {self.num_ranks}")

    def close(self) -> None:
        """Stop the followers and leave the group. Idempotent."""
        global _ACTIVE
        with self._lock:
            if self._closed:
                return
            self._broadcast(pickle.dumps(("close", self.num_ranks, None, [])))
            self._closed = True
        for p in self._procs:
            p.join(30.0)
            if p.exitcode is None:
                p.terminate()
                p.join()
        for q in self._inboxes:
            # The followers have exited: anything still buffered is moot.
            q.cancel_join_thread()
            q.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self._work_dir, ignore_errors=True)
        if _ACTIVE is self:
            _ACTIVE = None


_ACTIVE: MeshController | None = None
_ACTIVE_LOCK = threading.Lock()


def active_controller() -> MeshController | None:
    """This process's serving mesh, or None."""
    return _ACTIVE


def serve_mesh(num_ranks: int, *, device=None, backend: str | None = None) -> MeshController:
    """Join this process as rank 0 of ``num_ranks`` and spawn the followers
    (the serve tier's mesh; :func:`launch` runs every rank as a child
    instead). ``device`` as for :func:`launch`; ranks sharing one named card
    default to gloo. Returns the process's controller, which stays active
    until closed; asking again for at most as many ranks on the same device
    returns it."""
    global _ACTIVE
    import atexit

    if num_ranks < 2:
        raise ValueError(f"a serving mesh needs at least 2 ranks, got {num_ranks}")
    with _ACTIVE_LOCK:
        ctl = _ACTIVE
        if ctl is not None and not ctl._closed:
            if ctl.num_ranks >= num_ranks and ctl.device == _device_of(device, 0):
                return ctl
            raise RuntimeError(
                f"this process already serves a {ctl.num_ranks}-rank mesh on "
                f"{ctl.device}; close it before asking for {num_ranks} ranks on {device}")
        dev = _device_of(device, 0)
        if backend is None:
            shared = dev.type == "cuda" and device is not None and torch.device(device).index is not None
            backend = "gloo" if shared else _backend_of(dev, None)
        _check_ranks(num_ranks, device, backend)
        ctl = MeshController(num_ranks, device, backend)
        _ACTIVE = ctl
    atexit.register(ctl.close)
    return ctl
