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

Asking for more CUDA ranks than there are cards raises, as JAX's
``make_mesh`` does; nothing moves to the CPU. Several ranks may share one
card only when its index is named (``device="cuda:0"``), on gloo: NCCL
refuses two ranks on one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

#: Collective time limit of a group (gloo and NCCL both honour it).
GROUP_TIMEOUT_S = 600

# all_gather_single is all_gather_into_tensor's newer name (same signature).
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


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
        if self.num_shards == 1 and self.group is not None:
            return t
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The JAX ``lax.all_to_all`` of a [P, ...] tensor: row j goes to
        rank j, and row j of the result came from rank j."""
        if self.num_shards == 1:
            return t.clone()
        src = t.contiguous()
        if self._staged(src):
            return self.all_to_all(src.cpu()).to(t.device)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ring rotation of the JAX ``lax.ppermute`` with pairs
        (i, i + 1): ``t`` goes to rank + 1 and the returned tensor came
        from rank - 1. The identity on one rank."""
        p = self.num_shards
        if p == 1:
            return t
        if self._staged(t):
            return self.ring_shift(t.cpu()).to(t.device)
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
    row_groups = [dist.new_group([i * cols + j for j in range(cols)]) for i in range(rows)]
    col_groups = [dist.new_group([i * cols + j for i in range(rows)]) for j in range(cols)]
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
