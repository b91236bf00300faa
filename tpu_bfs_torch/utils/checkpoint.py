"""Checkpoint and resume of BFS traversal state, the port of
``tpu_bfs/utils/checkpoint.py`` (single-file formats).

The reference keeps no traversal state anywhere durable: a failed run is
lost whole. Here the state of a traversal (frontier, visited, distances and
the level counter; for a packed batch, its bit tables and counter planes)
is a host value: engines expose ``start`` / ``advance`` / ``finish``, and
this module writes it as one ``.npz`` with a CRC32 of its payload.

The files are the JAX package's, byte for byte in layout: arrays in real
vertex-id order, packed tables as ``uint32``. The port's engines keep their
bit tables as int32 on the device and view them as uint32 on the way out
(``_packed_common.packed_table_to_real``), so a checkpoint written by either
package loads and resumes in the other.

Not ported here: the sharded per-chip formats (with the mesh engines) and
the fault-injection sites (with the serve tier's recovery), ROADMAP Queue 1
items 10 and 11.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
import zlib

import numpy as np

_STATE_VERSION = 1


class CorruptCheckpointError(ValueError):
    """An on-disk checkpoint failed its integrity check (payload CRC32
    mismatch, or an unreadable npz). The file has been renamed
    ``<path>.corrupt`` so no retry resumes from it; the message names it."""


def _payload_crc32(arrays: dict) -> int:
    """CRC32 over every array's name, dtype, shape and bytes, in sorted key
    order (so save and load agree whatever the order of the arguments)."""
    crc = 0
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        crc = zlib.crc32(f"{name}:{a.dtype.str}:{a.shape}".encode(), crc)
        # The buffer protocol feeds crc32 without a tobytes() copy.
        crc = zlib.crc32(np.ascontiguousarray(a), crc)
    return crc


def _quarantine(path: str, reason: str) -> None:
    qpath = path + ".corrupt"
    try:
        os.replace(path, qpath)
    except OSError:
        qpath = path  # a read-only file system: still refuse to load it
    raise CorruptCheckpointError(
        f"checkpoint {path} failed integrity verification ({reason}); "
        f"quarantined as {qpath} — resume from an intact checkpoint"
    )


def _load_npz_verified(path: str) -> dict:
    """Load an npz written by ``_atomic_savez`` and verify its payload CRC32.
    An unreadable or mismatching file is quarantined and raises
    :class:`CorruptCheckpointError`. A file without the CRC field loads
    unverified."""
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, zlib.error, EOFError, ValueError, KeyError) as exc:
        # Decode failures only: a MemoryError or a transient OSError says
        # nothing about the bytes on disk and must not destroy the file.
        _quarantine(path, f"unreadable: {type(exc).__name__}: {exc}")
    crc = arrays.pop("payload_crc32", None)
    if crc is not None and int(crc) != _payload_crc32(arrays):
        _quarantine(path, "payload CRC32 mismatch")
    return arrays


def _new_nonce() -> int:
    """Random chain id of one traversal (see BfsCheckpoint.nonce)."""
    return int.from_bytes(os.urandom(8), "little") >> 1  # fits int64


@dataclasses.dataclass
class BfsCheckpoint:
    """Host snapshot of one single-source traversal, in real vertex-id
    order [V], so it resumes on any engine over the same graph. ``level``
    counts the completed level steps."""

    source: int
    level: int
    frontier: np.ndarray  # [V] bool
    visited: np.ndarray  # [V] bool
    distance: np.ndarray  # [V] int32 (INF_DIST where unreached)
    # Chain identity: made once per start() and carried through every chunk.
    # None on checkpoints written before the field existed.
    nonce: int | None = None

    @property
    def done(self) -> bool:
        """True once the frontier is empty (the traversal has ended)."""
        return not bool(self.frontier.any())


def initial_checkpoint(num_vertices: int, source: int) -> BfsCheckpoint:
    """Level-0 state: frontier = visited = {source}, dist[source] = 0; the
    one start of every single-source engine, so their checkpoints agree."""
    from tpu_bfs_torch.graph.csr import INF_DIST

    if not (0 <= source < num_vertices):
        raise ValueError(f"source {source} out of range [0, {num_vertices})")
    frontier = np.zeros(num_vertices, dtype=bool)
    frontier[source] = True
    dist = np.full(num_vertices, INF_DIST, dtype=np.int32)
    dist[source] = 0
    return BfsCheckpoint(source=source, level=0, frontier=frontier,
                         visited=frontier.copy(), distance=dist, nonce=_new_nonce())


def _atomic_savez(path: str, **arrays) -> None:
    """``savez_compressed`` to exactly ``path`` (a file handle, so numpy
    appends no ``.npz``), through a sibling temp file and ``os.replace``,
    so a crash mid-save leaves the previous checkpoint intact. A
    ``payload_crc32`` field rides in the file for ``_load_npz_verified``."""
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, payload_crc32=np.uint32(_payload_crc32(arrays)), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, ckpt: BfsCheckpoint) -> None:
    """Write a single-source checkpoint as one ``.npz``, at exactly ``path``."""
    _atomic_savez(
        path,
        version=_STATE_VERSION,
        source=ckpt.source,
        level=ckpt.level,
        frontier=ckpt.frontier,
        visited=ckpt.visited,
        distance=ckpt.distance,
        nonce=-1 if ckpt.nonce is None else ckpt.nonce,
    )


def load_checkpoint(path: str) -> BfsCheckpoint:
    z = _load_npz_verified(path)
    if int(z["version"]) != _STATE_VERSION:
        raise ValueError(f"unsupported checkpoint version {int(z['version'])}")
    if "kind" in z and str(z["kind"]) == "packed":
        raise ValueError(
            f"{path} is a packed-batch checkpoint (use load_packed_checkpoint"
            " / resume it with a multi-source engine)"
        )
    nonce = int(z["nonce"]) if "nonce" in z else -1
    return BfsCheckpoint(
        source=int(z["source"]),
        level=int(z["level"]),
        frontier=z["frontier"],
        visited=z["visited"],
        distance=z["distance"],
        nonce=None if nonce < 0 else nonce,
    )


@dataclasses.dataclass
class PackedCheckpoint:
    """Host snapshot of one packed multi-source batch.

    Every table is in real vertex-id row order, [V, w] uint32, lane ``l``
    at word ``l // 32``, bit ``l % 32``: a checkpoint taken on one packed
    engine resumes on any other over the same graph and lane count (wide
    or hybrid, this package or the JAX one). ``planes`` are the bit-sliced
    distance counters [P, V, w]; ``level`` counts completed level steps;
    ``alive`` is False once a step claimed nothing."""

    sources: np.ndarray  # [S] int64
    level: int
    alive: bool
    frontier: np.ndarray  # [V, w] uint32
    visited: np.ndarray  # [V, w] uint32
    planes: np.ndarray  # [P, V, w] uint32
    # [S] bool: lanes whose source is isolated, recorded by the starting
    # engine so any finishing engine patches them. None on old checkpoints.
    iso: np.ndarray | None = None
    nonce: int | None = None  # chain identity (see BfsCheckpoint.nonce)

    @property
    def done(self) -> bool:
        return not self.alive


def save_packed_checkpoint(path: str, ckpt: PackedCheckpoint) -> None:
    """Write a packed-batch checkpoint as one ``.npz``, at exactly ``path``."""
    _atomic_savez(
        path,
        version=_STATE_VERSION,
        kind="packed",
        sources=ckpt.sources,
        level=ckpt.level,
        alive=int(ckpt.alive),
        frontier=ckpt.frontier,
        visited=ckpt.visited,
        planes=ckpt.planes,
        iso=np.empty(0, bool) if ckpt.iso is None else ckpt.iso.astype(bool),
        nonce=-1 if ckpt.nonce is None else ckpt.nonce,
    )


def load_packed_checkpoint(path: str) -> PackedCheckpoint:
    z = _load_npz_verified(path)
    if int(z["version"]) != _STATE_VERSION:
        raise ValueError(f"unsupported checkpoint version {int(z['version'])}")
    if "kind" not in z or str(z["kind"]) != "packed":
        raise ValueError(
            f"{path} is not a packed-batch checkpoint (use load_checkpoint "
            "for single-source state)"
        )
    iso = z["iso"] if "iso" in z else np.empty(0, bool)
    nonce = int(z["nonce"]) if "nonce" in z else -1
    return PackedCheckpoint(
        sources=z["sources"].astype(np.int64),
        level=int(z["level"]),
        alive=bool(int(z["alive"])),
        frontier=z["frontier"],
        visited=z["visited"],
        planes=z["planes"],
        iso=iso.astype(bool) if iso.size else None,
        nonce=None if nonce < 0 else nonce,
    )
