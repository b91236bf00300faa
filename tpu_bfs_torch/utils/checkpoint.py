"""Checkpoint and resume of BFS traversal state and results, the port of
``tpu_bfs/utils/checkpoint.py``.

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

A single-source checkpoint can also be written as one file a shard of a
1D split of the real ids (:func:`save_checkpoint_sharded`), in two
generations so a corrupt shard falls back to the previous one; it loads
on any shard count. Results (``BfsResult``) round-trip through
:func:`save_result` / :func:`load_result`.

The fault sites ``ckpt_save`` and ``ckpt_load`` sit in every write and
read, and a ``corrupt_ckpt`` rule flips a byte of a completed write
(``faults.maybe_corrupt_file``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
import zlib

import numpy as np

from tpu_bfs_torch import faults as _faults

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
    if _faults.ACTIVE is not None:
        _faults.ACTIVE.hit("ckpt_load", path=path)
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
    if _faults.ACTIVE is not None:
        _faults.ACTIVE.hit("ckpt_save", path=path)
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, payload_crc32=np.uint32(_payload_crc32(arrays)), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # Chaos: corrupt_ckpt flips a byte AFTER the completed write, as storage
    # corruption would, for the CRC to catch on the next load.
    if _faults.ACTIVE is not None:
        _faults.maybe_corrupt_file(path)


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


def _meta_generation(meta_path: str):
    """The generation ``meta.json`` points at, or None (absent, unreadable)."""
    try:
        with open(meta_path) as f:
            return json.load(f).get("generation")
    except (OSError, json.JSONDecodeError):
        return None


def _clear_stale_shards(gen_dir: str, num_shards: int) -> None:
    """Drop a generation's shard files numbered past ``num_shards`` and its
    quarantined ones: a re-shard to fewer shards must not leave files that
    make an intact generation look torn to the fallback loader."""
    for fname in os.listdir(gen_dir):
        if not fname.startswith("shard_"):
            continue
        if fname.endswith(".npz.corrupt"):
            stale = True
        elif fname.endswith(".npz"):
            try:
                stale = not 0 <= int(fname[len("shard_"):-len(".npz")]) < num_shards
            except ValueError:
                stale = False  # not ours; leave it
        else:
            continue
        if stale:
            try:
                os.unlink(os.path.join(gen_dir, fname))
            except OSError:
                pass


def save_checkpoint_sharded(dirpath: str, ckpt: BfsCheckpoint, num_shards: int) -> None:
    """Write one file a shard of a ``num_shards``-way contiguous 1D split:
    shard k holds real ids [k*cpk, min((k+1)*cpk, V)), cpk = ceil(V /
    num_shards). Layout: ``meta.json`` and ``gen_a/`` or ``gen_b/`` of
    ``shard_00000.npz`` ...; the new shard set goes into the inactive
    generation and ``meta.json`` flips to it last, so a crash mid-save
    leaves the previous checkpoint whole. Each shard carries the level,
    source and nonce, which the loader cross-checks."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    v = len(ckpt.frontier)
    if num_shards > v:
        raise ValueError(f"num_shards={num_shards} exceeds vertex count {v}")
    cpk = -(-v // num_shards)
    os.makedirs(dirpath, exist_ok=True)
    meta_path = os.path.join(dirpath, "meta.json")
    gen = "gen_b" if _meta_generation(meta_path) == "gen_a" else "gen_a"
    gen_dir = os.path.join(dirpath, gen)
    os.makedirs(gen_dir, exist_ok=True)
    meta = {
        "version": _STATE_VERSION,
        "source": int(ckpt.source),
        "level": int(ckpt.level),
        "num_vertices": v,
        "num_shards": num_shards,
        "generation": gen,
        "nonce": ckpt.nonce,
    }
    _clear_stale_shards(gen_dir, num_shards)
    for k in range(num_shards):
        sl = slice(k * cpk, min((k + 1) * cpk, v))
        _atomic_savez(
            os.path.join(gen_dir, f"shard_{k:05d}.npz"),
            level=ckpt.level,
            # The traversal's identity rides in every shard: the fallback
            # loads a previous generation, whose meta was overwritten.
            source=ckpt.source,
            nonce=-1 if ckpt.nonce is None else ckpt.nonce,
            frontier=ckpt.frontier[sl],
            visited=ckpt.visited[sl],
            distance=ckpt.distance[sl],
        )
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)


def _agree(seen, value, what: str, k: int):
    """``value`` if ``seen`` is None or equal, else a torn-set ValueError."""
    if seen is not None and value != seen:
        raise ValueError(f"torn sharded checkpoint: shard {k} is from {what} {value} but "
                         f"its siblings are from {what} {seen}")
    return value


def _load_sharded_generation(dirpath: str, meta: dict, gen: str | None, *,
                             expect_level: int | None) -> BfsCheckpoint:
    """Assemble one generation's shard set. ``expect_level`` cross-checks
    each shard against meta (the active generation); None accepts any one
    consistent level (a fallback generation: meta describes the newer,
    lost one, whose shard count may differ, so the count comes from the
    generation's own files)."""
    shard_dir = os.path.join(dirpath, gen) if gen else dirpath
    num_shards = int(meta["num_shards"])
    if expect_level is None:
        num_shards = len([f for f in os.listdir(shard_dir)
                          if f.startswith("shard_") and f.endswith(".npz")])
        if num_shards == 0:
            raise FileNotFoundError(f"no shards in {shard_dir}")
    parts = []
    level = expect_level
    source = nonce = None
    for k in range(num_shards):
        p = _load_npz_verified(os.path.join(shard_dir, f"shard_{k:05d}.npz"))
        lvl = int(p["level"]) if "level" in p else int(meta["level"])
        if level is None:
            level = lvl
        if lvl != level:
            theirs = "meta.json records" if expect_level is not None else "its siblings are from"
            raise ValueError(
                f"torn sharded checkpoint: shard {k} is from level {lvl} but {theirs} level "
                f"{level} — the save was interrupted; re-checkpoint before resuming")
        if "source" in p:
            source = _agree(source, int(p["source"]), "source", k)
            if "nonce" in p:
                n = int(p["nonce"])
                nonce = None if n < 0 else n
        parts.append(p)
    # Identity from the shards when recorded (a fallback generation may
    # predate the traversal meta.json now describes); else from meta.
    if source is None:
        source, nonce = int(meta["source"]), meta.get("nonce")
    elif expect_level is not None and source != int(meta["source"]):
        raise ValueError(f"sharded checkpoint source mismatch: shards record source {source} "
                         f"but meta.json records {meta['source']}")
    ckpt = BfsCheckpoint(
        source=source, level=int(level),
        frontier=np.concatenate([p["frontier"] for p in parts]),
        visited=np.concatenate([p["visited"] for p in parts]),
        distance=np.concatenate([p["distance"] for p in parts]),
        nonce=nonce,
    )
    if len(ckpt.frontier) != int(meta["num_vertices"]):
        raise ValueError("shard sizes do not add up to the recorded vertex count")
    return ckpt


def load_checkpoint_sharded(dirpath: str, *, log=None) -> BfsCheckpoint:
    """Re-assemble a sharded checkpoint into one host checkpoint, whatever
    shard count wrote it. A corrupt shard of the active generation is
    quarantined (``.corrupt``) and the load falls back to the previous
    generation; only when both are damaged does the error propagate."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    if int(meta["version"]) != _STATE_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    gen = meta.get("generation")  # None: a flat layout from before generations
    try:
        return _load_sharded_generation(dirpath, meta, gen, expect_level=int(meta["level"]))
    except (CorruptCheckpointError, FileNotFoundError) as exc:
        # FileNotFoundError: a re-load after an earlier attempt quarantined
        # a shard must still reach the intact generation.
        prev = {"gen_a": "gen_b", "gen_b": "gen_a"}.get(gen)
        if prev is None or not os.path.isdir(os.path.join(dirpath, prev)):
            raise
        if log is not None:
            log(f"active generation {gen} is corrupt ({exc}); falling back "
                f"to the previous generation {prev}")
        try:
            back = _load_sharded_generation(dirpath, meta, prev, expect_level=None)
            if back.source != int(meta["source"]):
                # A reused directory: the previous generation is another
                # traversal's, and resuming it would resume the wrong run.
                raise CorruptCheckpointError(
                    f"fallback generation {prev} records source {back.source}, not this "
                    f"traversal's {meta['source']}")
            return back
        except (ValueError, FileNotFoundError) as exc2:
            raise CorruptCheckpointError(
                f"no intact checkpoint generation in {dirpath}: active {gen}: {exc}; "
                f"fallback {prev}: {exc2}") from exc2


def save_result(path: str, res) -> None:
    """Persist a ``BfsResult`` (distances, parents and its counts) as one
    ``.npz``, the JAX package's result file."""
    _atomic_savez(
        path,
        version=_STATE_VERSION,
        source=res.source,
        distance=res.distance,
        parent=res.parent if res.parent is not None else np.empty(0, np.int32),
        num_levels=res.num_levels,
        reached=res.reached,
        edges_traversed=res.edges_traversed,
    )


def load_result(path: str):
    from tpu_bfs_torch.algorithms.bfs import BfsResult

    z = _load_npz_verified(path)
    if int(z["version"]) != _STATE_VERSION:
        raise ValueError(f"unsupported result version {int(z['version'])}")
    parent = z["parent"]
    return BfsResult(
        source=int(z["source"]),
        distance=z["distance"],
        parent=parent if parent.size else None,
        num_levels=int(z["num_levels"]),
        reached=int(z["reached"]),
        edges_traversed=int(z["edges_traversed"]),
    )
