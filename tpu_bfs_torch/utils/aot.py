"""Ahead-of-time program artifacts: ``torch.export``-serialized engine
programs keyed like the serve registry, the port of
``tpu_bfs/utils/aot.py``.

A JAX engine's level loop is one compiled program, and a fresh process
pays seconds of trace, lower and compile per program per rung; JAX
serializes the lowered programs so a successor installs them instead. The
port's level loop is a host loop with one device read a level, so what it
exports is each fixed-shape program the loop and the extraction call: one
level step (``core``), seeding, the lane reductions and the per-word
extraction (``export_programs()``, :func:`packed_aot_programs` in
``algorithms/_packed_common``). Each is a ``torch.export`` graph of aten
ops and the registered kernel ops (``tpu_bfs_torch::ell_expand``,
``tpu_bfs_torch::tile_spmm``), traced over fake tensors shaped like the
engine's tables, with every table an argument and none a constant. A
warmed server exports them (``--export-aot``); a successor loads and
installs them over the same engine attributes (``adopt_programs()``)
instead of tracing: ``--preheat`` reaches ready with no ``torch.export``
trace at all, and its kernel library is a cache hit
(``utils/compile_cache``).

A mesh engine exports rank-local programs under JAX's names (``dist_core``,
``dist_sssp_core``): each rank's fixed-shape step between the host's
collectives, which stay in the host loop, so no process group is baked into
a graph. Shard shapes and rank constants differ per rank, so every rank
stores its own program, told apart in the program's stored name
(:func:`rank_program_name`: JAX's name on rank 0, ``name.r{rank}`` above),
never in the key: ``program_key`` and rank 0's file name equal JAX's. A
mesh spec probes ready only when every rank's core is there and valid. The
mesh's backend and the rank's device type enter the fingerprint
(:func:`mesh_fingerprint`), so gloo CPU ranks, gloo ranks sharing a card
and NCCL ranks never adopt each other's artifacts. A serving mesh's
rank 0 exports and adopts through one command of the mesh's stream
(``parallel/mesh.MeshController.aot``): every rank runs :func:`rank_aot`
in the same order. A rank whose artifact is missing, stale or corrupt
keeps its eager step and joins every collective as before. A mesh program
counts once in the store's counters, as JAX's one sharded program does: a
hit when every rank loaded it, a fallback when any rank fell back.

Artifacts are defensive by construction, as in JAX:

- **keyed like the registry**: ``(graph_key, engine, lanes, planes,
  pull_gate, devices)`` and the non-default axes, plus the program name
  (:func:`program_key`, the same keys and file names as JAX's);
- **environment-fingerprinted**: torch and CUDA versions, backend, device
  name, count and compute capability, the kernel sources' hash and the two
  ops' schemas (:func:`env_fingerprint`); a stale fingerprint (another
  torch, another card, edited kernels, or a JAX-written artifact) falls
  back to the eager program without quarantining;
- **CRC-verified**: a corrupt file is quarantined (renamed ``.corrupt``)
  and the load falls back. The ``corrupt_aot`` fault kind (``faults.py``,
  ``aot_load`` site) drives this arm deterministically.

Counters: ``hits`` validated artifact reads, ``fallbacks`` loads that fell
back (missing, stale, corrupt, unloadable), ``runtime_fallbacks`` adopted
calls whose arguments did not match the exported signature (a narrower
batch, another device) and ran the original, ``exports`` programs written.
Cross-process reuse needs a stable graph key (a path or generator spec).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import io
import json
import os
import struct
import threading

import torch

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch import obs as _obs

# The kernel ops must be registered before a graph that names them loads.
from tpu_bfs_torch.ops import ell_expand as _k1  # noqa: F401
from tpu_bfs_torch.ops import tile_spmm as _k2  # noqa: F401

MAGIC = b"TBFSAOT1"
FORMAT = 1

# Program names every packed serving engine exports (JAX's dist engines
# export "dist_core" instead of "core"); the core is what
# ArtifactStore.probe keys readiness on.
CORE_NAMES = ("core", "dist_core")


def rank_program_name(name: str, rank: int) -> str:
    """The stored name of rank ``rank``'s program ``name``: JAX's name on
    rank 0 (and on one device), ``name.r{rank}`` on the others."""
    return name if rank == 0 else f"{name}.r{rank}"


def mesh_fingerprint(engine) -> dict | None:
    """The mesh part of a mesh engine's fingerprint (``engine.aot_mesh()``:
    the group's backend and the rank's device type), None on one device."""
    if not hasattr(engine, "aot_mesh"):
        return None
    m = engine.aot_mesh()
    return {"backend": m["backend"], "device": m["device"]}


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """The shape, dtype and device of an example argument that need not
    exist (a state table): the exporter traces over a fake tensor of it, as
    JAX's inventories pass ``ShapeDtypeStruct``s."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device


class AotProgramProtocol:
    """AOT export/adopt hooks, as in JAX. Engines implement
    ``export_programs() -> [(name, attr, fn, example_args), ...]``: every
    program the serving path calls, the engine attribute it lives on, the
    callable, and example arguments (tensors or :class:`ArgSpec`).
    ``adopt_programs`` installs prepared callables (loaded programs wrapped
    by :class:`AdoptedProgram`) over those attributes, so a preheated
    process runs without tracing the originals."""

    _aot_adopted: tuple = ()

    def export_programs(self):
        raise NotImplementedError(f"{type(self).__name__} has no AOT program inventory")

    def adopt_programs(self, programs: dict) -> list:
        """Install ``programs[name]`` over each inventory attribute; names
        absent from ``programs`` keep their eager entry (a partial store
        degrades per program, never per engine). Returns the adopted names
        (also kept on ``_aot_adopted``)."""
        adopted = []
        for name, attr, _fn, _args in self.export_programs():
            call = programs.get(name)
            if call is not None:
                setattr(self, attr, call)
                adopted.append(name)
        self._aot_adopted = tuple(adopted)
        return adopted


def layout_digest(engine) -> str:
    """Digest of ``engine.aot_layout()``: the Python constants its programs
    bake in (bucket boundaries, active and table rows, ...), which the
    registry key leaves out: a compaction re-adds a new base under the same
    key, which carries no generation. The store records it at export and
    treats an artifact of another layout as stale."""
    blob = json.dumps(engine.aot_layout(), sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


class AotArtifactError(ValueError):
    """Base: an artifact that cannot serve this process."""


class CorruptAotArtifact(AotArtifactError):
    """Bad magic / torn header / payload CRC mismatch: quarantined."""


class StaleAotArtifact(AotArtifactError):
    """Environment fingerprint mismatch: fallback, NOT quarantined."""


@functools.lru_cache(maxsize=1)
def _fingerprint() -> str:
    from tpu_bfs_torch.ops._build import source_hash

    cuda = torch.cuda.is_available()
    fp = {
        "format": FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "capability": ".".join(map(str, torch.cuda.get_device_capability(0))) if cuda else None,
        "kernels": source_hash(),
        "ops": [str(torch.ops.tpu_bfs_torch.ell_expand.default._schema),
                str(torch.ops.tpu_bfs_torch.tile_spmm.default._schema)],
    }
    return json.dumps(fp, sort_keys=True)


def env_fingerprint() -> dict:
    """Everything that must match for an exported program to be safe to
    install here: torch and CUDA versions, backend, device name, count and
    compute capability, the kernel sources' hash and the registered ops'
    schemas. ``format`` versions the artifact layout."""
    return json.loads(_fingerprint())


def _fingerprint_with(mesh: dict | None) -> dict:
    """:func:`env_fingerprint`, with a mesh program's :func:`mesh_fingerprint`."""
    fp = env_fingerprint()
    return fp if mesh is None else dict(fp, mesh=mesh)


def program_key(spec) -> dict:
    """Canonical store key from an EngineSpec-like (dataclass, mapping):
    the registry's key axes, the non-default ones only when set, exactly as
    JAX keys them (so the same spec gives the same digest and file name).
    The port has no ``expand_impl`` axis: its engines always run the
    kernel, and a key never carries it."""
    if dataclasses.is_dataclass(spec):
        spec = dataclasses.asdict(spec)
    key = {
        "graph_key": str(spec["graph_key"]),
        "engine": str(spec["engine"]),
        "lanes": int(spec["lanes"]),
        "planes": int(spec["planes"]),
        "pull_gate": bool(spec.get("pull_gate", False)),
        "devices": int(spec.get("devices", 1)),
    }
    if spec.get("exchange"):
        key["exchange"] = str(spec["exchange"])
    if spec.get("wire_pack"):
        key["wire_pack"] = True
    if spec.get("delta_bits"):
        key["delta_bits"] = [int(b) for b in spec["delta_bits"]]
    if spec.get("sieve"):
        key["sieve"] = True
    if spec.get("predict"):
        key["predict"] = True
    if spec.get("mesh_shape"):
        key["mesh_shape"] = [int(x) for x in spec["mesh_shape"]]
    if spec.get("kind", "bfs") != "bfs":
        key["kind"] = str(spec["kind"])
    if spec.get("overlay"):
        # The generation stays out: a flip swaps table values under one
        # program, so every generation adopts the same artifact.
        key["overlay"] = [int(x) for x in spec["overlay"]]
    return key


def _key_digest(key: dict) -> str:
    blob = json.dumps(key, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


def _crc32(payload: bytes) -> int:
    import zlib

    return zlib.crc32(payload) & 0xFFFFFFFF


class ArtifactStore:
    """One directory of fingerprinted, CRC-checked program artifacts.

    File layout (JAX's): ``MAGIC + u32 header_len + header_json +
    payload``. The header carries the registry key, program name,
    environment fingerprint and the payload CRC32; the payload is a
    ``torch.export.save`` archive. Writes are atomic (tmp + rename)."""

    def __init__(self, root, *, log=None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.fallbacks = 0  # guarded-by: _lock
        self.runtime_fallbacks = 0  # guarded-by: _lock
        self.exports = 0  # guarded-by: _lock

    # --- bookkeeping ------------------------------------------------------

    def _bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def counts(self) -> dict:
        """The statsz keys (JAX's)."""
        with self._lock:
            return {
                "aot_hits": self.hits,
                "aot_fallbacks": self.fallbacks,
                "aot_runtime_fallbacks": self.runtime_fallbacks,
                "aot_exports": self.exports,
            }

    # --- paths ------------------------------------------------------------

    def path_for(self, key: dict, name: str) -> str:
        key = program_key(key)
        tag = (
            f"{key['engine']}-l{key['lanes']}-p{key['planes']}"
            f"{'-pg' if key['pull_gate'] else ''}-d{key['devices']}"
        )
        return os.path.join(self.root, f"{tag}-{name}-{_key_digest(key)}.aot")

    def _quarantine(self, path: str, reason: str) -> None:
        qpath = path + ".corrupt"
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = "<unmovable>"
        self._log(
            f"aot artifact corrupt ({reason}): {path} quarantined as "
            f"{qpath}; falling back to JIT"
        )

    # --- write ------------------------------------------------------------

    def put(self, key: dict, name: str, payload: bytes, *, donate_argnums=(),
            layout: str | None = None, mesh: dict | None = None) -> str:
        """Atomically write one program artifact; returns its path.
        ``donate_argnums`` is recorded only when non-empty (JAX's header
        rule); the port's programs donate nothing, so it never is.
        ``layout`` (:func:`layout_digest`) is recorded when given, and a
        mesh program's ``mesh`` (:func:`mesh_fingerprint`) in its
        fingerprint. The temporary file is the writer's own (process and
        thread), so writers of one store never share it."""
        key = program_key(key)
        meta = {
            "key": key,
            "name": name,
            "fingerprint": _fingerprint_with(mesh),
            "payload_crc32": _crc32(payload),
        }
        if layout is not None:
            meta["layout"] = layout
        if donate_argnums:
            meta["donate_argnums"] = [int(i) for i in donate_argnums]
        header = json.dumps(meta, sort_keys=True).encode()
        path = self.path_for(key, name)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._bump("exports")
        return path

    # --- read -------------------------------------------------------------

    def _read_header(self, path: str):
        """(meta, payload_offset); raises CorruptAotArtifact on any
        structural damage."""
        with open(path, "rb") as f:
            head = f.read(len(MAGIC) + 4)
            if len(head) < len(MAGIC) + 4 or head[: len(MAGIC)] != MAGIC:
                raise CorruptAotArtifact(f"bad magic in {path}")
            (hlen,) = struct.unpack("<I", head[len(MAGIC):])
            raw = f.read(hlen)
        if len(raw) < hlen:
            raise CorruptAotArtifact(f"torn header in {path}")
        try:
            meta = json.loads(raw)
        except ValueError as exc:
            raise CorruptAotArtifact(f"unparsable header in {path}: {exc}") from None
        return meta, len(MAGIC) + 4 + hlen

    def _validate(self, meta: dict, key: dict, name: str, layout: str | None = None,
                  mesh: dict | None = None) -> None:
        if meta.get("key") != key or meta.get("name") != name:
            raise StaleAotArtifact(
                f"artifact keyed {meta.get('key')}/{meta.get('name')}, "
                f"wanted {key}/{name}"
            )
        fp = _fingerprint_with(mesh)
        if meta.get("fingerprint") != fp:
            raise StaleAotArtifact(
                f"environment fingerprint {meta.get('fingerprint')} != current {fp}"
            )
        if layout is not None and meta.get("layout") != layout:
            raise StaleAotArtifact(
                f"engine layout {meta.get('layout')} != current {layout} (the "
                "graph under this key was rebuilt: its buckets or rows differ)"
            )

    def probe(self, key: dict, name: str | None = None, *, mesh: dict | None = None) -> bool:
        """Read-only readiness check: does a fingerprint-current core
        artifact with an intact payload exist, for every rank of a mesh key
        (``devices`` ranks, each under :func:`rank_program_name`; ``mesh``
        the serving mesh's :func:`mesh_fingerprint`)? The registry names
        its build span ``engine_adopt`` or ``engine_build`` off this, before
        the engine (and so its layout) exists: an artifact of another layout
        probes ready, then :meth:`get` refuses it and the registry records
        ``aot_adopt_failed``. No quarantine, no counter: :meth:`get` takes
        the consequential actions."""
        key = program_key(key)
        names = CORE_NAMES if name is None else (name,)
        ranks = range(key["devices"]) if key["devices"] > 1 else (0,)
        return any(all(self._intact(key, rank_program_name(n, r), mesh) for r in ranks)
                   for n in names)

    def _intact(self, key: dict, name: str, mesh: dict | None) -> bool:
        path = self.path_for(key, name)
        if not os.path.exists(path):
            return False
        try:
            meta, off = self._read_header(path)
            self._validate(meta, key, name, mesh=mesh)
            with open(path, "rb") as f:
                f.seek(off)
                payload = f.read()
        except (AotArtifactError, OSError):
            return False
        return _crc32(payload) == meta.get("payload_crc32")

    def get(self, key: dict, name: str, *, with_meta: bool = False,
            layout: str | None = None, mesh: dict | None = None):
        """The validated payload (or ``(payload, meta)`` under
        ``with_meta``), or None with the degrade applied: missing/stale
        (another environment or mesh backend, or, given ``layout``, another
        engine layout) -> fallback counted; corrupt -> quarantined +
        fallback counted. Never raises on a bad artifact: the eager path
        always serves."""
        key = program_key(key)
        path = self.path_for(key, name)
        if not os.path.exists(path):
            self._bump("fallbacks")
            return None
        try:
            meta, off = self._read_header(path)
            self._validate(meta, key, name, layout, mesh)
            with open(path, "rb") as f:
                f.seek(off)
                payload = f.read()
            if _faults.ACTIVE is not None:
                # The fault injection site "aot_load": corrupt_aot flips one
                # payload byte in memory so the CRC check below fires;
                # raising kinds surface here like a storage failure.
                _faults.ACTIVE.hit("aot_load", name=name, lanes=key["lanes"])
                payload = _faults.maybe_corrupt_payload(payload, name=name, lanes=key["lanes"])
            if _crc32(payload) != meta.get("payload_crc32"):
                raise CorruptAotArtifact("payload CRC32 mismatch")
        except CorruptAotArtifact as exc:
            self._quarantine(path, str(exc))
            self._bump("fallbacks")
            return None
        except StaleAotArtifact as exc:
            self._log(f"aot artifact stale ({exc}); falling back to JIT")
            self._bump("fallbacks")
            return None
        except (OSError, RuntimeError) as exc:
            # Injected transients too: a flaky read degrades, never kills a
            # preheat.
            self._log(f"aot artifact load failed ({exc!r}); falling back to JIT")
            self._bump("fallbacks")
            return None
        self._bump("hits")
        return (payload, meta) if with_meta else payload


class _Program(torch.nn.Module):
    """``torch.export`` takes a module: this one's forward is the program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, args) -> torch.export.ExportedProgram:
    """``torch.export`` of ``fn(*args)`` over fake tensors: each tensor of
    ``args`` is faked, each :class:`ArgSpec` made as a fake tensor, so the
    trace allocates no table and reads none. The program keeps in-place
    updates of its inputs (the state tables) as in-place ops, with no
    copy-back."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(x):
        if isinstance(x, ArgSpec):
            with mode:
                return torch.empty(x.shape, dtype=x.dtype, device=x.device)
        if isinstance(x, torch.Tensor):
            return mode.from_tensor(x)
        return x

    fargs = tree_map(fake, tuple(args))
    return torch.export.export(_Program(fn), fargs, strict=False)


def serialize_program(exported) -> bytes:
    """The artifact payload: a ``torch.export.save`` archive without the
    example inputs (fake tensors, which carry no data worth keeping)."""
    exported._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_program(payload: bytes) -> torch.export.ExportedProgram:
    return torch.export.load(io.BytesIO(payload))


def _device_of(device: torch.device) -> torch.device:
    """``device`` with a CUDA index always set (a tensor's own device
    carries one; an engine's ``torch.device("cuda")`` does not)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def _drop_input_check(module) -> None:
    """Remove ``ExportedProgram.module()``'s forward pre-hook that checks
    every input against the exported signature: :meth:`AdoptedProgram.
    _matches` has checked the same shapes, dtypes and devices already, and
    the hook's walk over every table costs a fraction of a millisecond of
    host time a call, on the level's critical path (after its one sync)."""
    hooks = getattr(module, "_forward_pre_hooks", {})
    for hid, hook in list(hooks.items()):
        if getattr(hook, "__name__", "") == "_check_input_constraints_pre_hook":
            del hooks[hid]


class AdoptedProgram:
    """A loaded exported program standing in for an engine's eager entry.

    Calls whose arguments match the exported signature (the same pytree,
    and every tensor of the same shape, dtype and device, contiguous) run
    the loaded graph (``ExportedProgram.module()``); anything else, a
    narrower one-shot batch or a Python int where the program takes a
    tensor, runs the ORIGINAL callable and counts a runtime fallback, so
    correctness never depends on the artifact. The program's Python
    constants (bucket boundaries and the like) are the engine layout's,
    which the store checked at load (:func:`layout_digest`)."""

    def __init__(self, name: str, exported, original, store=None):
        from torch.utils._pytree import tree_flatten

        self.name = name
        self._exported = exported
        # Re-exporting from an adopted engine reaches the original.
        self._aot_original = original
        self._store = store
        self._module = exported.module()
        _drop_input_check(self._module)
        self._tree_flatten = tree_flatten
        self._in_spec = exported.call_spec.in_spec
        user = set(exported.graph_signature.user_inputs)
        self._in_sig = [
            (n.meta["val"].shape, n.meta["val"].dtype, _device_of(n.meta["val"].device))
            for n in exported.graph.nodes if n.op == "placeholder" and n.name in user
        ]
        self.calls = 0
        self.fallback_calls = 0

    def _matches(self, args) -> bool:
        leaves, spec = self._tree_flatten((args, {}))
        if spec != self._in_spec or len(leaves) != len(self._in_sig):
            return False
        for leaf, (shape, dtype, dev) in zip(leaves, self._in_sig):
            if not (isinstance(leaf, torch.Tensor) and leaf.shape == shape
                    and leaf.dtype == dtype and leaf.device == dev and leaf.is_contiguous()):
                return False
        return True

    def __call__(self, *args):
        if not self._matches(args):
            self.fallback_calls += 1
            if self._store is not None:
                self._store._bump("runtime_fallbacks")
            return self._aot_original(*args)
        self.calls += 1
        return self._module(*args)

    def graph_targets(self) -> list:
        """The loaded graph's ``call_function`` targets, as strings."""
        return [str(n.target) for n in self._module.graph.nodes if n.op == "call_function"]


def export_available() -> bool:
    try:
        import torch.export  # noqa: F401

        return True
    except ImportError:
        return False


def _aot_target(engine):
    """The engine whose inventory serves ``engine``: itself, or what a serve
    adapter names as its ``aot_engine`` (the 2D serve adapter's replicated
    engine)."""
    if isinstance(getattr(type(engine), "aot_engine", None), property):
        return engine.aot_engine
    return engine


def _remote(engine):
    """``engine`` when it is a serving mesh's handle (``parallel/mesh.Remote``),
    else None."""
    from tpu_bfs_torch.parallel.mesh import Remote

    return engine if isinstance(engine, Remote) else None


def _mesh_command(remote, op: str, spec, store: ArtifactStore, log) -> list:
    """``op`` ('export' or 'adopt') on every rank of ``remote``'s rung, in
    the mesh's command order (:func:`rank_aot` on each, rank 0 with
    ``store`` and ``log``): the names every rank exported or adopted."""
    return remote._ctl.aot(remote, op, store, program_key(spec), log)


def rank_aot(engine, op: str, store, key: dict, log=None) -> list:
    """One rank's part of a mesh command (``parallel/mesh``): export or
    adopt this rank's programs (rank 0 passes its own ``store`` and
    ``log``; a follower gets the store's directory and prints its log
    lines), then agree over the engine's mesh which programs every rank
    exported or adopted: a MIN over the ranks, one collective each, since
    every rank of the rung runs this at one point of the stream. Returns
    those names. A mesh program counts once in rank 0's store, as JAX's one
    program does: an adoption or export that failed on another rank moves
    rank 0's hit to a fallback (or takes back its export)."""
    import sys

    if not isinstance(store, ArtifactStore):
        rank = engine.aot_mesh()["rank"] if hasattr(engine, "aot_mesh") else "?"

        def log(msg, rank=rank):
            print(f"# mesh rank {rank}: {msg}", file=sys.stderr, flush=True)

        store = ArtifactStore(store, log=log)
    inventory = ([n for n, *_ in engine.export_programs()]
                 if hasattr(engine, "export_programs") else [])
    fn = export_engine_programs if op == "export" else adopt_engine_programs
    names = fn(engine, key, store, log=log)
    world = getattr(engine, "_aot_world", None)
    if not inventory or world is None:
        return list(names)
    ok = torch.tensor([n in names for n in inventory], dtype=torch.int32, device=world.device)
    ok = world.all_reduce_(ok, "min").tolist()
    agreed = [n for n, f in zip(inventory, ok) if f]
    lost = len(names) - len(agreed)
    if lost:
        if op == "export":
            store._bump("exports", -lost)
        else:
            store._bump("hits", -lost)
            store._bump("fallbacks", lost)
    return agreed


def export_engine_programs(engine, spec, store: ArtifactStore, *, log=None) -> list:
    """Export every program in ``engine.export_programs()`` into the store
    under the registry key for ``spec``. A program that fails to export
    logs and is skipped: the store holds what it can, the eager path serves
    the rest. Returns the exported names. A mesh engine's rank stores its
    programs under :func:`rank_program_name`; a serving mesh's handle
    exports on every rank (:func:`rank_aot`)."""
    log = log or (lambda msg: None)
    engine = _aot_target(engine)
    if _remote(engine) is not None:
        return _mesh_command(engine, "export", spec, store, log)
    if not hasattr(engine, "export_programs"):
        # Workload adapters carry no inventory (their base's programs export
        # under the kind="bfs" key): nothing to export.
        return []
    key = program_key(spec)
    programs = engine.export_programs()
    layout = layout_digest(engine)
    mesh = mesh_fingerprint(engine)
    rank = engine.aot_mesh()["rank"] if mesh is not None else 0
    done = []
    for name, _attr, fn, args in programs:
        fn = getattr(fn, "_aot_original", fn)
        stored = rank_program_name(name, rank)
        with _obs.maybe_span(
            "aot_export", f"{key['engine']}-w{key['lanes']}-{stored}",
            cat="aot", program=stored, width=key["lanes"],
        ):
            try:
                store.put(key, stored, serialize_program(export_program(fn, args)),
                          layout=layout, mesh=mesh)
            except Exception as exc:  # noqa: BLE001 — per-program degrade
                log(f"aot export of {stored!r} failed "
                    f"({type(exc).__name__}: {str(exc)[:160]}); skipped")
                continue
        done.append(name)
    return done


def adopt_engine_programs(engine, spec, store: ArtifactStore, *, log=None) -> list:
    """Load the store's programs and install them over the engine's eager
    entries (``engine.adopt_programs``). Missing, stale or corrupt
    artifacts are skipped (the store counts the fallback and the engine
    keeps its eager entry). Returns the adopted names. A mesh engine's rank
    loads its own (:func:`rank_program_name`); a serving mesh's handle
    adopts on every rank (:func:`rank_aot`)."""
    log = log or (lambda msg: None)
    engine = _aot_target(engine)
    if _remote(engine) is not None:
        return _mesh_command(engine, "adopt", spec, store, log)
    if not hasattr(engine, "export_programs"):
        return []  # a workload adapter: no inventory
    key = program_key(spec)
    inventory = engine.export_programs()
    layout = layout_digest(engine)
    mesh = mesh_fingerprint(engine)
    rank = engine.aot_mesh()["rank"] if mesh is not None else 0
    programs = {}
    for name, _attr, fn, _args in inventory:
        stored = rank_program_name(name, rank)
        with _obs.maybe_span(
            "aot_load", f"{key['engine']}-w{key['lanes']}-{stored}",
            cat="aot", program=stored, width=key["lanes"],
        ):
            payload = store.get(key, stored, layout=layout, mesh=mesh)
            if payload is None:
                continue
            try:
                exported = load_program(payload)
                programs[name] = AdoptedProgram(name, exported, fn, store=store)
            except Exception as exc:  # noqa: BLE001 — CRC-clean but unloadable
                store._quarantine(
                    store.path_for(key, stored),
                    f"load failed: {type(exc).__name__}: {str(exc)[:160]}",
                )
                store._bump("fallbacks")
                continue
    adopted = engine.adopt_programs(programs)
    if adopted:
        log(f"aot adopted {adopted} for {key['engine']}/w{key['lanes']}")
    return adopted
