"""The transfer pass, the port of ``tpu_bfs/analysis/transfer.py``: the
hot programs stay on the device and are built once a shape.

Four checks, cheapest first:

- **host ops** (:func:`check_host_ops`): an exported program holds no
  node that syncs with the host (``aten._local_scalar_dense``,
  ``aten.item``, a copy of a device tensor to the CPU, an op whose output
  size depends on the data such as ``aten.nonzero``, a Python callback).
  JAX's HLO host-op scan; on the CPU this scan is the check.
- **the guard drive** (:func:`check_guard_drive`): a warmed program
  driven once under ``torch.cuda.set_sync_debug_mode("error")`` (JAX's
  ``jax.transfer_guard("disallow")``): any sync inside the call raises
  and becomes a finding. It runs on the card only, and says so.
- **the retrace sentinel** (:func:`check_adopted_retrace`): after warm-up,
  same-shape redrives of an engine that adopted exported programs add no
  AOT runtime fallback (a call the adopted program could not take) and
  no export (the store's counters, ``utils/aot.ArtifactStore.counts``).
- **the lazy-distance contract** (:func:`check_lazy_distances`): a packed
  dispatch and fetch materialise no distance word and no eccentricity
  until asked.
"""

from __future__ import annotations

import torch

from tpu_bfs_torch.analysis import Finding


def check_host_ops(name: str, walk) -> list[Finding]:
    out = []
    for node in walk.nodes:
        if node.host_op is None:
            continue
        out.append(Finding(
            "transfer", f"{name}:{node.target}",
            f"exported hot program contains a host-boundary node `{node.target}` "
            f"({node.host_op}; node {node.name}{' in ' + node.graph if node.graph else ''}): "
            f"every call now syncs device->host. Keep the value on the device or move the "
            f"read out of the program."))
    return out


def materialize(args, device=None):
    """``args`` with each ``utils/aot.ArgSpec`` made a zero tensor (on
    ``device`` when given), tensors kept: the arguments of a drive."""
    from torch.utils._pytree import tree_map

    from tpu_bfs_torch.utils.aot import ArgSpec

    def real(x):
        if isinstance(x, ArgSpec):
            return torch.zeros(x.shape, dtype=x.dtype, device=device or x.device)
        return x

    return tree_map(real, tuple(args))


def _on_card(args) -> bool:
    from torch.utils._pytree import tree_leaves

    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_leaves(args))


def check_guard_drive(name: str, fn, args, *, warm: bool = True) -> list[Finding]:
    """Drive ``fn`` once to warm it (unless the caller has: ``warm=False``),
    then once under ``torch.cuda.set_sync_debug_mode("error")``. The
    arguments must be on the card: a guard drive is the card's check (on
    the CPU there is no sync to catch, and :func:`check_host_ops` is the
    check)."""
    if not _on_card(args):
        raise ValueError(f"{name}: the guard drive runs on the card only; its arguments "
                         "are on the CPU (check_host_ops is the CPU's check)")
    if warm:
        fn(*args)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        fn(*args)
    except RuntimeError as exc:
        return [Finding(
            "transfer", f"{name}:sync-guard",
            f"warmed program syncs with the host on every call: {str(exc)[:200]} — keep "
            f"the value on the device or move the read out of the program.")]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return []


def check_adopted_retrace(name: str, engine, drive, store) -> list[Finding]:
    """``drive(engine)`` once to warm, then again at the same shapes: the
    engine must hold adopted programs (``_aot_adopted``), and the second
    drive must add no runtime fallback and no export to ``store``."""
    adopted = getattr(engine, "_aot_adopted", ())
    if not adopted:
        return [Finding(
            "transfer/retrace", f"{name}:aot-adopt",
            "engine holds no AOT-adopted programs — preheat did not install exported "
            "programs (missing/stale/corrupt store, or the engine family lacks "
            "export_programs).")]
    drive(engine)
    was = store.counts()
    drive(engine)
    now = store.counts()
    out = []
    for key in ("aot_runtime_fallbacks", "aot_exports"):
        if now[key] > was[key]:
            out.append(Finding(
                "transfer/retrace", f"{name}:{key}",
                f"a same-shape redrive of the adopted engine moved {key} "
                f"({was[key]} -> {now[key]}): some call's shape, dtype or device differs "
                f"from the exported signature, so it ran the eager path (or exported "
                f"anew). Pad to the fixed serving shape."))
    return out


def check_lazy_distances(name: str, engine, sources) -> list[Finding]:
    """Dispatch and fetch must move summaries only; the distance planes stay
    on the device until ``distances_int32`` asks."""
    out: list[Finding] = []
    res = engine.fetch(engine.dispatch(sources))
    if getattr(res, "_word_cache", None):
        out.append(Finding(
            "transfer", f"{name}:distance_u8",
            "fetch materialized distance word-columns before any lane was asked for — "
            "the lazy distance path must transfer only when materialized (metadata-only "
            "serve queries pull zero distance words)."))
    if getattr(res, "_ecc_cache", None) is not None:
        out.append(Finding(
            "transfer", f"{name}:ecc",
            "fetch materialized the lane-ecc summary eagerly — ecc is a lazy on-demand "
            "transfer."))
    d = res.distances_int32(0)
    if int(d[int(sources[0])]) != 0:
        out.append(Finding(
            "transfer", f"{name}:distance_u8-decode",
            f"lazy materialization decoded distance {int(d[int(sources[0])])} for the "
            f"source itself (expected 0) — the deferred transfer path is corrupting "
            f"results."))
    return out
