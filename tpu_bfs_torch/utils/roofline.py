"""Per-phase attribution of the hybrid engine's level loop (roofline), the
port of ``tpu_bfs/utils/roofline.py``.

A batch's time is one host loop of levels; this module breaks a real
traversal into its phases and prices each against the card's HBM rate,
so the binding term is named and the next optimization is attributable.

Method: step the real engine one level at a time on the device
(``engine._core_from`` with ``max_levels = level + 1``; the checkpoint
API's host round trip would move every table through the host each
level). On each level's live frontier, run the phase slices separately,
built from the same pieces the loop is built from: ``residual`` (K1 over
every bucket, then the ``inv_perm_ext`` gather), ``dense`` (K2 through the
row masks), ``push`` (the adaptive push pass) and the state update as
``claim`` and ``ripple``, each timed by ``utils/timing.run_timed``
(``torch.cuda.synchronize`` on both sides, one warm run on a slice's first
dispatch). The slices re-run work the level does once (each slice
materializes its own tables, and the hit table is built again for the
state slices) and each pays its own launches and fences, so their sum
normally exceeds the stepped level's time. The report keeps JAX's key for
the difference, ``fusion_dividend_s``; here it is that re-run work and
overhead, not a compiler's fusion.

The byte model is analytic: for each phase, the HBM bytes its algorithm
moves (:func:`phase_bytes`). K1's entries are ``ops/ell_expand.
ell_expand_hbm_bytes`` per launch; the dense entry is ``ops/tile_spmm.
tile_spmm_hbm_bytes`` (K2 reads row masks, not the JAX tiles); the push
and state entries are JAX's. Achieved GB/s = bytes / measured time; the
phase with the largest share of the attributed time is the binding term;
the ceiling is the batch rate if every phase ran at the card's peak HBM
rate, ``H100_PEAK_GBS``.

Correctness guard: the stepping loop's level count must equal a plain
``engine.run``'s on the same sources (``tools/roofline.py`` checks it),
proving the slices did not perturb the traversal. Works on the CPU for
tests (tiny graphs); its times mean something only on the card.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import (
    GATE_TILE,
    make_expand,
    row_unsettled,
)
from tpu_bfs_torch.algorithms.msbfs_hybrid import expand_spec, make_hit
from tpu_bfs_torch.obs.engine_trace import trace_summary as _trace_summary
from tpu_bfs_torch.ops.ell_expand import TILE as KTILE
from tpu_bfs_torch.ops.ell_expand import ell_expand_hbm_bytes
from tpu_bfs_torch.ops.tile_spmm import TILE, tile_spmm, tile_spmm_hbm_bytes
from tpu_bfs_torch.utils.recovery import is_oom_failure
from tpu_bfs_torch.utils.timing import fence, run_timed

#: HBM3 rate of one NVIDIA H100 SXM (data sheet: 3.35 TB/s), in GB/s: the
#: peak every bound in the port is priced against.
H100_PEAK_GBS = 3350.0
HBM_BYTES_PER_S = H100_PEAK_GBS * 1e9


def phase_fns(engine) -> dict:
    """Phase slices of one hybrid level.

    Keys (present when the engine has the phase): ``residual`` (K1 over the
    residual buckets, permuted back to rank0 rows), ``dense`` (K2 into a
    fresh table), ``hit`` (the pull exactly as the loop composes it: K2
    into the residual hits), ``gate`` (the adaptive push's decision inputs
    on the device: light, active rows, pairs), ``push`` (the push pass for a
    read-back plan, gate-free), and the state update sliced as ``claim``
    (``hit & ~vis``, the visited OR and liveness) and ``ripple`` (the plane
    increment), reported summed as ``state``. Every slice returns fresh
    tables: none updates its inputs."""
    hg, w = engine.hg, engine.w
    expand_residual = make_expand(expand_spec(hg), w)
    fns = {}

    def residual(arrs, fw):
        return expand_residual(arrs, fw).index_select(0, arrs["inv_perm_ext"])

    fns["residual"] = residual
    if hg.num_tiles:
        def dense(arrs, fw):
            return tile_spmm(arrs["row_start"], arrs["col_tile"], None, fw,
                             num_row_tiles=hg.vt, masks=arrs["a_masks"])

        fns["dense"] = dense
    fns["hit"] = make_hit(hg, w)
    push = getattr(engine, "_push", None)
    if push is not None:
        fns["gate"] = lambda arrs, fw: push.probe(arrs, fw)[1]
        fns["push"] = push.hit

    def claim(h, vis):
        nxt = h & ~vis
        return nxt, vis | nxt, nxt.any()

    def ripple(planes, vis2):
        # ripple_increment_ without updating the carry's planes.
        carry, out = ~vis2, []
        for p in planes:
            out.append(p ^ carry)
            carry = p & carry
        return tuple(out)

    fns["claim"] = claim
    fns["ripple"] = ripple
    return fns


def pallas_expand_bytes(engine, *, active_tiles: int | None = None) -> dict:
    """Per-launch HBM bytes of ONE residual expansion level: one entry per
    K1 launch ('virtual', 'light0', ...), from the engine's padded index
    slabs and priced by ``ops.ell_expand.ell_expand_hbm_bytes`` (per
    computed 128-row tile: the index slab, k gathered frontier rows per row,
    the weight slab of a min-plus launch, and one output write).

    ``active_tiles`` (gated engines: unsettled GATE_TILE blocks this level)
    caps each light launch's computed tiles; the heavy launch is
    all-or-nothing, as the gated loop runs it (gated-out tiles still pay
    their identity write). Leading axes of a table count as shards."""
    arrs = getattr(engine, "arrs", None) or {}
    w = engine.w
    out = {}
    for name in sorted(arrs):
        if not name.endswith("_gt"):
            continue
        base = name[: -len("_gt")]
        # Index slabs only: weight slabs ride their index launch.
        if base != "virtual" and not (base.startswith("light") and "_" not in base):
            continue
        t = arrs[name]
        k, pn = int(t.shape[-2]), int(t.shape[-1])
        shards = int(np.prod(t.shape[:-2], dtype=np.int64))
        if active_tiles is None:
            at = None
        elif base == "virtual":
            at = None if active_tiles > 0 else 0
        else:
            at = min(pn // KTILE, int(active_tiles))
        out[base] = shards * ell_expand_hbm_bytes(
            k, pn, w, active_tiles=at, weighted=f"{base}_w_gt" in arrs
        )
    return out


def phase_bytes(engine, *, nz_rows: int | None = None,
                active_tiles: int | None = None) -> dict:
    """Analytic HBM bytes per phase for ONE level: the bytes each phase's
    algorithm moves, every table read or written once, except that the K1
    launches count every gathered row once per slot (K1's streamed model),
    so the L2 can serve the residual and dense phases above the HBM rate.

    ``nz_rows`` (active frontier rows) sizes the push phase. Without the
    pull gate the pull phases do not depend on the frontier (the whole
    table is scanned every level). On a pull-gated engine ``active_tiles``
    (unsettled GATE_TILE blocks this level) sizes the gated model: the
    light launches and the state pass scale with it, the heavy launch is
    all-or-nothing, the permutation gather and the next frontier's zeroing
    stay whole-table, and the settled-mask read adds one table scan.

    Mesh engines (``_gather_p > 1``) add an ``exchange`` entry: wire bytes
    a level, not HBM, of the dense row gather
    (``parallel.collectives.dense_rows_wire_bytes``, the formula their
    exchange accounting uses); their HBM phases are not re-derived (they
    have no ``hg``)."""
    from tpu_bfs_torch.parallel.collectives import dense_rows_wire_bytes

    hg, w = getattr(engine, "hg", None), engine.w
    out = {}
    p = int(getattr(engine, "_gather_p", 1))
    if p > 1:
        out["exchange"] = dense_rows_wire_bytes(p, engine._gather_rows_loc, w)
    if hg is None:
        return out
    rows = hg.vt * TILE
    tb = rows * w * 4  # one [rows, w] int32 table
    gated = bool(getattr(engine, "pull_gate", False)) and active_tiles is not None
    at_rows = min(int(active_tiles or 0) * TILE, rows) if gated else rows
    res = sum(pallas_expand_bytes(engine, active_tiles=active_tiles if gated else None).values())
    if hg.res_heavy and (not gated or at_rows > 0):
        # The heavy fold pyramid and the pick gather run after K1.
        res += 4 * hg.res_num_virtual * w * 4 + hg.res_heavy * w * 4
    # The permutation back to rank0: read the bucket rows, write the table.
    res += 2 * tb
    out["residual"] = res
    if hg.num_tiles:
        # Ungated even on gated engines (make_hit).
        out["dense"] = tile_spmm_hbm_bytes(hg.num_tiles, hg.vt, w)
    push_cfg = getattr(engine, "adaptive_push", None)
    if push_cfg is not None:
        nz = int(nz_rows or 0)
        # The hit table's zeroing, then per active row its frontier words
        # read and deg_cap neighbour rows read and written.
        out["push"] = tb + nz * (1 + 2 * push_cfg[1]) * w * 4
    if gated:
        out["state"] = 2 * tb + (3 + 2 * engine.num_planes) * at_rows * w * 4
    else:
        # The claim reads hit and vis and writes vis and nxt; the ripple
        # reads and writes the planes.
        out["state"] = (4 + 2 * engine.num_planes) * tb
    return out


@dataclasses.dataclass
class LevelAttribution:
    level: int
    frontier_rows: int  # active rows entering the level
    took: str  # 'push' (adaptive light level) or 'pull'
    t_full_s: float  # the real one-level step
    phases_s: dict  # phase -> seconds (standalone slice; None: it ran out of memory)
    bytes_model: dict  # phase -> analytic HBM bytes
    # Unsettled GATE_TILE blocks entering the level (pull-gated engines
    # only; sizes the gated byte model). None when the engine is ungated.
    active_tiles: int | None = None
    # Exchange branch this level's step recorded (mesh engines: the diff
    # of the chained per-branch counters); None when unobserved.
    exchange_branch: int | None = None


def roofline_hybrid(engine, sources, *, peak_gbs: float = H100_PEAK_GBS,
                    measured_gteps: float | None = None, log=None) -> dict:
    """Attribute a real traversal of ``sources`` level by level.

    Returns a JSON-ready report with the JAX package's keys: per-level
    attribution, per-phase totals with shares and achieved GB/s, the
    "fusion dividend" (the slices' sum less the stepped levels' sum: the
    work the slices re-run and their own launch and fence costs), the named
    binding term, and the peak-bandwidth ceiling implied by the byte model
    (scaled from ``measured_gteps`` when given: pass the timed batch's
    figure so the ceiling is anchored to the same run protocol). Also
    stores the walk's per-level rows as ``engine.last_run_trace``."""
    fns = phase_fns(engine)
    arrs = engine.arrs
    dev = engine.device
    act = engine._act
    sources = np.asarray(sources)
    # The batch's lane mask (pull-gated engines). The phase slices stay the
    # ungated forms, so on a gated engine the per-level gap between the
    # slice sum and t_full includes the gate's win; the byte model switches
    # to the gated entries.
    engine._note_batch_sources(sources)
    fw = engine._seed_dev(sources)
    vis = fw.clone()
    planes = tuple(torch.zeros_like(fw) for _ in range(engine.num_planes))
    level, alive = 0, True
    cap = engine.max_levels_cap
    push = getattr(engine, "_push", None)
    gated = bool(getattr(engine, "pull_gate", False))
    levels: list[LevelAttribution] = []

    def oom_or_raise(exc, what):
        if not is_oom_failure(exc):
            raise exc
        if log is not None:
            log(f"{what} ran out of memory; reporting None ({str(exc)[:120]})")

    def try_timed(call, warm):
        """Phase timing with an out-of-memory seatbelt: a slice whose live
        set does not fit beside the standing state reports None (a partial
        attribution beats losing the report); anything else propagates."""
        try:
            return run_timed(call, warm=warm, device=dev)
        except RuntimeError as exc:
            oom_or_raise(exc, "phase slice")
            return None, None

    def count_rows(f):
        return int(f[:act].any(dim=1).sum())

    def count_tiles(v):
        nt = engine._table_rows // GATE_TILE
        need = row_unsettled(v, act, engine._lane_mask_dev)
        return int(need[: nt * GATE_TILE].view(nt, GATE_TILE).any(dim=1).sum())

    # Each slice warms on its own first dispatch: the push slice runs only
    # on light levels, so its first dispatch can land at any level.
    warmed: set[str] = set()
    prev_counts_walk = None

    def timed_slice(name, call):
        out, t = try_timed(call, name not in warmed)
        warmed.add(name)
        return out, t

    while alive and level < cap:
        nz = count_rows(fw)
        at = count_tiles(vis) if gated else None
        took, plan = "pull", None
        if "gate" in fns:
            plan = push.plan_of(fns["gate"](arrs, fw).tolist())
            if plan.light:
                took = "push"
        phases = {}
        for name in ("residual", "dense", "push"):
            if name not in fns or (name == "push" and took != "push"):
                # The loop does not run the push this level: a plan sized
                # for the pull is out of the slice's contract.
                continue
            args = (arrs, fw, plan) if name == "push" else (arrs, fw)
            out, t = timed_slice(name, partial(fns[name], *args))
            del out  # free the [rows, w] table before the next slice
            phases[name] = t
        # State = claim + ripple, timed separately on a freshly built full
        # hit; building it is the largest slice intermediate (same seatbelt).
        try:
            h = fns["hit"](arrs, fw)
            fence(dev)
        except RuntimeError as exc:
            oom_or_raise(exc, "hit table")
            h = None
        cl, t_claim = (None, None) if h is None else timed_slice(
            "claim", partial(fns["claim"], h, vis))
        del h
        if cl is None:
            phases["state"] = None
        else:
            vis2p = cl[1]
            del cl
            out, t_rip = timed_slice("ripple", partial(fns["ripple"], planes, vis2p))
            del out, vis2p
            phases["state"] = None if t_rip is None else t_claim + t_rip

        # The step updates vis and planes in place, so it runs once, cold:
        # the slices above have loaded every kernel it launches. Its first
        # level's gate (pull gate) or plan (push) is the one this level saw.
        if gated:
            engine._note_resume_state(vis.cpu().numpy().view(np.uint32))
        if plan is not None:
            engine._note_push_plan(plan)
        (fw2, vis2, planes2, lvl2, alive2), t_full = run_timed(
            partial(engine._core_from, arrs, fw, vis, planes, level, level + 1),
            warm=False, device=dev)
        # The exchange branch of this one-level step: a one-hot of the
        # per-branch counters when each step restarts them, else the diff
        # against the previous step's.
        step_branch = None
        counts_now = getattr(engine, "last_exchange_level_counts", None)
        if counts_now is not None:
            counts_now = np.asarray(counts_now.cpu() if torch.is_tensor(counts_now)
                                    else counts_now)
            if counts_now.sum() == 1:
                step_branch = int(np.argmax(counts_now))
            elif prev_counts_walk is not None and prev_counts_walk.shape == counts_now.shape:
                hot = np.flatnonzero(counts_now - prev_counts_walk)
                if len(hot) == 1 and counts_now[hot[0]] > prev_counts_walk[hot[0]]:
                    step_branch = int(hot[0])
            prev_counts_walk = counts_now
        levels.append(LevelAttribution(
            level=level, frontier_rows=nz, took=took, t_full_s=t_full,
            phases_s=phases, bytes_model=phase_bytes(engine, nz_rows=nz, active_tiles=at),
            active_tiles=at, exchange_branch=step_branch,
        ))
        if log is not None:
            gate_msg = "" if at is None else f"active_tiles={at} "
            log(f"level {level}: rows={nz} took={took} {gate_msg}"
                f"full={t_full * 1e3:.1f}ms " + " ".join(
                    f"{k}={v * 1e3:.1f}ms" if v is not None else f"{k}=OOM"
                    for k, v in phases.items()))
        fw, vis, planes = fw2, vis2, planes2
        level, alive = int(lvl2), bool(alive2)

    # Attributed time: the phases the loop runs each level (a push level
    # skips residual and dense, a pull level the push) plus the state.
    tot_attr: dict[str, float] = {}
    tot_bytes: dict[str, float] = {}
    t_full_sum = 0.0
    unmeasured = 0
    for la in levels:
        t_full_sum += la.t_full_s
        names = (["push"] if la.took == "push" else
                 [n for n in ("residual", "dense") if n in la.phases_s])
        for n in names + ["state"]:
            t = la.phases_s.get(n)
            if t is None:
                unmeasured += 1
                continue
            tot_attr[n] = tot_attr.get(n, 0.0) + t
            tot_bytes[n] = tot_bytes.get(n, 0.0) + la.bytes_model.get(n, 0)
    attr_sum = sum(tot_attr.values())
    # The walk as engine-trace rows: it observes each level's frontier and
    # direction directly.
    trace_rows = []
    exch_bytes = getattr(engine, "wire_bytes_per_level", None)
    exch_per = [float(x) for x in exch_bytes()] if exch_bytes is not None else None
    exch_each = exch_per[0] if exch_per is not None and len(exch_per) == 1 else None
    label_hook = getattr(engine, "exchange_branch_labels", None)
    exch_labels = label_hook() if callable(label_hook) else None
    for la in levels:
        gated_tiles = None
        if la.active_tiles is not None:
            gated_tiles = max(engine._table_rows // GATE_TILE - la.active_tiles, 0)
        b = la.exchange_branch
        label = (exch_labels[b] if exch_labels is not None and b is not None
                 and b < len(exch_labels) else None)
        wire = exch_each
        if b is not None and exch_per is not None and b < len(exch_per):
            wire = exch_per[b]
        trace_rows.append({
            "level": la.level,
            "frontier": la.frontier_rows,
            "direction": ("push" if la.took == "push"
                          else "pull-gated" if la.active_tiles is not None else "pull"),
            "gated_tiles": gated_tiles,
            "exchange": label,
            "wire_bytes": wire,
        })
    engine.last_run_trace = trace_rows
    binding = max(tot_attr, key=tot_attr.get) if tot_attr else None
    total_bytes = sum(tot_bytes.values())
    report = {
        "num_levels": len(levels),
        "pull_gate": gated,
        "levels": [dataclasses.asdict(la) for la in levels],
        "t_full_sum_s": t_full_sum,
        "t_attributed_sum_s": attr_sum,
        "fusion_dividend_s": attr_sum - t_full_sum,
        "phase_share": {n: t / attr_sum for n, t in tot_attr.items()},
        "phase_achieved_gbs": {n: (tot_bytes[n] / 1e9) / t if t > 0 else None
                               for n, t in tot_attr.items()},
        "binding_term": binding,
        "unmeasured_phase_slices": unmeasured,
        "trace_summary": _trace_summary(trace_rows, engine),
        "peak_gbs": peak_gbs,
        "hbm_bytes_total": total_bytes,
        # The time the whole byte model would take at peak bandwidth.
        "t_at_peak_bw_s": total_bytes / (peak_gbs * 1e9),
        # The residual tier: K1 from csrc/ell_expand.cu (JAX: "xla" or "pallas").
        "expand_impl": "cuda",
    }
    kb = pallas_expand_bytes(engine)
    report["expand_kernel_bytes"] = {**{k: int(v) for k, v in kb.items()},
                                     "level_total": int(sum(kb.values()))}
    report["expand_kernel_t_at_peak_bw_s"] = sum(kb.values()) / (peak_gbs * 1e9)
    if measured_gteps is not None:
        report["measured_gteps"] = measured_gteps
        report["ceiling_gteps_at_peak_bw"] = (
            measured_gteps * t_full_sum / report["t_at_peak_bw_s"]
            if report["t_at_peak_bw_s"] > 0 else None
        )
    return report
