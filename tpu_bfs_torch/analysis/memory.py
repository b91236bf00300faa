"""The memory pass, the port of ``tpu_bfs/analysis/memory.py``. Three parts:

- **the per-program peak estimate** (:func:`estimate_walk`): from the FX
  walk (``analysis/graph.walk_program``), the inputs resident plus the
  most intermediates live at once (JAX's ``hlo_buffer_estimate``, its
  fallback when ``memory_analysis()`` is missing; a view or an in-place
  op allocates nothing). ``chip_smoke.py`` puts it beside one call's
  measured ``torch.cuda.max_memory_allocated`` rise on the card.
- **the ladder model** (:func:`model_spec_peak_bytes`,
  :func:`check_ladder_entries`, :func:`registry_ladder_families`,
  :func:`check_registry_ladders`): an analytic peak of each serve engine
  family at every rung ``serve/frontend.build_width_ladder`` warms must
  be strictly monotone in rung width, or the OOM and mesh-degrade
  ladders walk to a rung that frees nothing. The packed tables are priced
  at their exact width, as ``_packed_common.auto_lanes`` sizes them (a
  CUDA allocation has no tile padding); JAX prices TPU-physical widths
  (``tpu_padded_words``), so the rungs below 4096 lanes model fewer bytes
  here than in JAX.
- **the in-place certificate** (:func:`check_in_place`): a program whose
  engine documents an argument as written in place (the level step's
  visited and plane tables, the claim's visited slice and distances) must
  show that write in its graph: an in-place op whose schema writes a
  tensor that traces back to that user input. It is the counterpart of
  JAX's ``input_output_alias`` check of a donation. JAX's AST lint of
  ``donate_argnums`` has no torch object to read (a torch program writes
  its tables in place and donates nothing) and is not ported.
"""

from __future__ import annotations

from tpu_bfs_torch.analysis import Finding

#: A program's function name -> the positional arguments its engine
#: documents as written in place.
DOCUMENTED_IN_PLACE = {
    "step": (2, 3),  # _packed_common.level_step (and gated, adaptive): vis, planes
    "_level_step": (2, 3),  # DistWideMsBfsEngine: own visited and planes
    "_gather_step": (2, 3),  # DistHybridMsBfsEngine's gather layout
    "_gated_step": (2, 3),
    "_sliced_settle": (1, 2),  # the sliced layout's settle: visited, planes
    "claim_step": (1, 2),  # dist_bfs.claim_step: visited and dist
    "_claim_step": (1, 2),  # Dist2DBfsEngine's dist_core
}


def estimate_walk(name: str, walk) -> dict:
    """The peak certificate of one walked program."""
    return {
        "program": name,
        "argument_bytes": walk.input_bytes,
        "output_bytes": walk.output_bytes,
        "temp_bytes": walk.temp_peak_bytes,
        "peak_bytes": walk.peak_bytes,
        "in_place_inputs": sorted(walk.mutated_inputs),
        "source": "fx-walk",
    }


def documented_in_place(fn) -> tuple:
    """The argument positions ``fn``'s engine documents as written in place."""
    return DOCUMENTED_IN_PLACE.get(getattr(fn, "__name__", ""), ())


def check_in_place(name: str, walk, documented, input_names) -> list[Finding]:
    """Each documented argument position must show an in-place write of
    one of its placeholders (``input_names``: the user inputs in order,
    ``args_<i>`` or ``args_<i>_<leaf>`` as ``torch.export`` names them)."""
    out = []
    for pos in documented:
        mine = [n for n in input_names if n == f"args_{pos}" or n.startswith(f"args_{pos}_")]
        if not mine:
            continue  # the position holds no tensor in this program
        if not any(n in walk.mutated_inputs for n in mine):
            out.append(Finding(
                "memory/in-place", f"{name}:args_{pos}",
                f"the engine documents argument {pos} as written in place, but no node of "
                f"the exported graph writes it (placeholders {mine[:4]}): the program "
                f"returns a fresh table and leaves the state stale, or it allocates a copy "
                f"where the engine counted on none."))
    return out


# --- the ladder model -----------------------------------------------------------

# JAX's terms: bytes a lane outside the packed tables, bytes an edge slot of
# the resident structures, the hybrid's dense-tile budget, and dist2d's
# per-vertex state of one source loop.
LANE_BYTES = 36
EDGE_BYTES = 8
HYBRID_TILE_BYTES = 1 << 27
DIST2D_STATE_BYTES = 6


def model_spec_peak_bytes(engine: str, lanes: int, *, planes: int = 8, devices: int = 1,
                          num_vertices: int, num_edges: int) -> dict:
    """Modeled peak bytes of one serving engine config on one device: the
    packed tables at their exact width (``(planes + LIVE_TABLES)`` [rows,
    w] int32 tables, ``auto_lanes``'s pricing), plus JAX's per-lane and
    fixed terms. dist2d holds no packed table: one (frontier, visited,
    distance) triple a concurrent source loop. Pure arithmetic."""
    from tpu_bfs_torch.algorithms._packed_common import LIVE_TABLES

    rows_local = -(-int(num_vertices) // max(int(devices), 1)) + 1
    edges_local = -(-int(num_edges) // max(int(devices), 1))
    fixed = EDGE_BYTES * edges_local
    if engine == "hybrid":
        fixed += HYBRID_TILE_BYTES
    if engine == "dist2d":
        state = DIST2D_STATE_BYTES * rows_local * int(lanes)
    else:
        w = max(int(lanes) // 32, 1)
        state = (int(planes) + LIVE_TABLES) * rows_local * w * 4
    lane_term = LANE_BYTES * int(lanes)
    return {
        "engine": engine, "lanes": int(lanes), "devices": int(devices),
        "state_bytes": int(state), "lane_bytes": int(lane_term), "fixed_bytes": int(fixed),
        "total_bytes": int(state + lane_term + fixed),
    }


def check_ladder_entries(family: str, entries) -> list[Finding]:
    """``entries``: ``[(width, modeled_bytes), ...]``; the modeled peak
    must be strictly monotone in rung width (JAX's text)."""
    entries = sorted(entries)
    out: list[Finding] = []
    for (w0, b0), (w1, b1) in zip(entries, entries[1:]):
        if w0 == w1:
            out.append(Finding(
                "memory/ladder", f"{family}:w{w0}",
                f"ladder family {family} lists rung width {w0} twice — the degrade walk "
                f"cannot make progress between equal rungs."))
        elif b1 <= b0:
            out.append(Finding(
                "memory/ladder", f"{family}:w{w0}->w{w1}",
                f"modeled peak is not strictly monotone in rung width for {family}: {w1} "
                f"lanes models {b1} bytes <= {w0} lanes' {b0} bytes — degrading {w1} -> "
                f"{w0} would free nothing. Check the family's per-lane terms (a "
                f"width-independent model cannot justify a halving ladder)."))
    return out


def registry_ladder_families(*, num_vertices: int, num_edges: int,
                             device_count: int = 8) -> dict:
    """``{family: [(width, modeled_bytes), ...]}`` for every engine family
    the serve registry builds (JAX's families), each over the rungs
    ``build_width_ladder`` warms."""
    from tpu_bfs_torch.serve.frontend import build_width_ladder
    from tpu_bfs_torch.serve.registry import DEFAULT_PLANES, HYBRID_LANE_QUANTUM

    families = [("wide", 1, 4096), ("packed", 1, 512), ("hybrid", 1, 2 * HYBRID_LANE_QUANTUM)]
    if device_count > 1:
        families += [("wide", device_count, 4096),
                     ("hybrid", device_count, 2 * HYBRID_LANE_QUANTUM),
                     ("dist2d", device_count, 1024)]
    out = {}
    for engine, devices, lanes in families:
        rungs = build_width_ladder(lanes, "auto", devices=devices, engine=engine)
        out[f"{engine}-d{devices}"] = [
            (w, model_spec_peak_bytes(engine, w, planes=DEFAULT_PLANES, devices=devices,
                                      num_vertices=num_vertices,
                                      num_edges=num_edges)["total_bytes"])
            for w in rungs]
    return out


def check_registry_ladders(*, num_vertices: int, num_edges: int,
                           device_count: int = 8) -> tuple[list[Finding], dict]:
    """Every registry family's modeled ladder strictly monotone; returns
    ``(findings, {family: entries})``."""
    ladders = registry_ladder_families(num_vertices=num_vertices, num_edges=num_edges,
                                       device_count=device_count)
    findings: list[Finding] = []
    for family, entries in ladders.items():
        findings.extend(check_ladder_entries(family, entries))
    return findings, ladders
