"""Fault-site coverage audit over the port: the port of
``tpu_bfs/analysis/faultcov.py``.

The chaos harness's whole value is that ``faults.SITES`` and the
injection sites in production code agree — and that every site is
actually drivable from a test. Nothing enforced either: a typo'd site
string in a consultation would silently never fire (the schedule
matches nothing), a declared site whose consultation was refactored
away would silently stop injecting, and a NEW site could land with no
chaos test ever visiting it. Three checks close the loop:

- **undeclared consults**: every ``ACTIVE.hit("<site>", ...)`` /
  ``sched.take("<site>", ...)`` call in the tree must name a site in
  ``faults.SITES`` — an unknown literal is a finding (the consult can
  never fire).
- **never-consulted sites**: every name in ``faults.SITES`` must appear
  as a consult literal somewhere in production code — a site with no
  consultation is dead grammar (specs naming it silently no-op).
- **coverage map**: fault-spec strings in the port's tests
  (``tests/test_torch_*.py``, ``tests/torch_*.py``) and its chip script
  (``chip_smoke.py``) are parsed with the REAL spec parser
  (:func:`tpu_bfs_torch.faults.FaultSchedule.from_spec` semantics via
  ``_parse_clause``), plus direct ``hit``/``take``/``FaultRule`` uses,
  into a site x kind map. A consulted site with zero test coverage is a
  finding — a new fault site cannot land untested. The full map is the
  pass's ``info["coverage"]``.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from tpu_bfs_torch.analysis import Finding

#: Production packages whose consultation sites the cross-check scans.
PROD_DIRS = ("tpu_bfs_torch",)
#: Where drivability coverage may come from: the port's tests and chip script.
TEST_GLOBS = ("tests/test_torch_*.py", "tests/torch_*.py", "chip_smoke.py")

_CONSULT_ATTRS = ("hit", "take")
# Receivers that are fault schedules: ACTIVE (module global), a local
# named sched/schedule, or the faults-module attribute chain.
_SCHED_NAMES = re.compile(r"(ACTIVE|sched|schedule|faults)", re.IGNORECASE)


def _iter_py(root: str, subdirs) -> list[str]:
    out = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, _dirs, files in os.walk(base):
            if "__pycache__" in dirpath:
                continue
            for fname in sorted(files):
                if fname.endswith(".py"):
                    out.append(os.path.join(dirpath, fname))
    return out


def _recv_text(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def consult_sites_in_source(source: str) -> list[tuple[str, int]]:
    """``(site_literal, lineno)`` for every schedule consultation in one
    module: ``<schedule>.hit("<site>", ...)`` and ``<schedule>.take(
    "<site>", "<kind>", ...)`` calls whose receiver looks like a fault
    schedule and whose first argument is a string literal."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not isinstance(
            node.func, ast.Attribute
        ):
            continue
        if node.func.attr not in _CONSULT_ATTRS or not node.args:
            continue
        if not _SCHED_NAMES.search(_recv_text(node.func.value)):
            continue
        a = node.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            out.append((a.value, node.lineno))
    return out


# --- test coverage ----------------------------------------------------------

_KIND_TOKEN_CACHE = None


def _kind_token():
    """Pre-filter regex built from the REAL kind vocabulary
    (``faults.KINDS``, longest-first so 'slow_extract' wins over 'slow')
    — a kind added to the grammar is recognized here automatically, so
    the coverage scan and the spec parser cannot drift."""
    global _KIND_TOKEN_CACHE
    if _KIND_TOKEN_CACHE is None:
        from tpu_bfs_torch.faults import KINDS

        _KIND_TOKEN_CACHE = re.compile(
            r"\b(" + "|".join(sorted(KINDS, key=len, reverse=True)) + r")\b"
        )
    return _KIND_TOKEN_CACHE


def _clauses_from_string(text: str):
    """Parsed ``FaultRule``s from one string literal that looks like a
    fault spec (contains a kind token). Invalid candidates — prose,
    error messages, deliberately-bad grammar fixtures — parse to
    nothing and are skipped."""
    from tpu_bfs_torch.faults import FaultSchedule

    if not _kind_token().search(text) or len(text) > 400:
        return []
    try:
        return FaultSchedule.from_spec(text).rules
    except (ValueError, TypeError):
        return []


def coverage_from_source(source: str) -> dict[str, set]:
    """site -> kinds a test/smoke module can drive: parsed spec-string
    literals, direct ``hit("<site>")``/``take("<site>", "<kind>")``
    consultations, and explicit ``FaultRule(kind=..., site=...)``
    constructions."""
    cov: dict[str, set] = {}

    def add(site: str, kind: str | None) -> None:
        cov.setdefault(site, set())
        if kind:
            cov[site].add(kind)

    try:
        tree = ast.parse(source)
    except SyntaxError:
        return cov
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for rule in _clauses_from_string(node.value):
                add(rule.site, rule.kind)
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _CONSULT_ATTRS \
                    and node.args:
                a = node.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    kind = None
                    if fn.attr == "take" and len(node.args) > 1 and (
                        isinstance(node.args[1], ast.Constant)
                    ):
                        kind = node.args[1].value
                    add(a.value, kind)
            name = (
                fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if name == "FaultRule":
                kind = site = None
                for kw in node.keywords:
                    if kw.arg in ("kind", "site") and isinstance(
                        kw.value, ast.Constant
                    ):
                        if kw.arg == "kind":
                            kind = kw.value.value
                        else:
                            site = kw.value.value
                if site:
                    add(site, kind)
                elif kind:
                    from tpu_bfs_torch.faults import DEFAULT_SITE

                    d = DEFAULT_SITE.get(kind)
                    if d:
                        add(d, kind)
    return cov


# --- the pass ---------------------------------------------------------------


def _audit(prod: dict[str, str], tests, sites, *, verbose: bool
           ) -> tuple[list[Finding], dict]:
    """The three checks over production sources ``prod`` (path -> source)
    and test sources ``tests``. ``verbose`` gives the tree walk's long
    messages and a coverage map over every declared site; otherwise the
    fixture form's short messages and the covered sites only."""
    findings: list[Finding] = []
    consulted: dict[str, list] = {}
    for rel, src in prod.items():
        for site, lineno in consult_sites_in_source(src):
            consulted.setdefault(site, []).append(f"{rel}:{lineno}")
            if site not in sites:
                findings.append(Finding(
                    "faultcov", f"{rel}:{lineno}@undeclared:{site}",
                    f"fault consultation names site {site!r} which is "
                    f"not declared in faults.SITES {tuple(sites)} — no "
                    f"spec clause can ever fire here. Declare the site "
                    f"(and its DEFAULT_SITE row if a kind should land "
                    f"on it) or fix the typo." if verbose else
                    f"fault consultation names undeclared site {site!r}.",
                ))
    # The corrupt hooks consult via take() INSIDE faults.py itself
    # (maybe_corrupt_file/payload) — already collected by the walk above
    # since tpu_bfs_torch/faults.py is in the production scan.
    for site in sites:
        if site not in consulted:
            findings.append(Finding(
                "faultcov", f"faults.SITES@never-consulted:{site}",
                f"site {site!r} is declared in faults.SITES but no "
                f"production code consults it — a spec naming it "
                f"silently no-ops, which is exactly how an injection "
                f"site rots. Wire the consultation or retire the site."
                if verbose else f"declared site {site!r} is never consulted.",
            ))
    cov: dict[str, set] = {}
    for src in tests:
        for site, kinds in coverage_from_source(src).items():
            cov.setdefault(site, set()).update(kinds)
    for site in sites:
        if site in consulted and not cov.get(site):
            findings.append(Finding(
                "faultcov", f"tests@uncovered:{site}",
                f"fault site {site!r} is consulted in production but no "
                f"test or chaos smoke drives a fault through it — a "
                f"regression in its recovery path would land untested. "
                f"Add a spec clause targeting it (e.g. "
                f"`transient@{site}:n=1`) to a chaos arm." if verbose else
                f"consulted site {site!r} has no test coverage.",
            ))
    mapped = sorted(set(cov) | set(sites)) if verbose else cov
    return findings, {
        "sites": {s: sorted(v) for s, v in consulted.items()},
        "coverage": {s: sorted(cov.get(s, ())) for s in mapped},
    }


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def check_tree(root: str) -> tuple[list[Finding], dict]:
    """The full audit. Returns ``(findings, info)``; info carries the
    consult census and the site x kind coverage map for the report."""
    from tpu_bfs_torch.faults import SITES

    prod = {os.path.relpath(p, root): _read(p) for p in _iter_py(root, PROD_DIRS)}
    tests = sorted({p for pat in TEST_GLOBS for p in glob.glob(os.path.join(root, pat))})
    return _audit(prod, [_read(p) for p in tests], SITES, verbose=True)


def check_sources(
    prod: dict[str, str], tests: dict[str, str], sites=None
) -> tuple[list[Finding], dict]:
    """Fixture-friendly form over in-memory sources (``sites`` defaults
    to the real ``faults.SITES``)."""
    from tpu_bfs_torch.faults import SITES

    sites = tuple(sites) if sites is not None else SITES
    return _audit(prod, tests.values(), sites, verbose=False)
