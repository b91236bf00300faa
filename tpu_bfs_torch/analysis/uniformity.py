"""Collective uniformity, the port of ``tpu_bfs/analysis/uniformity.py``.

Every rank of a mesh must issue the same collectives in the same order,
or the mesh hangs: a rank parked in an ``all_to_all`` its peer never
enters. JAX picks an exchange branch on the device inside a ``lax.cond``
and proves from the jaxpr that the selecting scalar is mesh-uniform. The
port picks it in Python on the host, between the rank-local programs, so
the same proof reads the host code. Two halves:

- **an AST taint** (:func:`check_sources`, :func:`check_tree`) over
  ``parallel/collectives.py`` and ``parallel/dist_*.py``: each value of
  a function carries the mesh axes over which it is provably the same on
  every rank. Uniform: the results of ``Mesh.all_reduce_`` and
  ``Mesh.all_gather_rows`` (over their mesh's axes), parameters that are
  not annotated as tensors (constructor arguments, the engines' config),
  ``self`` attributes, constants, shapes, and loop-carried state built
  from those. Not uniform: ``mesh.rank``, the results of ``all_to_all``
  and ``ring_shift``, tensor parameters and whatever is reduced locally
  from them. An assignment whose line carries ``# uniform: <why>`` is
  certified by that reason (a local reduction of tables every rank holds
  replicated, which JAX's taint reads from the replicated in_specs); the
  tree run counts these. THE CHECK: every ``if`` (or conditional expression) whose
  arms issue different collective schedules, and every ``while`` whose
  body communicates, must test a value uniform over every axis those
  collectives use. A 2D mesh's ``mesh.r`` and ``mesh.c`` are axes of
  their own: a value all-reduced over the row is uniform there only
  (JAX's ``test_axis_granular_uniformity_2d``).
- **a runtime check** (:func:`check_rank_signatures`): each rank's
  ordered collectives (op, group, shape, dtype) from the wire tap
  (``analysis/graph.WireTap``), gathered after a run: every rank of a
  group must have issued the same sequence on it (JAX's
  ``check_hlo_conditionals`` over the compiled arms).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from tpu_bfs_torch.analysis import Finding

#: The modules the tree run covers.
DEFAULT_GLOBS = ("tpu_bfs_torch/parallel/collectives.py", "tpu_bfs_torch/parallel/dist_*.py")

UNIFORM_RE = re.compile(r"#\s*uniform:\s*\S")
COLLECTIVES = ("all_gather_rows", "all_reduce_", "all_to_all", "ring_shift")
_UNIFORMIZING = ("all_gather_rows", "all_reduce_")
_SHAPE_ATTRS = ("shape", "dtype", "device", "ndim", "num_shards", "rows", "cols")
FULL = frozenset({"mesh"})  # a 1D mesh's one axis; a 2D mesh adds 'r' and 'c'
AXES_2D = frozenset({"mesh", "r", "c"})


def _axis_of(expr) -> frozenset:
    """The axes a collective on mesh expression ``expr`` runs over: 'r'
    or 'c' for a 2D mesh's row or column view, every axis otherwise."""
    text = ast.unparse(expr) if isinstance(expr, ast.AST) else str(expr)
    if text.endswith(".r"):
        return frozenset({"r"})
    if text.endswith(".c"):
        return frozenset({"c"})
    return AXES_2D


@dataclasses.dataclass
class Seq:
    """A sequence value: the uniform axes of its first element and of
    the rest (a ``torch.cat`` of a list, its ``tolist()``)."""

    first: frozenset
    rest: frozenset

    def meet(self) -> frozenset:
        return self.first & self.rest


def _flat(v) -> frozenset:
    return v.meet() if isinstance(v, Seq) else v


@dataclasses.dataclass
class UniformityReport:
    findings: list
    conds_checked: int = 0
    certified_divergent_safe: int = 0
    functions: int = 0
    annotated: set = dataclasses.field(default_factory=set)


def _is_tensor_annotation(ann) -> bool:
    return ann is not None and "Tensor" in ast.unparse(ann)


class _FunctionTaint:
    """The taint of one function body (a nested function is analysed at
    each of its calls, its parameters bound to the call's arguments)."""

    def __init__(self, module: str, fn, report: UniformityReport, sigs: dict, seen: set,
                 outer: dict | None = None, lines=(), qual: str | None = None, bound=None):
        self.module, self.fn, self.report, self.sigs, self.seen = module, fn, report, sigs, seen
        self.lines, self.qual = lines, qual or fn.name
        self.env: dict = dict(outer or {})
        self.nested: dict = {}  # nested function name -> its def
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            self.env[a.arg] = frozenset() if _is_tensor_annotation(a.annotation) else AXES_2D
        for a in (args.vararg, args.kwarg):
            if a is not None:
                self.env[a.arg] = AXES_2D
        self.env.update(bound or {})

    # --- expressions ----------------------------------------------------------

    def value(self, node):
        """The uniform axes of expression ``node`` (a :class:`Seq` for
        sequences built from a list)."""
        if isinstance(node, ast.Constant):
            return AXES_2D
        if isinstance(node, ast.Name):
            return self.env.get(node.id, AXES_2D)  # globals: constants
        if isinstance(node, ast.Attribute):
            if node.attr == "rank":
                return frozenset()
            if node.attr in _SHAPE_ATTRS:
                return AXES_2D
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return AXES_2D  # the engine's config
            return _flat(self.value(node.value))
        if isinstance(node, (ast.List, ast.Tuple)):
            vals = [self.value(e) for e in node.elts]
            if not vals:
                return Seq(AXES_2D, AXES_2D)
            rest = AXES_2D
            for v in vals[1:]:
                rest = rest & _flat(v)
            return Seq(_flat(vals[0]), rest)
        if isinstance(node, ast.Subscript):
            base = self.value(node.value)
            idx = node.slice
            key = _flat(self.value(idx))
            if isinstance(base, Seq):
                first = isinstance(idx, ast.Constant) and idx.value == 0
                return (base.first if first else base.meet()) & key
            return _flat(base) & key
        if isinstance(node, ast.Call):
            return self.call_value(node)
        if isinstance(node, ast.IfExp):
            test = _flat(self.value(node.test))
            a, b = self.value(node.body), self.value(node.orelse)
            if isinstance(a, Seq) and isinstance(b, Seq):
                return Seq(a.first & b.first & test, a.rest & b.rest & test)
            return _flat(a) & _flat(b) & test
        if isinstance(node, ast.Lambda):
            return AXES_2D
        out = AXES_2D
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                out = out & _flat(self.value(child))
        return out

    def call_value(self, node: ast.Call):
        func = node.func
        args = [self.value(a) for a in node.args] + [self.value(k.value) for k in node.keywords]
        if isinstance(func, ast.Attribute):
            if func.attr in _UNIFORMIZING:
                return _axis_of(func.value) | _meet(args)
            if func.attr in ("all_to_all", "ring_shift"):
                return _meet(args) - _axis_of(func.value)
            if func.attr == "tolist":
                return self.value(func.value)
            if func.attr == "numel":
                return AXES_2D
            if func.attr == "cat" and node.args:
                inner = self.value(node.args[0])
                if isinstance(inner, Seq):
                    return inner
            return _flat(self.value(func.value)) & _meet(args)
        if isinstance(func, ast.Name):
            if func.id == "len":
                return AXES_2D
            if func.id in self.nested:
                return self.call_nested(self.nested[func.id], node)
        return _meet(args)

    def call_nested(self, fn, node: ast.Call):
        """A call of a function defined in this one: its body analysed with
        its parameters bound to this call's arguments (its checks report
        under ``outer.inner``); returns its return's uniformity."""
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        bound = {name: self.value(arg) for name, arg in zip(params, node.args)}
        bound.update({k.arg: self.value(k.value) for k in node.keywords if k.arg})
        inner = _FunctionTaint(self.module, fn, self.report, self.sigs, self.seen,
                               outer=self.env, lines=self.lines,
                               qual=f"{self.qual}.{fn.name}", bound=bound)
        inner.nested = dict(self.nested)
        inner.run(fn.body)
        return _returns_of(fn, inner)

    # --- collective schedules -------------------------------------------------

    def schedule(self, stmts) -> tuple:
        """The collectives a block issues, in order: (op, axes) pairs from
        ``Mesh`` calls, and those of the module's own functions it calls
        (by name)."""
        out = []
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    out += self._call_schedule(node)
        return tuple(out)

    def _call_schedule(self, node: ast.Call) -> list:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in COLLECTIVES:
            return [(func.attr, _axis_of(func.value))]
        name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
        sub = self.sigs.get(name)
        if not sub:
            return []
        mesh_arg = next((a for a in node.args if _mesh_like(a)), None)
        axes = _axis_of(mesh_arg) if mesh_arg is not None else None
        return [(op, axes if axes is not None else ax) for op, ax in sub]

    # --- statements -----------------------------------------------------------

    def run(self, body) -> None:
        for _ in range(2):  # loop-carried values settle in two passes
            self.block(body)

    def block(self, stmts) -> None:
        for i, stmt in enumerate(stmts):
            self.stmt(stmt, stmts[i + 1:])

    def assign(self, target, v) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = v
        elif isinstance(target, (ast.Tuple, ast.List)):
            for k, t in enumerate(target.elts):
                if isinstance(v, Seq) and k == 0 and not isinstance(t, ast.Starred):
                    self.assign(t, v.first)
                else:
                    self.assign(t.value if isinstance(t, ast.Starred) else t, _flat(v))
        elif isinstance(target, ast.Starred):
            self.assign(target.value, _flat(v))

    def stmt(self, stmt, rest) -> None:
        if isinstance(stmt, ast.Assign):
            v = self.value(stmt.value)
            if self._annotated(stmt):
                v = AXES_2D
            for t in stmt.targets:
                self.assign(t, v)
            self._ifexps(stmt.value, rest)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and stmt.value is not None:
            v = _flat(self.value(stmt.value))
            if isinstance(stmt, ast.AugAssign) and isinstance(stmt.target, ast.Name):
                v = v & _flat(self.env.get(stmt.target.id, AXES_2D))
            self.assign(stmt.target, v)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if (isinstance(call.func, ast.Attribute) and call.func.attr == "append"
                    and isinstance(call.func.value, ast.Name)):
                name = call.func.value.id
                old = self.env.get(name, AXES_2D)
                new = _meet([self.value(a) for a in call.args])
                self.env[name] = (Seq(old.first, old.rest & new) if isinstance(old, Seq)
                                  else _flat(old) & new)
            self._ifexps(call, rest)
        elif isinstance(stmt, ast.Return) and stmt.value is not None:
            self._ifexps(stmt.value, rest)
        elif isinstance(stmt, ast.If):
            then_arm = self._arm(stmt.body, rest)
            else_arm = self._arm(stmt.orelse, rest)
            self.check(stmt, stmt.test, [then_arm, else_arm], "if")
            self.block(stmt.body)
            self.block(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self.block(stmt.body)  # the carry, then the test
            self.block(stmt.body)
            self.check(stmt, stmt.test, [self.schedule(stmt.body)], "while")
        elif isinstance(stmt, ast.For):
            self.assign(stmt.target, _flat(self.value(stmt.iter)))
            self.block(stmt.body)
            self.block(stmt.body)
            self.block(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.Try)):
            for sub in ("body", "orelse", "finalbody"):
                self.block(getattr(stmt, sub, []) or [])
            for h in getattr(stmt, "handlers", []):
                self.block(h.body)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested[stmt.name] = stmt  # analysed at its calls

    def _annotated(self, stmt) -> bool:
        end = getattr(stmt, "end_lineno", stmt.lineno)
        hit = any(UNIFORM_RE.search(self.lines[i - 1]) for i in range(stmt.lineno, end + 1)
                  if 0 < i <= len(self.lines))
        if hit:
            self.report.annotated.add(f"{self.module}:{stmt.lineno}")
        return hit

    def _arm(self, body, rest) -> tuple:
        """An ``if`` arm's schedule: its body, and the rest of the block
        when the body falls through (an arm that returns ends there)."""
        sched = self.schedule(body)
        if body and isinstance(body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)):
            return sched
        return sched + self.schedule(rest)

    def _ifexps(self, expr, rest) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.IfExp):
                self.check(node, node.test, [self.schedule([ast.Expr(node.body)]),
                                             self.schedule([ast.Expr(node.orelse)])], "if")

    def check(self, node, test, arms, kind: str) -> None:
        """JAX's core invariant: where the collective schedules differ
        across the decision, the deciding value must be uniform over every
        axis they use."""
        self.report.conds_checked += 1
        differs = any(arms) if kind == "while" else len(set(arms)) > 1
        if not differs:
            return
        used = frozenset()
        for arm in arms:
            for _, axes in arm:
                used = used | axes
        uni = _flat(self.value(test))
        # A 1D mesh's collectives need the value uniform over the mesh;
        # a 2D view's over its own axis.
        need = used if used != AXES_2D else FULL
        if need <= uni:
            self.report.certified_divergent_safe += 1
            return
        where = f"{self.module}:{node.lineno} ({self.qual})"
        if where in self.seen:
            return
        self.seen.add(where)
        missing = sorted(need - uni)
        self.report.findings.append(Finding(
            "uniformity", where,
            f"{kind} selects between collective schedules but its selection value is NOT "
            f"mesh-uniform over axis(es) {missing}: ranks can take different arms and "
            f"deadlock the mesh mid-level. Route the value through a Mesh.all_reduce_ or "
            f"all_gather_rows over those axes (or loop-carry an already-uniform value) "
            f"before branching."))


def _meet(vals) -> frozenset:
    out = AXES_2D
    for v in vals:
        out = out & _flat(v)
    return out


def _mesh_like(expr) -> bool:
    text = ast.unparse(expr)
    return text.split(".")[-1] in ("mesh", "world", "r", "c", "_world") or text.endswith("mesh")


def _returns_of(fn, taint: _FunctionTaint):
    """A nested function's return uniformity: element-wise when every
    return is a tuple of one length, else the meet."""
    rets = [n.value for n in ast.walk(fn) if isinstance(n, ast.Return) and n.value is not None]
    if not rets:
        return AXES_2D
    vals = [taint.value(r) for r in rets]
    return _meet(vals)


def _schedules(tree) -> dict:
    """Function name -> the collectives it issues directly or through the
    module's other functions (a fixed point over the call graph)."""
    defs = {n.name: n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef,
                                                                ast.AsyncFunctionDef))}
    sigs: dict = {name: () for name in defs}
    for _ in range(6):
        changed = False
        for name, fn in defs.items():
            probe = _FunctionTaint("", fn, UniformityReport([]), sigs, set())
            sched = probe.schedule(fn.body)
            if sched != sigs[name]:
                sigs[name], changed = sched, True
        if not changed:
            break
    return sigs


def check_sources(sources: dict, extra_sigs: dict | None = None) -> UniformityReport:
    """The taint over ``{module path: source}``; every top-level function
    and method is a root."""
    report = UniformityReport([])
    trees = {m: ast.parse(src) for m, src in sources.items()}
    sigs: dict = dict(extra_sigs or {})
    for tree in trees.values():
        for name, sched in _schedules(tree).items():
            if sched:
                sigs[name] = sched
    seen: set = set()
    for module, tree in trees.items():
        lines = sources[module].splitlines()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) or isinstance(node, ast.Module):
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        report.functions += 1
                        _FunctionTaint(module, fn, report, sigs, seen, lines=lines).run(fn.body)
    return report


def check_tree(root: str) -> tuple[list[Finding], dict]:
    """The taint over the port's mesh modules (:data:`DEFAULT_GLOBS`)."""
    from pathlib import Path

    sources = {}
    for pattern in DEFAULT_GLOBS:
        for path in sorted(Path(root).glob(pattern)):
            rel = os.path.relpath(path, Path(root) / "tpu_bfs_torch")
            sources[rel] = path.read_text()
    rep = check_sources(sources)
    return rep.findings, {"modules": sorted(sources), "functions": rep.functions,
                          "conds_checked": rep.conds_checked,
                          "certified_divergent_safe": rep.certified_divergent_safe,
                          "annotated_uniform": sorted(rep.annotated)}


# --- the runtime half ---------------------------------------------------------------


def check_rank_signatures(name: str, signatures) -> list[Finding]:
    """``signatures[r]``: rank r's ordered ``Collective.signature``
    entries (op, group, shape, dtype) of one run. Every rank of each group
    must have issued the same sequence on that group."""
    by_group: dict = {}
    for rank, sig in enumerate(signatures):
        for entry in sig:
            by_group.setdefault(tuple(entry[1]), {}).setdefault(rank, []).append(entry)
    out = []
    for group, per_rank in sorted(by_group.items()):
        members = [r for r in group if r < len(signatures)]
        seqs = {r: per_rank.get(r, []) for r in members}
        ref = seqs[members[0]] if members else []
        bad = [r for r in members if seqs[r] != ref]
        if bad:
            first = next(i for i in range(max(len(s) for s in seqs.values()))
                         if len({tuple(map(str, s[i])) if i < len(s) else None
                                 for s in seqs.values()}) > 1)
            out.append(Finding(
                "uniformity/collective-signature", f"{name}:group{list(group)}",
                f"ranks {bad} issued a different collective sequence on group {list(group)} "
                f"than rank {members[0]} (first difference at call {first}: "
                f"{[seqs[r][first] if first < len(seqs[r]) else None for r in members]}): a "
                f"divergent branch choice deadlocks the mesh."))
    return out
