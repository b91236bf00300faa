"""Lock-discipline lint over the port's serve tier and obs layer: the port
of ``tpu_bfs/analysis/locks.py``.

The serve/obs threads (scheduler, extraction worker, statsz emitter,
client threads, watchdog fetchers) share state behind half a dozen small
locks, and several paths hold a lock while calling into another module
(registry build under the registry lock emits recorder spans; the
breaker logs under its lock). Two machine-checkable disciplines keep
that safe, both enforced from source by this AST pass — no runtime, no
imports of the linted modules:

**guarded-by annotations.** An attribute whose every access must happen
under a lock is annotated where it is first assigned::

    self._items: deque = deque()  # guarded-by: _cond

After that, any ``self._items`` access outside a ``with self._cond:``
block (or outside a method annotated ``# requires-lock: _cond`` on its
``def`` line — the caller-holds-the-lock contract) is a finding.
``__init__``/``__new__`` are exempt (construction happens-before
publication), and the ``acquire(timeout=...)/try/finally: release()``
idiom is recognized (the try body counts as guarded). Annotations are
opt-in: deliberately lock-free flags (drain bools, immutable config)
simply stay unannotated.

**lock-order acyclicity.** Every annotated or ``with``-acquired lock is
a node ``Class.lockattr``; an edge A -> B is recorded when code holding
A may acquire B — directly (nested ``with``), or transitively through
calls: same-class method calls, and calls on attributes whose class is
inferred from their ``self.attr = ClassName(...)`` construction site
(cross-module: the service's ``self.metrics = ServeMetrics()`` types
``self.metrics.*`` calls; ``rec = _obs.ACTIVE`` locals type as Recorder).
Method acquisition summaries are closed under the call graph before
edges are drawn, so holding the registry lock through ``_build`` into a
recorder span still records registry._lock -> Recorder._lock.
Re-acquiring a lock constructed as ``threading.RLock()`` is allowed
(reentrant); any other cycle in the graph is a finding listing the
cycle — the deadlock shape no test on a fast machine ever hits.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize

from tpu_bfs_torch.analysis import Finding

GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
REQUIRES_RE = re.compile(r"#\s*requires-lock:\s*([A-Za-z_]\w*)")

#: Locals assigned from these module attributes get a known class — the
#: process-global singletons the serve tier calls under its own locks.
GLOBAL_TYPE_HINTS = {
    ("_obs", "ACTIVE"): "Recorder",
    ("obs", "ACTIVE"): "Recorder",
}


def _line_comments(source: str) -> dict[int, str]:
    """line number -> comment text (tokenize keeps what ast drops)."""
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenizeError:
        pass
    return out


def _self_attr(node) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _calls_in_value(val):
    """Call nodes a value expression may construct from (handles the
    ``registry or EngineRegistry(...)`` default-construction idiom)."""
    if isinstance(val, ast.Call):
        yield val
    elif isinstance(val, ast.BoolOp):
        for v in val.values:
            yield from _calls_in_value(v)
    elif isinstance(val, ast.IfExp):
        yield from _calls_in_value(val.body)
        yield from _calls_in_value(val.orelse)


class ClassModel:
    """Everything the lint learned about one class."""

    def __init__(self, module: str, name: str):
        self.module = module
        self.name = name
        self.guarded: dict[str, str] = {}  # attr -> lock attr
        self.requires: dict[str, str] = {}  # method -> lock attr
        self.rlocks: set[str] = set()  # lock attrs built as RLock()
        self.attr_types: dict[str, str] = {}  # attr/local -> class name
        self.methods: dict[str, ast.FunctionDef] = {}

    def key(self, lock: str) -> str:
        return f"{self.name}.{lock}"


def _collect_class(module: str, cls: ast.ClassDef, comments) -> ClassModel:
    model = ClassModel(module, cls.name)
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        model.methods[item.name] = item
        m = REQUIRES_RE.search(comments.get(item.lineno, ""))
        if m:
            model.requires[item.name] = m.group(1)
        for node in ast.walk(item):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                cm = GUARDED_RE.search(comments.get(node.lineno, ""))
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        # Typed locals from known globals (rec = _obs.ACTIVE).
                        if (
                            isinstance(tgt, ast.Name)
                            and isinstance(node.value, ast.Attribute)
                            and isinstance(node.value.value, ast.Name)
                        ):
                            hint = GLOBAL_TYPE_HINTS.get(
                                (node.value.value.id, node.value.attr)
                            )
                            if hint:
                                model.attr_types[f"<local>{tgt.id}"] = hint
                        continue
                    if cm:
                        model.guarded[attr] = cm.group(1)
                    for call in _calls_in_value(getattr(node, "value", None)):
                        fn = call.func
                        if isinstance(fn, ast.Name):
                            model.attr_types.setdefault(attr, fn.id)
                        elif isinstance(fn, ast.Attribute):
                            model.attr_types.setdefault(attr, fn.attr)
                            if fn.attr == "RLock":
                                model.rlocks.add(attr)
    return model


def _with_locks(stmt: ast.With) -> list[str]:
    """Lock attrs acquired by a ``with self.<lock>[:]`` statement."""
    out = []
    for item in stmt.items:
        attr = _self_attr(item.context_expr)
        if attr is not None:
            out.append(attr)
    return out


def _release_locks(stmts) -> list[str]:
    """Lock attrs released by ``self.<lock>.release()`` calls in stmts."""
    out = []
    for stmt in stmts:
        for node in ast.walk(stmt):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "release"
            ):
                attr = _self_attr(node.func.value)
                if attr is not None:
                    out.append(attr)
    return out


def _callees_of(model: ClassModel, fn) -> set[tuple[str, str]]:
    """(class, method) targets a method may call, through self and typed
    attributes/locals — the call graph the acquisition closure runs on."""
    out: set[tuple[str, str]] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or not isinstance(
            node.func, ast.Attribute
        ):
            continue
        target = _self_attr(node.func)
        if target is not None:
            out.add((model.name, target))
            continue
        owner = node.func.value
        owner_attr = _self_attr(owner)
        if owner_attr is not None:
            cls = model.attr_types.get(owner_attr)
        elif isinstance(owner, ast.Name):
            cls = model.attr_types.get(f"<local>{owner.id}")
        else:
            cls = None
        if cls:
            out.add((cls, node.func.attr))
    return out


def _direct_acquires(model: ClassModel, fn) -> set[str]:
    """Node keys a method acquires directly (with blocks + the
    acquire/try/finally-release idiom)."""
    locks: set[str] = set()

    def visit(stmts):
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                locks.update(_with_locks(stmt))
                visit(stmt.body)
            elif isinstance(stmt, ast.Try):
                locks.update(_release_locks(stmt.finalbody))
                visit(stmt.body)
                for h in stmt.handlers:
                    visit(h.body)
                visit(stmt.orelse)
                visit(stmt.finalbody)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(stmt.body)  # nested fns acquire on whatever thread
            else:
                for node in ast.iter_child_nodes(stmt):
                    if isinstance(node, ast.stmt):
                        visit([node])
                    elif isinstance(node, (ast.If, ast.While, ast.For)):
                        visit([node])

    visit(fn.body)
    return {model.key(lk) for lk in locks}


def _acquisition_closure(classes: dict[str, ClassModel]) -> dict:
    """(class, method) -> node keys it may acquire, closed under the call
    graph (fixed point; the graphs here are tiny)."""
    direct: dict[tuple[str, str], set[str]] = {}
    calls: dict[tuple[str, str], set[tuple[str, str]]] = {}
    for model in classes.values():
        for name, fn in model.methods.items():
            direct[(model.name, name)] = _direct_acquires(model, fn)
            calls[(model.name, name)] = _callees_of(model, fn)
    acq = {k: set(v) for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for k, callees in calls.items():
            for c in callees:
                extra = acq.get(c, ())
                if not set(extra) <= acq[k]:
                    acq[k].update(extra)
                    changed = True
    return acq


class _MethodWalker:
    """Walk one method tracking the held-lock set, reporting guarded-attr
    accesses outside their lock and lock-acquisition edges."""

    def __init__(self, model: ClassModel, classes: dict[str, ClassModel],
                 acquires: dict, findings: list[Finding], edges: set):
        self.model = model
        self.classes = classes
        self.acquires = acquires
        self.findings = findings
        self.edges = edges
        self.exempt = False

    def walk_method(self, name: str, fn) -> None:
        held: set[str] = set()
        req = self.model.requires.get(name)
        if req:
            held.add(req)
        self.exempt = name in ("__init__", "__new__")
        self._stmts(fn.body, held, name)

    # --- statements ---------------------------------------------------------

    def _stmts(self, stmts, held: set, method: str) -> None:
        for stmt in stmts:
            self._stmt(stmt, held, method)

    def _stmt(self, stmt, held: set, method: str) -> None:
        if isinstance(stmt, ast.With):
            locks = _with_locks(stmt)
            for lk in locks:
                self._acquire_lock(lk, held, method, stmt.lineno)
            for item in stmt.items:
                self._expr(item.context_expr, held, method)
            self._stmts(stmt.body, held | set(locks), method)
            return
        if isinstance(stmt, ast.Try):
            released = set(_release_locks(stmt.finalbody))
            if released:
                # The acquire(timeout)/try/finally-release idiom
                # (EngineRegistry.resident): the try body runs with the
                # released locks held.
                for lk in released:
                    self._acquire_lock(lk, held, method, stmt.lineno)
                self._stmts(stmt.body, held | released, method)
            else:
                self._stmts(stmt.body, held, method)
            for h in stmt.handlers:
                self._stmts(h.body, held, method)
            self._stmts(stmt.orelse, held, method)
            self._stmts(stmt.finalbody, held, method)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested function runs later on whatever thread calls it —
            # the lexically-held locks are NOT held there.
            self._stmts(stmt.body, set(), method)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test, held, method)
            self._stmts(stmt.body, held, method)
            self._stmts(stmt.orelse, held, method)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter, held, method)
            self._expr(stmt.target, held, method)
            self._stmts(stmt.body, held, method)
            self._stmts(stmt.orelse, held, method)
            return
        if isinstance(stmt, ast.ClassDef):
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._expr(node, held, method)
            elif isinstance(node, ast.stmt):
                self._stmt(node, held, method)

    # --- expressions --------------------------------------------------------

    def _expr(self, node, held: set, method: str) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute):
                attr = _self_attr(sub)
                if attr is None:
                    continue
                lock = self.model.guarded.get(attr)
                if lock is not None and lock not in held and not self.exempt:
                    self.findings.append(Finding(
                        "locks",
                        f"{self.model.module}:{self.model.name}."
                        f"{attr}@{method}",
                        f"attribute `{attr}` is `# guarded-by: {lock}` "
                        f"but `{self.model.name}.{method}` touches it at "
                        f"line {sub.lineno} without holding "
                        f"`self.{lock}` — wrap the access in "
                        f"`with self.{lock}:` or mark the method "
                        f"`# requires-lock: {lock}`.",
                    ))
            elif isinstance(sub, ast.Call):
                self._call(sub, held, method)

    def _call(self, call: ast.Call, held: set, method: str) -> None:
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return
        target = _self_attr(fn)
        if target is not None and target in self.model.methods:
            req = self.model.requires.get(target)
            if req is not None and req not in held:
                self.findings.append(Finding(
                    "locks",
                    f"{self.model.module}:{self.model.name}."
                    f"{target}@{method}",
                    f"`{self.model.name}.{target}` is "
                    f"`# requires-lock: {req}` but `{method}` calls it "
                    f"at line {call.lineno} without holding "
                    f"`self.{req}`.",
                ))
            self._edges_for(held, (self.model.name, target))
            return
        owner = fn.value
        owner_attr = _self_attr(owner)
        if owner_attr is not None:
            cls = self.model.attr_types.get(owner_attr)
        elif isinstance(owner, ast.Name):
            cls = self.model.attr_types.get(f"<local>{owner.id}")
        else:
            cls = None
        if cls in self.classes:
            self._edges_for(held, (cls, fn.attr))

    # --- edges --------------------------------------------------------------

    def _acquire_lock(self, lock: str, held: set, method: str,
                      lineno: int) -> None:
        if lock in held and lock not in self.model.rlocks:
            self.findings.append(Finding(
                "locks",
                f"{self.model.module}:{self.model.name}.{lock}@{method}",
                f"`self.{lock}` re-acquired at line {lineno} while "
                f"already held and not an RLock — self-deadlock.",
            ))
        dst = self.model.key(lock)
        for h in held:
            src = self.model.key(h)
            if src != dst:
                self.edges.add((src, dst))

    def _edges_for(self, held: set, callee: tuple[str, str]) -> None:
        for dst in self.acquires.get(callee, ()):
            for h in held:
                src = self.model.key(h)
                if src != dst:
                    self.edges.add((src, dst))


def find_cycles(edges: set) -> list[list[str]]:
    """Elementary cycles of the lock graph via DFS (tiny graphs)."""
    graph: dict[str, set] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles, seen_cycles = [], set()

    def dfs(node, path, on_path):
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return cycles


def lint_sources(sources: dict[str, str]) -> tuple[list[Finding], dict]:
    """Lint a set of ``{module_label: source_text}``. Returns (findings,
    info) where info carries the annotated-attr count and the lock-order
    edge list for the report."""
    findings: list[Finding] = []
    classes: dict[str, ClassModel] = {}
    for module, src in sources.items():
        comments = _line_comments(src)
        try:
            tree = ast.parse(src)
        except SyntaxError as exc:
            findings.append(Finding(
                "locks", f"{module}:<parse>", f"unparsable module: {exc}"
            ))
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                model = _collect_class(module, node, comments)
                classes[model.name] = model
    acquires = _acquisition_closure(classes)
    edges: set = set()
    for model in classes.values():
        walker = _MethodWalker(model, classes, acquires, findings, edges)
        for name, fn in model.methods.items():
            walker.walk_method(name, fn)
    for cyc in find_cycles(edges):
        findings.append(Finding(
            "locks",
            "lock-order:" + "->".join(cyc),
            f"lock-acquisition-order cycle {' -> '.join(cyc)}: two "
            f"threads taking these locks in opposite orders deadlock. "
            f"Pick one global order (or drop a lock from the inner "
            f"call).",
        ))
    info = {
        "classes": len(classes),
        "guarded_attrs": sum(len(c.guarded) for c in classes.values()),
        "edges": sorted(edges),
    }
    return findings, info


#: The modules the repo-level lint covers: the serve tier and the
#: recorder (every class that holds a lock across a callback boundary);
#: the integrity tier's threaded pieces (the shadow auditor's queue and
#: worker, the structural auditor's lazy device tables, the quarantine
#: counters); the answer tier (LRU cache state and the landmark hit
#: counters, mutated from every client thread at once); and dynamic
#: graphs (the overlay apply/compact state machine and the staleness
#: auditor's sample ring, mutated by the mutation thread while serving
#: threads read them).
DEFAULT_MODULES = (
    "tpu_bfs_torch/serve/scheduler.py",
    "tpu_bfs_torch/serve/frontend.py",
    "tpu_bfs_torch/serve/executor.py",
    "tpu_bfs_torch/serve/metrics.py",
    "tpu_bfs_torch/serve/registry.py",
    "tpu_bfs_torch/obs/recorder.py",
    "tpu_bfs_torch/integrity/__init__.py",
    "tpu_bfs_torch/integrity/shadow.py",
    "tpu_bfs_torch/integrity/structural.py",
    "tpu_bfs_torch/serve/answercache.py",
    "tpu_bfs_torch/workloads/landmarks.py",
    "tpu_bfs_torch/graph/dynamic.py",
    "tpu_bfs_torch/integrity/staleness.py",
)


def lint_tree(root: str, modules=DEFAULT_MODULES) -> tuple[list[Finding], dict]:
    sources = {}
    for rel in modules:
        path = os.path.join(root, rel)
        with open(path) as f:
            sources[rel] = f.read()
    return lint_sources(sources)


def repo_root() -> str:
    """The checkout root (two levels above this package)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
