"""Exception-path resource-leak verification over the port's serve, obs
and resilience code: the port of ``tpu_bfs/analysis/lifecycle.py``.

One defect class recurs in threaded serving code: an obs span left open
when an error rode up through an exception path, a resume snapshot never
dropped once its query terminally resolved, a lock released on the happy
path only. The lock pass (``locks.py``) checks *where* guarded
attributes are touched; this pass checks *flow*
— a path-sensitive walk of every function's statement graph, exception
edges included, verifying that what gets opened gets closed on EVERY
path out:

- **spans**: each ``<recorder>.begin(<name>, ...)`` must reach a
  matching ``.end(<name>, ...)`` on every exit — normal returns,
  fall-off, and explicit ``raise`` paths (a dangling Perfetto ``b``
  event is exactly this defect). Span keys are the first-
  argument literal (or the variable name when the site names the span
  dynamically, e.g. the registry's ``engine_adopt``/``engine_build``
  pick — begin and end share the variable). A span whose ownership
  deliberately crosses functions (the query span opens at admission and
  closes at resolve) is annotated ``# span-outlives: <who closes it>``
  on its begin line — the annotation is the documented transfer of
  ownership, not a suppression.
- **locks**: a bare ``<lock>.acquire(...)`` must reach ``.release()``
  on every path (the ``if not lock.acquire(timeout=..): return`` idiom
  is modeled: the lock is held only on the fall-through). ``with``
  blocks need no checking — the context manager is the proof.
- **resume snapshots**: a class that ``put``s into a ResumeCache must
  also ``drop`` — a put-only class pins ~3x[V] host arrays per source
  forever. Receivers are typed from their
  ``ResumeCache(...)``/``cache_for_graph(...)`` construction sites or a
  ``resume``-named attribute.

The walk models explicit ``raise`` statements and ``try``/``except``/
``finally`` edges (handler entry receives the union of open-sets from
every point of the try body — the standard conservative approximation).
Implicit raises from arbitrary calls are NOT modeled: flagging every
call as a potential raise would demand try/finally around every span,
which is not the codebase's (correct) shape — the historical bugs were
all on explicit raise/handler paths, which this pass covers exactly.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

from tpu_bfs_torch.analysis import Finding

SPAN_OUTLIVES_RE = re.compile(r"#\s*span-outlives:\s*(.+)")

#: The modules the repo-level pass covers: the serve tier, the obs layer,
#: the resilience machinery and the 2D serve adapter, whose chunked drive
#: owns the real snapshot put/drop pair; the integrity tier (audit worker
#: lifecycle, quarantine); the answer tier, whose landmark warm-up opens
#: an obs span; and dynamic graphs, where a compaction crash must never
#: leave a span open.
DEFAULT_MODULES = (
    "tpu_bfs_torch/serve/scheduler.py",
    "tpu_bfs_torch/serve/frontend.py",
    "tpu_bfs_torch/serve/executor.py",
    "tpu_bfs_torch/serve/registry.py",
    "tpu_bfs_torch/serve/metrics.py",
    "tpu_bfs_torch/obs/__init__.py",
    "tpu_bfs_torch/obs/recorder.py",
    "tpu_bfs_torch/obs/engine_trace.py",
    "tpu_bfs_torch/obs/exporters.py",
    "tpu_bfs_torch/resilience/failover.py",
    "tpu_bfs_torch/resilience/probe.py",
    "tpu_bfs_torch/resilience/resume.py",
    "tpu_bfs_torch/parallel/dist_bfs2d.py",
    "tpu_bfs_torch/integrity/__init__.py",
    "tpu_bfs_torch/integrity/shadow.py",
    "tpu_bfs_torch/integrity/structural.py",
    "tpu_bfs_torch/serve/answercache.py",
    "tpu_bfs_torch/graph/dynamic.py",
    "tpu_bfs_torch/integrity/staleness.py",
    "tpu_bfs_torch/workloads/landmarks.py",
)


def _line_comments(source: str) -> dict[int, str]:
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenizeError:
        pass
    return out


def _span_key(call: ast.Call) -> str | None:
    """Span identity of a begin/end call: the literal name, or the
    variable carrying it (begin/end sharing one variable still match)."""
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value
    if isinstance(a, ast.Name):
        return f"${a.id}"
    return None


def _recv_key(node) -> str | None:
    """Stable key of a lock/cache receiver: 'self.X' or a bare name."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return f"{node.value.id}.{node.attr}"
    if isinstance(node, ast.Name):
        return node.id
    return None


@dataclasses.dataclass
class _Effect:
    kind: str  # "open" | "close"
    res: str  # resource key, e.g. "span:dispatch" / "lock:self._lock"
    lineno: int
    outlives: str | None = None  # span-outlives annotation text


def _guard_key(test) -> tuple[str, bool] | None:
    """``(name, truth_when_taken)`` for the recorder-guard test shapes:
    ``X``, ``not X``, ``X is None``, ``X is not None`` — X a Name or a
    dotted attribute (``_obs.ACTIVE``). The walker correlates branches
    on the same key, so `if rec is not None: begin(...)` and a later
    `if rec is not None: end(...)` take consistent arms instead of
    manufacturing a phantom begun-but-never-ended path."""
    neg = False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        test, neg = test.operand, True
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and isinstance(
        test.comparators[0], ast.Constant
    ) and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.IsNot):
            pass  # `X is not None` == truthy X
        elif isinstance(test.ops[0], ast.Is):
            neg = not neg  # `X is None` == falsy X
        else:
            return None
        test = test.left
    key = _recv_key(test)
    if key is None:
        return None
    return key, not neg


class _FnChecker:
    """Path-sensitive resource walk of one function.

    A state is ``(resources, guards)``: the open-resource set plus the
    truth assignments of the guard names branched on so far — the
    minimum correlation needed for the codebase's pervasive
    ``rec = _obs.ACTIVE; if rec is not None: begin/end`` idiom."""

    def __init__(self, module: str, qualname: str, comments: dict,
                 findings: list):
        self.module = module
        self.qualname = qualname
        self.comments = comments
        self.findings = findings
        self.open_sites: dict[str, int] = {}  # resource -> first-open line
        self.reported: set = set()  # (resource, how) already reported

    # --- effects ------------------------------------------------------------

    def _effects(self, node) -> list[_Effect]:
        out: list[_Effect] = []
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) or not isinstance(
                sub.func, ast.Attribute
            ):
                continue
            attr = sub.func.attr
            if attr in ("begin", "end"):
                key = _span_key(sub)
                if key is None:
                    continue
                m = SPAN_OUTLIVES_RE.search(
                    self.comments.get(sub.lineno, "")
                )
                out.append(_Effect(
                    "open" if attr == "begin" else "close",
                    f"span:{key}", sub.lineno,
                    outlives=m.group(1).strip() if m else None,
                ))
            elif attr == "acquire":
                key = _recv_key(sub.func.value)
                if key is not None:
                    out.append(_Effect("open", f"lock:{key}", sub.lineno))
            elif attr == "release":
                key = _recv_key(sub.func.value)
                if key is not None:
                    out.append(_Effect("close", f"lock:{key}", sub.lineno))
        return out

    def _apply(self, states: set, node) -> set:
        effs = self._effects(node)
        if not effs:
            return states
        out = set()
        for res, guards in states:
            cur = set(res)
            for e in effs:
                if e.kind == "open":
                    if e.outlives is not None:
                        continue  # documented ownership transfer
                    cur.add(e.res)
                    self.open_sites.setdefault(e.res, e.lineno)
                else:
                    cur.discard(e.res)
            out.add((frozenset(cur), guards))
        return out

    @staticmethod
    def _invalidate_guards(states: set, node) -> set:
        """An assignment to a guard name forgets its recorded truth."""
        names = set()
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                key = _recv_key(tgt)
                if key:
                    names.add(key)
        if not names:
            return states
        return {
            (res, frozenset(
                (k, v) for k, v in guards
                if k not in names and k.split(".", 1)[0] not in names
            ))
            for res, guards in states
        }

    # --- block walk ---------------------------------------------------------

    def run(self, fn) -> None:
        res = self._block(fn.body, {(frozenset(), frozenset())})
        for st, _guards in res["normal"] | res["returned"]:
            self._report(st, "on a normal exit")
        for st, _guards in res["raised"]:
            self._report(st, "across a raise")

    def _report(self, st: frozenset, how: str) -> None:
        for resource in sorted(st):
            if (resource, how) in self.reported:
                continue  # one finding per resource/exit kind per fn
            self.reported.add((resource, how))
            kind, _, key = resource.partition(":")
            line = self.open_sites.get(resource, 0)
            noun = "span" if kind == "span" else "lock"
            fix = (
                "close it on every path (end in the handler/finally "
                "before the raise propagates), or annotate the begin "
                "`# span-outlives: <who closes it>` if ownership "
                "deliberately crosses functions"
                if kind == "span"
                else "release in a try/finally"
            )
            self.findings.append(Finding(
                "lifecycle",
                f"{self.module}:{self.qualname}@{kind}:{key}",
                f"{noun} `{key}` opened at line {line} is still open "
                f"{how} of `{self.qualname}` — {fix}.",
            ))

    def _block(self, stmts, states: set) -> dict:
        res = {
            "normal": set(states), "raised": set(), "returned": set(),
            "broke": set(), "continued": set(), "seen": set(states),
        }
        for stmt in stmts:
            if not res["normal"]:
                break
            step = self._stmt(stmt, res["normal"])
            res["normal"] = step["normal"]
            for k in ("raised", "returned", "broke", "continued", "seen"):
                res[k] |= step[k]
        res["seen"] |= res["normal"]
        return res

    def _leaf(self, states: set, stmt) -> dict:
        out = self._invalidate_guards(self._apply(states, stmt), stmt)
        return {
            "normal": out, "raised": set(), "returned": set(),
            "broke": set(), "continued": set(), "seen": set(out),
        }

    def _stmt(self, stmt, states: set) -> dict:
        if isinstance(stmt, ast.Return):
            out = (
                self._apply(states, stmt.value)
                if stmt.value is not None else states
            )
            return {
                "normal": set(), "raised": set(), "returned": set(out),
                "broke": set(), "continued": set(), "seen": set(out),
            }
        if isinstance(stmt, ast.Raise):
            out = (
                self._apply(states, stmt.exc)
                if stmt.exc is not None else states
            )
            return {
                "normal": set(), "raised": set(out), "returned": set(),
                "broke": set(), "continued": set(), "seen": set(out),
            }
        if isinstance(stmt, ast.Break):
            return {
                "normal": set(), "raised": set(), "returned": set(),
                "broke": set(states), "continued": set(), "seen": set(),
            }
        if isinstance(stmt, ast.Continue):
            return {
                "normal": set(), "raised": set(), "returned": set(),
                "broke": set(), "continued": set(states), "seen": set(),
            }
        if isinstance(stmt, ast.If):
            return self._if(stmt, states)
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._loop(stmt, states)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, states)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # Context managers close themselves; item expressions may
            # still carry effects (rare; e.g. a begin used as a value).
            entry = states
            for item in stmt.items:
                entry = self._apply(entry, item.context_expr)
            return self._block(stmt.body, entry)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested function runs later; its body is checked as its
            # own function, with a fresh open-set.
            _FnChecker(
                self.module, f"{self.qualname}.{stmt.name}", self.comments,
                self.findings,
            ).run(stmt)
            return {
                "normal": set(states), "raised": set(), "returned": set(),
                "broke": set(), "continued": set(), "seen": set(),
            }
        if isinstance(stmt, ast.ClassDef):
            return {
                "normal": set(states), "raised": set(), "returned": set(),
                "broke": set(), "continued": set(), "seen": set(),
            }
        return self._leaf(states, stmt)

    def _if(self, stmt: ast.If, states: set) -> dict:
        # The timeout-acquire idiom: `if not X.acquire(..): return` —
        # the lock is held only on the fall-through.
        acq = [
            e for e in self._effects(stmt.test)
            if e.kind == "open" and e.res.startswith("lock:")
        ]
        negated = isinstance(stmt.test, ast.UnaryOp) and isinstance(
            stmt.test.op, ast.Not
        )
        body_terminates = stmt.body and all(
            isinstance(s, (ast.Return, ast.Raise, ast.Continue, ast.Break))
            for s in stmt.body
        ) and not stmt.orelse
        if acq and negated and body_terminates:
            fail = self._stmt_seq(stmt.body, states)  # lock NOT held
            held = set()
            for res, guards in states:
                cur = set(res)
                for e in acq:
                    cur.add(e.res)
                    self.open_sites.setdefault(e.res, e.lineno)
                held.add((frozenset(cur), guards))
            fail["normal"] |= held
            return fail
        gk = _guard_key(stmt.test)
        if gk is not None:
            key, truth = gk
            body_states: set = set()
            else_states: set = set()
            for res, guards in states:
                known = dict(guards).get(key)
                if known is None:
                    body_states.add(
                        (res, frozenset(guards | {(key, truth)}))
                    )
                    else_states.add(
                        (res, frozenset(guards | {(key, not truth)}))
                    )
                elif known == truth:
                    body_states.add((res, guards))
                else:
                    else_states.add((res, guards))
            body = self._block(stmt.body, body_states)
            orelse = self._block(stmt.orelse, else_states)
            return _merge(body, orelse)
        entry = self._apply(states, stmt.test)
        body = self._block(stmt.body, entry)
        orelse = self._block(stmt.orelse, entry)
        return _merge(body, orelse)

    def _stmt_seq(self, stmts, states: set) -> dict:
        return self._block(stmts, states)

    def _loop(self, stmt, states: set) -> dict:
        if isinstance(stmt, ast.While):
            entry = self._apply(states, stmt.test)
            infinite = isinstance(stmt.test, ast.Constant) and bool(
                stmt.test.value
            )
        else:
            entry = self._apply(states, stmt.iter)
            infinite = False
        res = {
            "normal": set(), "raised": set(), "returned": set(),
            "broke": set(), "continued": set(), "seen": set(),
        }
        reach = set(entry)
        for _ in range(8):  # resource sets are tiny; fixed point is fast
            body = self._block(stmt.body, reach)
            res["raised"] |= body["raised"]
            res["returned"] |= body["returned"]
            res["broke"] |= body["broke"]
            res["seen"] |= body["seen"]
            nxt = reach | body["normal"] | body["continued"]
            if nxt == reach:
                break
            reach = nxt
        # Python runs a loop's `else` only on NON-break exhaustion; break
        # states bypass it and merge after (a close placed only in the
        # else clause must not count for the break path).
        exits = set() if infinite else set(reach)
        if stmt.orelse:
            exits = self._block(stmt.orelse, exits)["normal"]
        exits |= res["broke"]
        return {
            "normal": exits, "raised": res["raised"],
            "returned": res["returned"], "broke": set(),
            "continued": set(), "seen": res["seen"],
        }

    def _try(self, stmt: ast.Try, states: set) -> dict:
        body = self._block(stmt.body, states)
        # Handler entry: the union of every open-set reachable anywhere
        # in the try body (an exception can fire between any two
        # statements), plus the explicit-raise states.
        handler_entry = body["seen"] | body["raised"] | set(states)
        out = {
            "normal": set(body["normal"]), "raised": set(),
            "returned": set(body["returned"]), "broke": set(body["broke"]),
            "continued": set(body["continued"]), "seen": set(body["seen"]),
        }
        if stmt.handlers:
            for h in stmt.handlers:
                hr = self._block(h.body, handler_entry)
                out["normal"] |= hr["normal"]
                out["raised"] |= hr["raised"]
                out["returned"] |= hr["returned"]
                out["broke"] |= hr["broke"]
                out["continued"] |= hr["continued"]
                out["seen"] |= hr["seen"]
        else:
            out["raised"] |= body["raised"] | body["seen"]
        if stmt.orelse:
            els = self._block(stmt.orelse, out["normal"])
            out["normal"] = els["normal"]
            out["raised"] |= els["raised"]
            out["returned"] |= els["returned"]
            out["seen"] |= els["seen"]
        if stmt.finalbody:
            for key in ("normal", "raised", "returned", "broke",
                        "continued"):
                out[key] = self._block(stmt.finalbody, out[key])["normal"] \
                    if out[key] else out[key]
        return out


def _merge(a: dict, b: dict) -> dict:
    return {k: a[k] | b[k] for k in a}


# --- resume-snapshot protocol ----------------------------------------------

_RESUME_CTORS = ("ResumeCache", "cache_for_graph")


def _is_resume_recv(key: str | None, typed: set) -> bool:
    if key is None:
        return False
    return key in typed or "resume" in key.lower()


def _check_snapshots(module: str, tree: ast.Module,
                     findings: list) -> None:
    """Per class (and per module top level): a ``.put(`` on a
    ResumeCache-typed receiver demands a reachable ``.drop(`` in the
    same scope — the terminal-resolution half of the snapshot protocol."""

    def scan(scope_name: str, nodes) -> None:
        typed: set = set()
        puts: list = []
        drops = 0
        for node in nodes:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Call
                ):
                    fn = sub.value.func
                    ctor = (
                        fn.attr if isinstance(fn, ast.Attribute)
                        else fn.id if isinstance(fn, ast.Name) else None
                    )
                    if ctor in _RESUME_CTORS:
                        for tgt in sub.targets:
                            key = _recv_key(tgt)
                            if key:
                                typed.add(key)
                if not isinstance(sub, ast.Call) or not isinstance(
                    sub.func, ast.Attribute
                ):
                    continue
                recv = _recv_key(sub.func.value)
                if sub.func.attr == "put" and _is_resume_recv(recv, typed):
                    puts.append((recv, sub.lineno))
                elif sub.func.attr == "drop" and _is_resume_recv(
                    recv, typed
                ):
                    drops += 1
        if puts and not drops:
            recv, lineno = puts[0]
            findings.append(Finding(
                "lifecycle",
                f"{module}:{scope_name}@snapshot:{recv}",
                f"`{scope_name}` puts resume snapshots into `{recv}` "
                f"(line {lineno}) but never drops any: terminally "
                f"resolved queries keep ~3x[V] host arrays pinned in the "
                f"per-graph cache forever. Drop "
                f"on terminal resolution.",
            ))

    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    for cls in classes:
        scan(cls.name, cls.body)
    class_ids = {id(c) for c in classes}
    top = [
        n for n in tree.body
        if not (isinstance(n, ast.ClassDef) and id(n) in class_ids)
    ]
    scan("<module>", top)


# --- entry points -----------------------------------------------------------


def check_sources(sources: dict[str, str]) -> tuple[list[Finding], dict]:
    """The pass over ``{module_label: source}``. Returns ``(findings,
    info)``; info counts functions walked and annotated escapes."""
    findings: list[Finding] = []
    functions = 0
    outlives = 0
    for module, src in sources.items():
        comments = _line_comments(src)
        outlives += sum(
            1 for c in comments.values() if SPAN_OUTLIVES_RE.search(c)
        )
        try:
            tree = ast.parse(src)
        except SyntaxError as exc:
            findings.append(Finding(
                "lifecycle", f"{module}:<parse>",
                f"unparsable module: {exc}",
            ))
            continue
        # Top-level and method functions; nested defs are walked by their
        # parents (fresh open-set — they run on another thread/later).
        def walk_scope(prefix: str, body) -> None:
            nonlocal functions
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    functions += 1
                    _FnChecker(
                        module, f"{prefix}{node.name}", comments, findings
                    ).run(node)
                elif isinstance(node, ast.ClassDef):
                    walk_scope(f"{node.name}.", node.body)

        walk_scope("", tree.body)
        _check_snapshots(module, tree, findings)
    return findings, {"functions": functions, "span_outlives": outlives}


def check_tree(root: str, modules=DEFAULT_MODULES) -> tuple[list, dict]:
    sources = {}
    for rel in modules:
        with open(os.path.join(root, rel)) as f:
            sources[rel] = f.read()
    return check_sources(sources)
