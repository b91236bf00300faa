"""Static and program checks of the port, the port of ``tpu_bfs/analysis``.

Seven passes, in JAX's order, over the port's sources and over the
``torch.export`` programs of its engines (``analysis/configs.py``: one
``ProgramSpec`` a program of each JAX config the port builds), with one
walking core (:mod:`.graph`: the wire tap over ``parallel/mesh.Mesh``'s
collectives and the FX walk of an exported program):

- **uniformity** (:mod:`.uniformity`): every branch point whose arms
  issue different ``Mesh`` collectives tests a mesh-uniform value (an AST
  taint over the host code that picks the branch), and after a run every
  rank of a group issued the same ordered collectives (the tap).
- **transfer** (:mod:`.transfer`): no host op in an exported hot program
  (a host read, a copy to the CPU, a data-dependent shape, a Python
  callback); on the card, each warmed program driven once under
  ``torch.cuda.set_sync_debug_mode("error")``; same-shape redrives of an
  adopted engine add no AOT fallback and no export; a packed dispatch
  and fetch materialise no distance words until asked.
- **locks** (:mod:`.locks`): ``# guarded-by: <lock>`` attributes are
  touched only under their lock, and the lock-order graph stays acyclic.
- **dtype** (:mod:`.dtypes`): no 64-bit node output in an exported hot
  program.
- **memory** (:mod:`.memory`): a buffer-liveness peak a program, the
  serve ladders' modeled peak strictly monotone in rung width, and the
  in-place writes an engine documents present in its program's graph.
- **lifecycle** (:mod:`.lifecycle`): every obs span begun reaches its end,
  every bare lock acquire a release, every resume-snapshot put a drop.
- **faultcov** (:mod:`.faultcov`): ``faults.SITES`` and the consultation
  sites agree, and every consulted site is driven by a test or by
  ``chip_smoke.py``.

Findings are fingerprinted (``pass:where``). The port's baseline file
(:data:`DEFAULT_BASELINE`, inside the package; the root
``analysis-baseline.txt`` is JAX's) suppresses parked findings, one
fingerprint a line with its reason in a ``#`` comment; an entry that
matches nothing is reported as stale. ``python -m tpu_bfs_torch.analysis``
(:mod:`.cli`) runs the passes and gates on new findings.
"""

from __future__ import annotations

import dataclasses
import os

#: The port's baseline: parked findings, each with its reason.
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.txt")

#: The passes, in JAX's registry order (the CLI's run and report order).
PASSES = (
    "uniformity", "transfer", "locks", "dtype",
    "memory", "lifecycle", "faultcov",
)
#: The passes that read only sources (:func:`run_pass`); the others also
#: read the engines' programs.
SOURCE_PASSES = ("uniformity", "locks", "lifecycle", "faultcov")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified defect: which pass, a stable location key, and an
    actionable message naming the offending module/branch/attribute."""

    pass_name: str
    where: str  # stable location key, e.g. "serve/metrics.py:ServeMetrics.completed"
    message: str

    @property
    def fingerprint(self) -> str:
        """Pass and location, without the message, so rewording a
        diagnostic keeps its key."""
        return f"{self.pass_name}:{self.where}"

    def render(self) -> str:
        return f"FINDING [{self.pass_name}] {self.where}: {self.message}"


def load_baseline(path: str) -> set[str]:
    """Fingerprints the baseline file suppresses; a missing file is an
    empty baseline."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return set()
    out = set()
    for line in lines:
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line)
    return out


def apply_baseline(findings: list[Finding], baseline: set[str]
                   ) -> tuple[list[Finding], list[Finding], set[str]]:
    """``(new, suppressed, stale)``: the findings the baseline does not
    suppress, those it does, and its entries that matched nothing (a
    suppression whose finding was fixed must be deleted)."""
    new, suppressed, hit = [], [], set()
    for f in findings:
        if f.fingerprint in baseline:
            suppressed.append(f)
            hit.add(f.fingerprint)
        else:
            new.append(f)
    return new, suppressed, baseline - hit


def run_pass(name: str, root: str) -> tuple[list[Finding], dict]:
    """One source pass of :data:`SOURCE_PASSES` over the checkout at
    ``root``."""
    if name == "uniformity":
        from tpu_bfs_torch.analysis.uniformity import check_tree

        return check_tree(root)
    if name == "locks":
        from tpu_bfs_torch.analysis.locks import lint_tree

        return lint_tree(root)
    if name == "lifecycle":
        from tpu_bfs_torch.analysis.lifecycle import check_tree

        return check_tree(root)
    if name == "faultcov":
        from tpu_bfs_torch.analysis.faultcov import check_tree

        return check_tree(root)
    raise ValueError(f"unknown pass {name!r}; the source passes are {SOURCE_PASSES}")
