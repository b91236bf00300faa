"""Static checks of the port's own sources: the AST passes of
``tpu_bfs/analysis``, run over ``tpu_bfs_torch``.

- **locks** (:mod:`.locks`): ``# guarded-by: <lock>`` attributes are
  touched only under their lock (or in a method marked ``# requires-lock:
  <lock>`` on its ``def`` line, whose callers hold it), and the
  lock-acquisition-order graph across the serve tier stays acyclic.
- **lifecycle** (:mod:`.lifecycle`): every obs span begun reaches its end,
  every bare lock acquire a release and every resume-snapshot put a drop,
  on every path, raises included.
- **faultcov** (:mod:`.faultcov`): the port's ``faults.SITES`` and its
  consultation sites agree, and every consulted site is driven by a test
  or by ``chip_smoke.py``.

``python -m tpu_bfs_torch.analysis`` runs the three and exits 1 on a
finding. The JAX package's jaxpr and HLO passes (uniformity, transfer,
dtypes, memory) read programs the port does not have and are not ported.
"""

from __future__ import annotations

import dataclasses

#: The passes, in the order the runner runs and reports them.
PASSES = ("locks", "lifecycle", "faultcov")


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


def run_pass(name: str, root: str) -> tuple[list[Finding], dict]:
    """One pass of :data:`PASSES` over the checkout at ``root``."""
    if name == "locks":
        from tpu_bfs_torch.analysis.locks import lint_tree

        return lint_tree(root)
    if name == "lifecycle":
        from tpu_bfs_torch.analysis.lifecycle import check_tree

        return check_tree(root)
    if name == "faultcov":
        from tpu_bfs_torch.analysis.faultcov import check_tree

        return check_tree(root)
    raise ValueError(f"unknown pass {name!r}; expected one of {PASSES}")
