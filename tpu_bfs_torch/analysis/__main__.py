"""``python -m tpu_bfs_torch.analysis``: run the AST passes over the port.

Prints one summary line a pass on stderr and every finding on stdout;
exits 1 when any pass finds something, 0 otherwise. ``--pass NAME``
(repeatable) runs only the named passes.
"""

from __future__ import annotations

import argparse
import sys

from tpu_bfs_torch.analysis import PASSES, run_pass
from tpu_bfs_torch.analysis.locks import repo_root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_bfs_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--pass", dest="passes", action="append", choices=PASSES,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--root", default=repo_root(), help="the checkout to check")
    args = ap.parse_args(argv)
    total = 0
    for name in args.passes or PASSES:
        findings, info = run_pass(name, args.root)
        counts = {k: (len(v) if isinstance(v, (list, dict, set, tuple)) else v)
                  for k, v in info.items()}
        print(f"# {name}: {len(findings)} finding(s); {counts}", file=sys.stderr, flush=True)
        for f in findings:
            print(f.render())
        total += len(findings)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
