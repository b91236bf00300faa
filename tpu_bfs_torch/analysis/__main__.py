"""``python -m tpu_bfs_torch.analysis``: the analysis CLI (:mod:`.cli`)."""

import sys

from tpu_bfs_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
