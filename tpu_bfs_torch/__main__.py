import sys

from tpu_bfs_torch.cli import main

try:
    sys.exit(main())
except NotImplementedError as exc:  # a run of a part not ported yet
    sys.exit(f"tpu_bfs_torch: {exc}")
