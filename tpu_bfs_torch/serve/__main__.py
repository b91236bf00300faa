"""``python -m tpu_bfs_torch.serve`` — the JSONL query server (frontend.py)."""

import sys

from tpu_bfs_torch.serve.frontend import main

if __name__ == "__main__":
    sys.exit(main())
