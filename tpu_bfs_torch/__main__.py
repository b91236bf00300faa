import sys

from tpu_bfs_torch.cli import main

sys.exit(main())
