"""``python3 -B -m kbench``: run one cell once (kbench.run.main)."""

import sys

from kbench.run import main

sys.exit(main())
