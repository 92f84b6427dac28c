import sys

from kmdiff_tpu_torch.cli import main

sys.exit(main())
