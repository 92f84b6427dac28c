"""``python -m kmdiff_tpu_torch``: the port's CLI (cli.main) on the card.

With KMDIFF_RUN_REPORT=PATH the process also writes one JSON object to PATH
when the command succeeds: its start (the clock's "start", seconds since
the epoch), its wall seconds ("seconds") and the kernel launches it made
("launches", kernels.launch_counts()). Launch counts are per process and
summed over its threads (a ``--devices N`` mesh launches from a thread a
shard), so this is how a caller reads what each rank of a
``--distributed`` run launched.
"""

import json
import os
import sys
import time

from kmdiff_tpu_torch.cli import main

start, t0 = time.time(), time.perf_counter()
rc = main()
report = os.environ.get("KMDIFF_RUN_REPORT")
if report:
    from kmdiff_tpu_torch import kernels

    with open(report, "w") as f:
        json.dump({"start": start, "seconds": time.perf_counter() - t0,
                   "launches": kernels.launch_counts()}, f)
sys.exit(rc)
