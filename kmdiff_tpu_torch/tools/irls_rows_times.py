"""K-IRLS's and K-ROWS's device times of one or two checkouts of
kmdiff_tpu_torch, at chip_smoke.py phase 2's shapes.

Run on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/irls_rows_times.py --root DIR
    python3 kmdiff_tpu_torch/tools/irls_rows_times.py --paired OTHER_DIR

The two forms are tools/paired_runs.py's: one checkout's JSON line, or
four in turns with another checkout's and a table.

Inputs and timers are this checkout's: tools/irls_seeds.py's irls_inputs
and chip_smoke.py's rows_inputs, median_ms, events_ms and device_work,
drawn from seeded streams. Calls:
- irls_n20_b16384, irls_n20_b1024, irls_n200_b16384, irls_n200_b1024:
  glm.irls on popstrat alt fits at n = 20, F = 5 and n = 200, F = 12, 2^14
  items and their first 1,024 (popstrat's launch size).
- rows_survivors, rows_sampled: merge_dev.run_rows on 2^23 sorted rows of
  20 streams, ~13,700 survivor runs (count rows) and ~12,000 sampled runs
  (presence rows). Checked against the plain twin.
Each is reported as the median whole call (CUDA events around one call)
and its device time: CUDA events around 20 calls queued back to back
behind a sleep kernel, over 20 (device_ms); K-ROWS also torch.profiler's
device time and device operations a call (profiler_ms, device_ops).
"""

from __future__ import annotations

import os
import sys

import paired_runs

HERE = os.path.dirname(os.path.abspath(__file__))


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import kmdiff_tpu_torch
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import glm, merge_dev

    if not kmdiff_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"kmdiff_tpu_torch came from {kmdiff_tpu_torch.__file__}")
    smoke = paired_runs.smoke()
    seeds = paired_runs.load("_irls_seeds", os.path.join(HERE, "irls_seeds.py"))
    kernels.lib()
    dev = torch.device("cuda", 0)
    out = {"root": root}

    for n, F in ((20, 5), (200, 12)):
        X, last, y = seeds.irls_inputs(np.random.default_rng(n), n, F, 1 << 14, dev)
        for items in (1 << 14, 1024):
            args = (X, last[:items].contiguous(), y)

            def call(args=args):
                return glm.irls(*args)

            out[f"irls_n{n}_b{items}"] = {"ms": smoke.median_ms(call, reps=7, warmup=1),
                                          "device_ms": smoke.events_ms(call)}

    calls, _rows_in, _n, _u = smoke.rows_inputs(dev, np.random.default_rng(7))
    for label, args in calls.items():
        def call(args=args):
            return merge_dev.run_rows(*args)

        if not torch.equal(call(), merge_dev.run_rows_plain(*args)):
            raise AssertionError(f"run_rows {label} differs from the plain twin")
        prof_ms, n_ops = smoke.device_work(call)
        out[f"rows_{label}"] = {"ms": smoke.median_ms(call), "device_ms": smoke.events_ms(call),
                                "profiler_ms": prof_ms, "device_ops": n_ops}
    return out


if __name__ == "__main__":
    paired_runs.main(__doc__, measure, __file__)
