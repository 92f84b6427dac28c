"""The host time of one kernel launch (kernels.launch) of one or two
checkouts of kmdiff_tpu_torch, without a profiler and, where the checkout
has --profile (kmdiff_tpu_torch/profiling.py), under a trace.

Run on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/launch_times.py --root DIR
    python3 kmdiff_tpu_torch/tools/launch_times.py --paired OTHER_DIR

The two forms are tools/paired_runs.py's: one checkout's JSON line, or
four in turns with another checkout's and a table.

The launch is K-GENO's (kmd_geno_sample) on 4,096 one-word keys, its
arguments made once, called straight through kernels.launch: the wrapper's
own host work (the stream, the ctypes call, the launch count and, under a
trace, the kmd:geno_sample range) and the kernel's enqueue, which does not
wait for the card. Calls:
- no_trace: 21 batches of 2,000 launches, each batch's host seconds over
  2,000, in microseconds; median, lowest and highest batch (us, us_min,
  us_max);
- trace: the same inside profiling.trace (CPU and CUDA activities, every
  thread), with the trace's export outside the timed batches, then
  after_trace: no_trace again once the trace ended; both absent for a
  checkout without profiling.py.
The card synchronises before each batch and after the last.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time

import paired_runs

HERE = os.path.dirname(os.path.abspath(__file__))
BATCHES, LAUNCHES, KEYS = 21, 2000, 4096


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from kmdiff_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    kernels.lib()
    keys = torch.arange(KEYS, dtype=torch.int64, device=dev)
    mask = torch.empty(KEYS, dtype=torch.bool, device=dev)
    args = ("geno_sample", "kmd_geno_sample", keys.data_ptr(), KEYS,
            1 << 30, 7, mask.data_ptr())

    def batches() -> dict:
        per = []
        for _ in range(BATCHES):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(LAUNCHES):
                kernels.launch(*args)
            per.append((time.perf_counter() - t0) / LAUNCHES * 1e6)
        torch.cuda.synchronize(dev)
        return {"us": statistics.median(per), "us_min": min(per),
                "us_max": max(per)}

    with torch.cuda.device(dev):
        for _ in range(LAUNCHES):  # first launches: module load, caches
            kernels.launch(*args)
        out = {"root": root, "no_trace": batches()}
        try:
            from kmdiff_tpu_torch import profiling
        except ImportError:
            return out
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp, dev):
                out["trace"] = batches()
        out["after_trace"] = batches()
    return out


if __name__ == "__main__":
    paired_runs.main(__doc__, measure, __file__)
