"""K-HIST's statistics and K-LRT's forms of one or two checkouts of
kmdiff_tpu_torch, timed at chip_smoke.py phase 2's shapes.

Run on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/stats_lrt_times.py --root DIR
    python3 kmdiff_tpu_torch/tools/stats_lrt_times.py --paired OTHER_DIR

The two forms are tools/paired_runs.py's: one checkout's JSON line, or
four in turns with another checkout's and a table.

Inputs and timers are this checkout's chip_smoke.py's (lrt_inputs,
stats_inputs, median_ms, events_ms, device_work), drawn from one seeded
stream. Calls:
- stats_int32, stats_int64: codec.rle_stats on 2^23 counts as sort_rle and
  dedup_sum take them (int32 holding u32, a view 8 bytes past a 16-byte
  boundary; int64). Checked against numpy.
- lrt_merge_narrow (keep alone, the merge's form) and lrt_merge_full on the
  merge's [2^22, 2] sums (a view 8 bytes past a 16-byte boundary);
  lrt_matrix_narrow (keep and the sums, run_filter's form) and
  lrt_matrix_full on a [2^17, 20] matrix tile. keep checked against the
  plain twin.
Each is reported as the median whole call (CUDA events around one call, 15
after 3 warm-ups) and its device time: torch.profiler's every device
operation a call for the statistics (the calls wait for their result); for
K-LRT CUDA events around 20 calls queued back to back behind a sleep
kernel, over 20 (device_ms), and torch.profiler's (profiler_ms).
"""

from __future__ import annotations

import os
import sys

import paired_runs


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import kmdiff_tpu_torch
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec
    from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter, lrt_filter_plain

    if not kmdiff_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"kmdiff_tpu_torch came from {kmdiff_tpu_torch.__file__}")
    smoke = paired_runs.smoke()
    kernels.lib()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    params, merge, matrix = smoke.lrt_inputs(dev, rng)
    n_valid, counts, sums = smoke.stats_inputs(dev, rng)
    out = {"root": root}

    for label, c in (("stats_int32", counts), ("stats_int64", sums)):
        def call(c=c):
            return codec.rle_stats(n_valid, c, True)

        values = c.cpu().numpy().astype(np.int64) & (0xFFFFFFFF if c.dtype == torch.int32 else -1)
        st = call()
        if (st.n_valid != int(n_valid) or st.max_count != int(values.max())
                or not np.array_equal(st.hist, np.bincount(np.minimum(values, 256),
                                                           minlength=257))):
            raise AssertionError(f"{label}: statistics differ from numpy's")
        dev_ms, n_ops = smoke.device_work(call)
        out[label] = {"ms": smoke.median_ms(call), "device_ms": dev_ms, "device_ops": n_ops}

    for label, t, nbc, want_sums in (("lrt_merge", merge, 1, False),
                                     ("lrt_matrix", matrix, 10, True)):
        args = (nbc, params.ratio_c, params.ratio_k, params.lr_min)
        keep_p = lrt_filter_plain(t, *args)[0]
        forms = {"narrow": lambda t=t, args=args, s=want_sums: lrt_filter(
                     t, *args, want_lr=False, want_sums=s),
                 "full": lambda t=t, args=args: lrt_filter(t, *args)}
        for form, call in forms.items():
            if not torch.equal(call()[0], keep_p):
                raise AssertionError(f"{label} {form}: keep differs from the plain twin's")
            out[f"{label}_{form}"] = {"ms": smoke.median_ms(call),
                                      "device_ms": smoke.events_ms(call),
                                      "profiler_ms": smoke.device_work(call)[0]}
    return out


if __name__ == "__main__":
    paired_runs.main(__doc__, measure, __file__)
