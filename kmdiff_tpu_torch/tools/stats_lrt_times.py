"""K-HIST's statistics and K-LRT's forms of one or two checkouts of
kmdiff_tpu_torch, timed at chip_smoke.py phase 2's shapes.

Run on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/stats_lrt_times.py --root DIR
    python3 kmdiff_tpu_torch/tools/stats_lrt_times.py --paired OTHER_DIR

The first form imports kmdiff_tpu_torch from DIR (its kernels build under
DIR/build/) and prints one JSON line. The second runs the first form four
times, in turns: OTHER_DIR, this checkout, this checkout, OTHER_DIR (a
`git archive` of another commit with the same API, unpacked under a
directory that .gitignore lists), and prints the card, the four lines and
a table.

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

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (its helpers import
    only torch)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    smoke = _smoke()
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


def paired(other: str) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    runs = []
    for root in (other, REPO, REPO, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"stats_lrt_times failed for {root}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    print("time (ms) | " + " | ".join(r["root"] for r in runs))
    for key in (k for k, v in runs[0].items() if isinstance(v, dict)):
        for field in ("ms", "device_ms", "profiler_ms"):
            if field in runs[0][key]:
                print(f"{key} {field} | " + " | ".join(f"{r[key][field]:.4f}" for r in runs))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", help="checkout to import kmdiff_tpu_torch from")
    group.add_argument("--paired", help="other checkout, timed in turns with this one")
    args = ap.parse_args()
    if args.paired:
        paired(args.paired)
    else:
        print(json.dumps(measure(args.root)))


if __name__ == "__main__":
    main()
