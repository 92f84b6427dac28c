"""K-IRLS's and K-ROWS's device times of one or two checkouts of
kmdiff_tpu_torch, at chip_smoke.py phase 2's shapes.

Run on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/irls_rows_times.py --root DIR
    python3 kmdiff_tpu_torch/tools/irls_rows_times.py --paired OTHER_DIR

The first form imports kmdiff_tpu_torch from DIR (its kernels build under
DIR/build/) and prints one JSON line. The second runs the first form four
times, in turns: OTHER_DIR, this checkout, this checkout, OTHER_DIR (a
`git archive` of another commit with the same API, unpacked under a
directory that .gitignore lists), and prints the card, the four lines and
a table.

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

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def _load(name: str, path: str):
    """A module of this checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import kmdiff_tpu_torch
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import glm, merge_dev

    if not kmdiff_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"kmdiff_tpu_torch came from {kmdiff_tpu_torch.__file__}")
    smoke = _load("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    seeds = _load("_irls_seeds", os.path.join(HERE, "irls_seeds.py"))
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


def paired(other: str) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    runs = []
    for root in (other, REPO, REPO, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"irls_rows_times failed for {root}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    print("call field | " + " | ".join(r["root"] for r in runs))
    for key in (k for k, v in runs[0].items() if isinstance(v, dict)):
        for field in ("ms", "device_ms", "profiler_ms", "device_ops"):
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
