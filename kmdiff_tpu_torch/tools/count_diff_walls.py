"""`count` and `diff` walls, and the k = 63 `run`'s, of one or two
checkouts of kmdiff_tpu_torch on the bench cohort, on a CUDA card, one
process a checkout.

Run from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/count_diff_walls.py --paired OTHER_DIR
    python3 kmdiff_tpu_torch/tools/count_diff_walls.py --root DIR --sim SIM

The second form imports kmdiff_tpu_torch from DIR (its kernels build under
DIR/build/), loads its kernels and native library, then times `count`
(k = 31, 4 partitions, hard-min 1, 4 threads), `diff` (-1 10 -2 10, the
defaults, 4 threads) and `run` at k = RUN_K with the same flags
(chip_smoke.py phase 7's `run` (a)) through its CLI on the cohort
simulated under SIM, REPS times, each into fresh directories, and prints
one JSON line. The
first simulates the cohort once with this checkout's popsim (the bench
cohort of chip_smoke.py: 10 + 10 samples of a 2^23 bp genome, 150 bp reads,
coverage 1, error rate 0.001, seed 7), then runs the second form in turns,
OTHER_DIR, this checkout, this checkout, OTHER_DIR, TURNS times, and prints
the card, every line and each side's walls over the reps after each
process's first (which also pays first-use costs). OTHER_DIR is
e.g. a `git archive` of another commit unpacked under a directory that
.gitignore lists.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
GENOME = 1 << 23
N_CONTROLS = N_CASES = 10
#: count + diff runs a process, and rounds of other, this, this, other
REPS = 3
TURNS = 2
#: the k of the timed `run` (two words, the second right-aligned)
RUN_K = 63
STAGES = ("count", "diff", f"run_k{RUN_K}")


def measure(root: str, sim: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from kmdiff_tpu_torch import kernels, native
    from kmdiff_tpu_torch.cli import main

    if not os.path.abspath(kernels.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"kmdiff_tpu_torch came from {kernels.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    kernels.lib()
    native.available()
    work = os.path.join(os.path.abspath(root), "build", "count_diff_walls")
    shutil.rmtree(work, ignore_errors=True)
    out = {"root": root, **{stage: [] for stage in STAGES}}
    for r in range(REPS):
        run = os.path.join(work, f"run{r}")
        t0 = time.perf_counter()
        main(["count", "--file", os.path.join(sim, "fof.txt"), "--kmer-size", "31",
              "--hard-min", "1", "--nb-partitions", "4", "--threads", "4",
              "--run-dir", run], device=dev)
        out["count"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        main(["diff", "--km-run-dir", run, "-1", "10", "-2", "10", "--threads", "4",
              "--output-dir", os.path.join(work, f"out{r}")], device=dev)
        out["diff"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        main(["run", "--file", os.path.join(sim, "fof.txt"), "--kmer-size", str(RUN_K),
              "--hard-min", "1", "--nb-partitions", "4", "--threads", "4", "-1", "10",
              "-2", "10", "--run-dir", os.path.join(work, f"fused{r}"),
              "--output-dir", os.path.join(work, f"fused_out{r}")], device=dev)
        out[f"run_k{RUN_K}"].append(time.perf_counter() - t0)
    shutil.rmtree(work, ignore_errors=True)
    return out


def paired(other: str) -> None:
    sys.path.insert(0, REPO)
    from kmdiff_tpu_torch.cli import main

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    sim = os.path.join(REPO, "build", "count_diff_walls_sim")
    shutil.rmtree(sim, ignore_errors=True)
    main(["popsim", "-o", sim, "--genome-len", str(GENOME), "-1", str(N_CONTROLS),
          "-2", str(N_CASES), "--read-size", "150", "--coverage", "1",
          "--error-rate", "0.001", "--random-seed", "7"], device="cpu")
    walls = {}
    for _turn in range(TURNS):
        for root in (other, REPO, REPO, other):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root, "--sim", sim],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"count_diff_walls failed for {root}")
            line = proc.stdout.strip().splitlines()[-1]
            print(line)
            run = json.loads(line)
            side = walls.setdefault("this" if root == REPO else "other",
                                    {stage: [] for stage in STAGES})
            for stage in STAGES:
                side[stage] += run[stage][1:]
    shutil.rmtree(sim, ignore_errors=True)
    for side, w in walls.items():
        for stage, xs in w.items():
            print(f"{side} {stage}: min {min(xs):.3f} s, median "
                  f"{statistics.median(xs):.3f} s, max {max(xs):.3f} s over {len(xs)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", help="checkout to import kmdiff_tpu_torch from")
    group.add_argument("--paired", help="other checkout, timed in turns with this one")
    ap.add_argument("--sim", help="the simulated cohort (--root)")
    args = ap.parse_args()
    if args.paired:
        paired(args.paired)
    else:
        if not args.sim:
            ap.error("--root needs --sim")
        print(json.dumps(measure(args.root, args.sim)))


if __name__ == "__main__":
    main()
