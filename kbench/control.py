"""The control of the comparison: the plain reference put in the program's
place, computed one precision below what kmdiff states (f32 for its f64
test), its p-values printed as kmdiff prints them. The comparison
(kbench.compare) has to find it not correct.

    python3 -B -m kbench.control --workload <cell> --seeds <n> [<n> ...]

makes each seed's cohort at the cell's own size, counts it once, and prints
one JSON line a seed: the control's numbers (compare.compare_records of the
f32 records against the f64 ones), and the reference's seconds. No program
runs; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from kbench import cohort, compare, reference, run


def control_numbers(counts: reference.Counts, config: dict) -> dict:
    want = reference.expected(counts, config)
    got = reference.expected(counts, config, dtype=torch.float32, printed=True)
    return compare.compare_records(got.records, want.records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -B -m kbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = run.load_json("configs", f"{cell['config']}.json")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        scratch = tempfile.mkdtemp(prefix="kbench-control-", dir=tempfile.gettempdir())
        try:
            co = cohort.make(config, seed, scratch)
            t0 = time.perf_counter()
            counts = reference.count_cohort(co, config["kmer_size"], config["hard_min"],
                                            device)
            numbers = control_numbers(counts, config)
            reference.free(counts)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reference_s": time.perf_counter() - t0, **numbers,
                              "fails": compare.failures({**dict.fromkeys(compare.LIMITS, 0),
                                                         **numbers})}), flush=True)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
