"""The control of the comparison: the plain reference put in the program's
place, computed one precision below what kmdiff states (f32 for its f64
test), its p-values printed as kmdiff prints them. The comparison
(kbench.compare) has to find it not correct. A popstrat mix
(``pop_correction`` in its analysis) has two controls, each the merge's
survivors through the mix's correction, their p-values printed as kmdiff
prints them, put where the program's should be:

  uncorrected  popstrat left out: the survivors' Poisson p-values (f64);
  bf16         the popstrat reference one precision below the port's f32
               fits: every design column rounded to bfloat16, and each
               fit's log-likelihood evaluated in bfloat16 from its logits
               to its sum (the Newton steps between in f64, as torch solves
               no bfloat16 system: fits in bfloat16 throughout could only
               be further off).

    python3 -B -m kbench.control --workload <cell> --seeds <n> [<n> ...]

makes each seed's cohort at the cell's own size, counts it once, and prints
one JSON line a seed and control: the control's numbers (compare's numbers
of its records against the reference's), and the reference's seconds. No
program runs; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from kbench import cohort, compare, reference, run, traffic
from kbench.reference import popstrat


def control_numbers(counts: reference.Counts, config: dict) -> dict:
    """The f32 control's numbers (a Poisson mix)."""
    want = reference.expected(counts, config)
    got = reference.expected(counts, config, dtype=torch.float32, printed=True)
    return compare.compare_records(got.records, want.records)


def pop_control_numbers(counts: reference.Counts, config: dict) -> dict[str, dict]:
    """Each popstrat control's numbers, by its name (the module's
    docstring)."""
    want = reference.expected(counts, config)
    hit, p0, sign, mc, mk = popstrat.poisson_survivors(counts, config)
    p_bf16 = popstrat.fit(counts, config, hit, storage=torch.bfloat16).p
    out = {}
    for name, p in (("uncorrected", p0), ("bf16", p_bf16)):
        keep = popstrat.accept(p, config["correction"], config["significance"],
                               counts.keys.shape[1])
        got = reference.records(counts.keys[:, hit[keep]], counts.k, p[keep], sign[keep],
                                mc[keep], mk[keep], printed=True)
        out[name] = compare.compare_pop_records(got, want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -B -m kbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = next(w for w in run.load_bench(pending=True)["workloads"]
                if w["name"] == args.workload)
    config = traffic.overlay(run.load_json("configs", f"{cell['config']}.json"),
                             traffic.load(run.KBENCH, cell["traffic"]))
    limits = compare.POP_LIMITS if config.get("pop_correction") else compare.LIMITS
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        scratch = tempfile.mkdtemp(prefix="kbench-control-", dir=tempfile.gettempdir())
        try:
            co = cohort.make(config, seed, scratch)
            t0 = time.perf_counter()
            counts = reference.count_cohort(co, config["kmer_size"], config["hard_min"],
                                            device, keep_samples=bool(config.get("pop_correction")))
            controls = pop_control_numbers(counts, config) \
                if config.get("pop_correction") else {"f32": control_numbers(counts, config)}
            reference.free(counts)
            for kind, numbers in controls.items():
                print(json.dumps({"workload": args.workload, "seed": seed, "control": kind,
                                  "reference_s": time.perf_counter() - t0, **numbers,
                                  "fails": compare.failures({**dict.fromkeys(limits, 0),
                                                             **numbers}, limits)}),
                      flush=True)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
