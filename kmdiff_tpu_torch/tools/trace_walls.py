"""What --profile shows and costs, and what warmup pays, on one CUDA card.

Run from the root of a checkout:

    python3 -m kmdiff_tpu_torch.tools.trace_walls [--pairs N]

It simulates chip_smoke.py's bench cohort once (10 + 10 samples of a 2^23
bp genome, 150 bp reads, coverage 1, error rate 0.001, seed 7) and counts
it (k = 31, 4 partitions), then:

1. For N pairs (default 2), in turns, each of `run` (a) (the defaults, the
   fused path) and popstrat `diff --save-sk` on the loose cut (-s 0.001
   --cutoff 1 -c disabled) as one process (`python -m kmdiff_tpu_torch
   ...`, tools/dist_walls.py's spawn), once plain and once under --profile
   DIR: each process's seconds in the command (KMDIFF_RUN_REPORT), and from
   the trace the card's busy time, the union of its kernels', copies' and
   memsets' intervals, over the trace's span (the command under the
   profiler) and over the plain process's seconds, and the share of the
   kernel time that the port's hand-written kernels take.
2. `warmup -1 10 -2 10 --pop` twice, as a process of a fresh copy of the
   package under build/tools/warmup_fresh/ (its kernel and native
   libraries build under the copy's own build/): on a fresh build
   directory, then on the built one; each process's wall and the build and
   group seconds it logs.

Prints the card's name and power limit first, then one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

from kmdiff_tpu_torch.tools import paired_runs
from kmdiff_tpu_torch.tools.dist_walls import (
    GENOME,
    LOOSE,
    N_CASES,
    N_CONTROLS,
    REPO,
    spawn,
)

#: a trace's device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy(path: str, symbols: list[str]) -> dict:
    """The card's busy milliseconds in a Chrome trace (the union of its
    device intervals), the trace's span, and the share of the kernel time
    that kernels named by one of `symbols` (the port's) take."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS)
    total, end = 0.0, None
    for a, b in dev:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = sum(e["dur"] for e in kernels if any(s in e["name"] for s in symbols))
    k_all = sum(e["dur"] for e in kernels)
    return {"busy_ms": round(total / 1e3, 3), "span_s": round(span / 1e6, 3),
            "busy_share": round(total / span, 5) if span else 0.0,
            "kernel_ms": round(k_all / 1e3, 3),
            "port_kernel_share": round(ours / k_all, 4) if k_all else 0.0}


def _warmup_log(log: str) -> dict:
    out = {}
    m = re.search(r"kernel library ([\d.]+) s, native library ([\d.]+) s", log)
    if m:
        out["build_kernels_s"], out["build_native_s"] = map(float, m.groups())
    for name, secs in re.findall(r"\]   ([a-z ]+): ([\d.]+) s", log):
        out[name] = float(secs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_walls: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, REPO)
    from kmdiff_tpu_torch import kernels, native

    kernels.lib()
    native.available()
    # the hand-written kernels' names, as chip_smoke.py's check_trace reads them
    symbols = [s for syms in paired_runs.smoke().kernel_symbols().values()
               for s in syms]

    work = os.path.join(REPO, "build", "trace_walls")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sim = os.path.join(work, "sim")
    subprocess.run([sys.executable, "-m", "kmdiff_tpu_torch", "popsim", "-o", sim,
                    "--genome-len", str(GENOME), "-1", str(N_CONTROLS), "-2",
                    str(N_CASES), "--read-size", "150", "--coverage", "1",
                    "--error-rate", "0.001", "--random-seed", "7"],
                   check=True, cwd=REPO, capture_output=True, timeout=600)
    fof = os.path.join(sim, "fof.txt")
    run_dir = os.path.join(work, "run")
    spawn(["count", "--file", fof, "--kmer-size", "31", "--hard-min", "1",
           "--nb-partitions", "4", "--threads", "4", "--run-dir", run_dir,
           "--devices", "1"], 1, os.path.join(work, "count"))

    def command(name: str, tag: str) -> list[str]:
        out = os.path.join(work, f"{name}_{tag}")
        if name == "run":
            return ["run", "--file", fof, "--kmer-size", "31", "--hard-min", "1",
                    "--nb-partitions", "4", "--threads", "4", "-1",
                    str(N_CONTROLS), "-2", str(N_CASES), "--run-dir", out + "_rd",
                    "--output-dir", out, "--devices", "1"]
        return ["diff", "--km-run-dir", run_dir, *LOOSE, "--pop-correction",
                "--save-sk", "--output-dir", out, "--devices", "1"]

    for pair in range(opts.pairs):
        for name in ("run", "popstrat"):
            order = ("plain", "profiled") if pair % 2 == 0 else ("profiled", "plain")
            secs = {}
            for mode in order:
                tag = f"{pair}_{mode}"
                argv = command(name, tag)
                prof = os.path.join(work, f"prof_{name}_{tag}")
                if mode == "profiled":
                    argv += ["--profile", prof]
                (rep,) = spawn(argv, 1, os.path.join(work, f"{name}_{tag}"))
                secs[mode] = rep["seconds"]
                if mode == "profiled":
                    (trace,) = os.listdir(prof)
                    trace_info = busy(os.path.join(prof, trace), symbols)
                    shutil.rmtree(prof)
            trace_info["busy_share_of_plain"] = round(
                trace_info["busy_ms"] / 1e3 / secs["plain"], 5)
            print(json.dumps({"pair": pair, "command": name,
                              "plain_s": round(secs["plain"], 3),
                              "profiled_s": round(secs["profiled"], 3),
                              "ratio": round(secs["profiled"] / secs["plain"], 3),
                              **trace_info}), flush=True)

    fresh = os.path.join(REPO, "build", "tools", "warmup_fresh")
    shutil.rmtree(fresh, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "kmdiff_tpu_torch"),
                    os.path.join(fresh, "kmdiff_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for state in ("fresh build directory", "built"):
        env = dict(os.environ, PYTHONPATH=fresh)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "kmdiff_tpu_torch", "warmup",
                               "-1", str(N_CONTROLS), "-2", str(N_CASES), "--pop"],
                              cwd=fresh, env=env, capture_output=True, text=True,
                              timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"warmup on a {state} failed")
        print(json.dumps({"warmup": state, "wall_s": round(wall, 3),
                          **_warmup_log(proc.stderr + proc.stdout)}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
