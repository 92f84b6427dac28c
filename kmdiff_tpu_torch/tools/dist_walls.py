"""Walls of the multi-process runtime (--distributed) on one CUDA card:
`count`, the loose `diff` and popstrat `diff --save-sk` on the bench
cohort, each as one process (`python -m kmdiff_tpu_torch ...`) and as the
ranks of one --distributed group sharing the card, in turns.

Run from the root of a checkout:

    python3 -m kmdiff_tpu_torch.tools.dist_walls [--pairs N] [--ranks W]

It simulates chip_smoke.py's bench cohort once (10 + 10 samples of a 2^23
bp genome, 150 bp reads, coverage 1, error rate 0.001, seed 7), then for
each of N pairs (default 5) runs each command once as one process and once
as W ranks (default 2), the order alternating from pair to pair, into fresh
directories, and prints the card, every process's wall (spawn to exit),
its seconds inside the command (KMDIFF_RUN_REPORT) and its log breakdown
(log_breakdown), then for each command the medians and the pairs the ranks
won; the ranks' time of a pair is their slowest rank's. `diff` reads the
one process's run directory of its pair. spawn and log_breakdown also serve
chip_smoke.py's phase 9.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: seconds a process may run, and a collective may wait for another rank
LIMIT = 300
GENOME = 1 << 23
N_CONTROLS = N_CASES = 10
LOOSE = ["-1", str(N_CONTROLS), "-2", str(N_CASES), "--threads", "4", "-s",
         "0.001", "--cutoff", "1", "-c", "disabled"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: `python -m kmdiff_tpu_torch` with a virtual mesh (parallel.runtime's
#: library switch, which no flag sets): its shards repeat the process's card
_VIRTUAL = ("import runpy; from kmdiff_tpu_torch.parallel import runtime; "
            "runtime.set_virtual(True); "
            "runpy.run_module('kmdiff_tpu_torch', run_name='__main__', "
            "alter_sys=True)")


def spawn(args: list[str], world: int, stem: str, limit: int = LIMIT,
          virtual: bool = False, cards: str | None = None) -> list[dict]:
    """`python -m kmdiff_tpu_torch *args` in `world` processes: one process,
    or the ranks of one gloo group (--distributed 127.0.0.1:<free port>);
    logs and reports go to STEM_<rank>.log and .json. The processes see the
    cards `cards` (CUDA_VISIBLE_DEVICES; by default the caller's first
    card), and with `virtual` their meshes (--devices N in args) repeat
    their card. Returns each process's report (KMDIFF_RUN_REPORT: the
    command's start, seconds and launches, in all and by card) with its
    wall ("wall", spawn to exit) and its log. Every process is killed once
    one fails or `limit` seconds pass; a failure raises with the log's
    tail."""
    port = _free_port()
    if cards is None:
        cards = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    procs = []
    for r in range(world):
        log = open(f"{stem}_{r}.log", "w")
        env = dict(os.environ, KMDIFF_RUN_REPORT=f"{stem}_{r}.json",
                   CUDA_VISIBLE_DEVICES=cards, KMDIFF_DIST_TIMEOUT=str(limit),
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        flags = [] if world == 1 else [
            "--distributed", f"127.0.0.1:{port}", "--num-processes", str(world),
            "--process-id", str(r)]
        entry = ["-c", _VIRTUAL] if virtual else ["-m", "kmdiff_tpu_torch"]
        cmd = [sys.executable, *entry, *args, *flags]
        procs.append({"proc": subprocess.Popen(cmd, env=env, stdout=log,
                                               stderr=subprocess.STDOUT, cwd=REPO),
                      "file": log, "t0": time.perf_counter()})
    deadline = time.perf_counter() + limit
    try:
        while any("wall" not in p for p in procs):
            for p in procs:
                if "wall" not in p and p["proc"].poll() is not None:
                    p["wall"] = time.perf_counter() - p["t0"]
            if time.perf_counter() > deadline or any(
                    p["proc"].returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.02)
    finally:
        for p in procs:
            if p["proc"].poll() is None:
                p["proc"].kill()
            p["proc"].wait()
            p["file"].close()
    out = []
    for r, p in enumerate(procs):
        with open(f"{stem}_{r}.log") as f:
            log = f.read()
        if p["proc"].returncode != 0 or not os.path.exists(f"{stem}_{r}.json"):
            raise AssertionError(f"{' '.join(args[:1])}: process {r} of {world} "
                                 f"exited {p['proc'].returncode}:\n{log[-4000:]}")
        with open(f"{stem}_{r}.json") as f:
            out.append({**json.load(f), "wall": p["wall"], "log": log})
    return out


def log_breakdown(rep: dict) -> dict:
    """Where a process's command seconds went, from its log: the command's
    start to its first sample counted ("first", which holds the CUDA
    context and the libraries' loads), the samples' summed count+fetch and
    hist+spill thread seconds (0.1 s resolution), the merge's and the
    aggregation's seconds (diff's Timer)."""
    out = {"samples": 0, "count_fetch": 0.0, "hist_spill": 0.0}
    for line in rep["log"].splitlines():
        m = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d+)\]", line)
        sample = re.search(r"count\+fetch ([\d.]+)s, hist\+spill ([\d.]+)s", line)
        if m and sample:
            if not out["samples"]:
                at = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S.%f")
                out["first"] = round(at.timestamp() - rep["start"], 3)
            out["samples"] += 1
            out["count_fetch"] += float(sample.group(1))
            out["hist_spill"] += float(sample.group(2))
        for key, what in (("merge", "Partitions processed"),
                          ("aggregate", "Partitions aggregated")):
            timed = re.search(what + r" \((?:(\d+)m)?([\d.]+)s\)", line)
            if timed:
                out[key] = 60 * int(timed.group(1) or 0) + float(timed.group(2))
    out["count_fetch"] = round(out["count_fetch"], 1)
    out["hist_spill"] = round(out["hist_spill"], 1)
    return {k: v for k, v in out.items() if v or k == "samples"}


def _commands(fof: str, work: str, pair: int, world: int) -> dict:
    run_dir = os.path.join(work, f"run_{pair}_{world}")
    out = os.path.join(work, f"out_{pair}_{world}")
    # diff reads the one process's run directory of the pair
    counted = os.path.join(work, f"run_{pair}_1")
    return {
        "count": ["count", "--file", fof, "--kmer-size", "31", "--hard-min", "1",
                  "--nb-partitions", "4", "--threads", "4", "--run-dir", run_dir],
        "diff": ["diff", "--km-run-dir", counted, *LOOSE, "--output-dir",
                 f"{out}_diff"],
        "popstrat": ["diff", "--km-run-dir", counted, *LOOSE, "--pop-correction",
                     "--save-sk", "--output-dir", f"{out}_popstrat"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--ranks", type=int, default=2)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dist_walls: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # built here, so that no timed process pays the builds
    sys.path.insert(0, REPO)
    from kmdiff_tpu_torch import kernels, native

    kernels.lib()
    native.available()
    work = os.path.join(REPO, "build", "dist_walls")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sim = os.path.join(work, "sim")
    subprocess.run([sys.executable, "-m", "kmdiff_tpu_torch", "popsim", "-o", sim,
                    "--genome-len", str(GENOME), "-1", str(N_CONTROLS), "-2",
                    str(N_CASES), "--read-size", "150", "--coverage", "1",
                    "--error-rate", "0.001", "--random-seed", "7"],
                   check=True, cwd=REPO, capture_output=True, timeout=LIMIT)
    fof = os.path.join(sim, "fof.txt")
    times = {name: {1: [], opts.ranks: []} for name in ("count", "diff", "popstrat")}
    for pair in range(opts.pairs):
        order = (1, opts.ranks) if pair % 2 == 0 else (opts.ranks, 1)
        for name in times:
            for world in order:
                args = _commands(fof, work, pair, world)[name]
                reps = spawn(args, world, os.path.join(work, f"{name}_{pair}_{world}"))
                times[name][world].append(max(r["seconds"] for r in reps))
                print(json.dumps({
                    "pair": pair, "command": name, "processes": world,
                    "walls": [round(r["wall"], 3) for r in reps],
                    "seconds": [round(r["seconds"], 3) for r in reps],
                    "breakdown": [log_breakdown(r) for r in reps]}), flush=True)
        for world in (1, opts.ranks):
            shutil.rmtree(os.path.join(work, f"run_{pair}_{world}"), ignore_errors=True)
    for name, sides in times.items():
        one, ranks = sides[1], sides[opts.ranks]
        wins = sum(r < o for o, r in zip(one, ranks))
        print(f"[{name}] command seconds, median of {opts.pairs}: one process "
              f"{statistics.median(one):.3f} (range {min(one):.3f}-{max(one):.3f}), "
              f"{opts.ranks} ranks (the slowest) {statistics.median(ranks):.3f} "
              f"(range {min(ranks):.3f}-{max(ranks):.3f}); the ranks faster in "
              f"{wins} of {opts.pairs} pairs ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
