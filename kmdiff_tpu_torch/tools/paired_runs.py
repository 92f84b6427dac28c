"""The --root / --paired command line that the tools/*_times.py scripts
share.

A times script defines measure(root) -> dict, a JSON-able dict with "root"
and, per call, a dict of its numbers, and ends with

    paired_runs.main(__doc__, measure, __file__)

Run it on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/<script>.py --root DIR
    python3 kmdiff_tpu_torch/tools/<script>.py --paired OTHER_DIR

The first form prints measure(DIR) as one JSON line (measure imports
kmdiff_tpu_torch from DIR, whose kernels build under DIR/build/). The
second runs the first form four times, each in a process of its own, in
turns: OTHER_DIR, this checkout, this checkout, OTHER_DIR (OTHER_DIR a `git
archive` of another commit with the same API, unpacked under a directory
that .gitignore lists). It prints the card's name and power limit, the four
lines and a table of every number of every call.

A script is run by its path, so this module is imported from the script's
own directory; it imports nothing of kmdiff_tpu_torch.
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


def load(name: str, path: str):
    """A module of this checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke():
    """This checkout's chip_smoke.py (its helpers import only torch)."""
    return load("_chip_smoke", os.path.join(REPO, "chip_smoke.py"))


def paired(script: str, other: str, timeout: int = 900) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in (other, REPO, REPO, other):
        proc = subprocess.run([sys.executable, os.path.abspath(script), "--root", root],
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{os.path.basename(script)} failed for {root}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print("call field | " + " | ".join(r["root"] for r in runs))
    for key, fields in runs[0].items():
        if not isinstance(fields, dict):
            continue
        for field, value in fields.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                print(f"{key} {field} | " + " | ".join(f"{r[key][field]:.4f}" for r in runs))


def main(doc: str, measure, script: str) -> None:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", help="checkout to import kmdiff_tpu_torch from")
    group.add_argument("--paired", help="other checkout, timed in turns with this one")
    args = ap.parse_args()
    if args.paired:
        paired(script, args.paired)
    else:
        print(json.dumps(measure(args.root)))
