"""A cohort small enough for the CPU: the port's plain twins count it in
about a second, and its planted variants give thousands of significant
k-mers."""

import json
import os

import torch

from kbench import run

ROOT = run.ROOT


def tiny_config(k: int = 31) -> dict:
    with open(os.path.join(run.KBENCH, "configs", "ecoli-k31.json")) as f:
        cfg = json.load(f)
    cfg.update(genome_len=30000, nb_controls=6, nb_cases=6, coverage=10,
               read_size=100, kmer_size=k)
    return cfg


def tiny_run(seed: int = 7, k: int = 31, seconds: float = 0.5, trace: bool = False) -> dict:
    """One CPU run of ecoli-k31.run's harness on the tiny cohort, its
    checks finished with no process left over."""
    res = run.run_cell(run.load_bench(), "ecoli-k31.run", seed, seconds, trace,
                       torch.device("cpu"), config=tiny_config(k))
    run.finish(res, [])
    return res
