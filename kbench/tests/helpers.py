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


def pop_config(genome_len: int = 200000) -> dict:
    """A small cohort of ecoli-k31.pop's configuration (hard-min 2,
    Benjamini-Hochberg): 20 + 20 samples (the logistic test needs them to
    reach the walk's bound), a genome long enough that the planted variants
    are a small share of the genotype sample (else PC 1 is the phenotype and
    the null fit separates), short strong variants; ~20 s a run on the
    CPU."""
    with open(os.path.join(run.KBENCH, "configs", "ecoli-k31-pop.json")) as f:
        cfg = json.load(f)
    cfg.update(nb_controls=20, nb_cases=20, genome_len=genome_len, coverage=4,
               read_size=100, mean_sv_len=100, sd_sv_len=10, sv_per_indiv=0.9,
               prob_case=0.05, prob_control=0.05)
    return cfg


def pop_run(seed: int = 7, seconds: float = 0.5, trace: bool = False) -> dict:
    """One CPU run of ecoli-k31.pop's harness on pop_config's cohort, its
    checks finished with no process left over."""
    res = run.run_cell(run.load_bench(pending=True), "ecoli-k31.pop", seed, seconds, trace,
                       torch.device("cpu"), config=pop_config())
    run.finish(res, [])
    return res


def tiny_run(seed: int = 7, k: int = 31, seconds: float = 0.5, trace: bool = False) -> dict:
    """One CPU run of ecoli-k31.run's harness on the tiny cohort, its
    checks finished with no process left over."""
    res = run.run_cell(run.load_bench(), "ecoli-k31.run", seed, seconds, trace,
                       torch.device("cpu"), config=tiny_config(k))
    run.finish(res, [])
    return res
