"""The plain reference of a cohort's `run`: from the reads the benchmark
wrote to each sample's abundance histogram, the number of k-mers tested and
the significant k-mers with their p-values, signs and group means.

Plain PyTorch (on the card, a sample at a time, then the merge of the
samples' distinct k-mers) and NumPy. It imports neither JAX nor the JAX
package nor anything of kmdiff_tpu_torch, and reads nothing that the
program made: the reads come from the benchmark's own FASTA files.
"""

from __future__ import annotations

import dataclasses

import torch

from kbench import cohort as cohort_mod
from kbench.reference import count, score


@dataclasses.dataclass
class Counts:
    """A cohort counted: each sample's histogram, and the union's keys and
    group sums on the device."""

    k: int
    hists: list[dict]
    keys: torch.Tensor
    s_c: torch.Tensor
    s_k: torch.Tensor
    t_c: int
    t_k: int


@dataclasses.dataclass
class Record:
    """One significant k-mer as kmdiff writes it: its file (control or
    case), p-value, truncated control mean and case mean."""

    file: str
    p: float
    mean_control: int
    mean_case: float


@dataclasses.dataclass
class Expected:
    hists: list[dict]
    n_tested: int
    records: dict[str, Record]


def count_cohort(cohort: cohort_mod.Cohort, k: int, hard_min: int, device) -> Counts:
    samples, hists = [], []
    for i in range(len(cohort.paths)):
        keys, counts = count.count(count.canonical_keys(cohort_mod.reads(cohort, i), k,
                                                        device))
        hists.append(count.histogram(counts))
        keep = counts >= hard_min
        samples.append((keys[:, keep], counts[keep]))
    masses = [h["total"] - sum(j * int(h["unique_per_bin"][j - 1])
                               for j in range(1, hard_min)) for h in hists]
    keys, s_c, s_k = count.group_sums(samples, cohort.nb_controls)
    del samples
    return Counts(k, hists, keys, s_c, s_k, sum(masses[:cohort.nb_controls]),
                  sum(masses[cohort.nb_controls:]))


def expected(counts: Counts, config: dict, dtype=torch.float64,
             printed: bool = False) -> Expected:
    """The significant k-mers of a counted cohort under `config`'s
    analysis, scored in `dtype`. printed: each p-value as kmdiff prints it
    (6 significant digits), as the control puts it in the program's
    place."""
    if config["correction"] != "bonferroni":
        raise ValueError(f"the reference corrects by bonferroni, not {config['correction']}")
    n = counts.keys.shape[1]
    p, sign, mc, mk = score.score(counts.s_c, counts.s_k, counts.t_c, counts.t_k, dtype)
    hit = score.significant(p, config["significance"], config["cutoff"], n)
    kmers = count.to_strings(counts.keys[:, hit], counts.k)
    p = p[hit].double().cpu().numpy()
    sign = sign[hit].cpu().numpy()
    mc = mc[hit].double().cpu().numpy()
    mk = mk[hit].double().cpu().numpy()
    records = {}
    for i, kmer in enumerate(kmers):
        pv = float(f"{p[i]:g}") if printed else float(p[i])
        records[kmer] = Record("control" if sign[i] == 0 else "case", pv,
                               int(mc[i]), float(mk[i]))
    return Expected(counts.hists, n, records)


def free(counts: Counts) -> None:
    counts.keys = counts.s_c = counts.s_k = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

