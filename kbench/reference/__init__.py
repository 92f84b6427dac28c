"""The plain reference of a cohort's `run` or `diff`: from the reads the
benchmark wrote to each sample's abundance histogram, the number of k-mers
tested and the significant k-mers with their p-values, signs and group
means; with ``pop_correction`` in the analysis, popstrat's p-values
(``popstrat``) under kmdiff's correction.

Plain PyTorch (on the card, a sample at a time, then the merge of the
samples' distinct k-mers) and NumPy. It imports neither JAX nor the JAX
package nor anything of kmdiff_tpu_torch, and reads nothing that the
program made: the reads come from the benchmark's own FASTA files.
"""

from __future__ import annotations

import dataclasses

import torch

from kbench import cohort as cohort_mod
from kbench.reference import count, popstrat, score


@dataclasses.dataclass
class Counts:
    """A cohort counted: each sample's histogram and mass above hard-min,
    the union's keys and group sums on the device, and where kept each
    sample's sorted keys and counts (popstrat reads them)."""

    k: int
    hists: list[dict]
    keys: torch.Tensor
    s_c: torch.Tensor
    s_k: torch.Tensor
    t_c: int
    t_k: int
    nb_controls: int = 0
    masses: list[int] = dataclasses.field(default_factory=list)
    samples: list | None = None


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

    @property
    def hits(self) -> int:
        return len(self.records)


@dataclasses.dataclass
class PopExpected:
    """A popstrat job's expected output: every k-mer that passes the merge
    (``records``, its popstrat p-value), and the k-mers that the correction
    accepts with every p-value at the bottom (``loose``) and at the top
    (``strict``) of its band (popstrat.BAND, SEP_BAND); ``separated``: those
    whose fit is quasi-separated."""

    hists: list[dict]
    n_tested: int
    records: dict[str, Record]
    strict: set[str]
    loose: set[str]
    separated: set[str]
    eig_gap: float
    n_geno: int

    @property
    def hits(self) -> int:
        return len(self.strict)


def count_cohort(cohort: cohort_mod.Cohort, k: int, hard_min: int, device,
                 keep_samples: bool = False) -> Counts:
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
    return Counts(k, hists, keys, s_c, s_k, sum(masses[:cohort.nb_controls]),
                  sum(masses[cohort.nb_controls:]), cohort.nb_controls, masses,
                  samples if keep_samples else None)


def expected(counts: Counts, config: dict, dtype=torch.float64,
             printed: bool = False) -> Expected | PopExpected:
    """The significant k-mers of a counted cohort under `config`'s
    analysis, scored in `dtype`. printed: each p-value as kmdiff prints it
    (6 significant digits), as the control puts it in the program's
    place. With ``pop_correction``: pop_expected."""
    if config.get("pop_correction"):
        return pop_expected(counts, config)
    if config["correction"] != "bonferroni":
        raise ValueError(f"the reference corrects by bonferroni, not {config['correction']}")
    n = counts.keys.shape[1]
    p, sign, mc, mk = score.score(counts.s_c, counts.s_k, counts.t_c, counts.t_k, dtype)
    hit = score.significant(p, config["significance"], config["cutoff"], n)
    return Expected(counts.hists, n, records(counts.keys[:, hit], counts.k, p[hit],
                                             sign[hit], mc[hit], mk[hit], printed))


def records(keys: torch.Tensor, k: int, p, sign, mean_control, mean_case,
            printed: bool = False) -> dict[str, Record]:
    """[nw, H] k-mers with their p-values, signs and means -> {k-mer:
    Record}; printed: each p-value as kmdiff prints it."""
    kmers = count.to_strings(keys, k)
    p = p.double().cpu().numpy()
    sign = sign.cpu().numpy()
    mc = mean_control.double().cpu().numpy()
    mk = mean_case.double().cpu().numpy()
    out = {}
    for i, kmer in enumerate(kmers):
        pv = float(f"{p[i]:g}") if printed else float(p[i])
        out[kmer] = Record("control" if sign[i] == 0 else "case", pv, int(mc[i]),
                           float(mk[i]))
    return out


def pop_expected(counts: Counts, config: dict) -> PopExpected:
    """Popstrat's output of a counted cohort whose samples were kept
    (count_cohort(keep_samples=True)), f64: the merge's survivors, their
    popstrat p-values and the correction's two banded sets."""
    hit, _p, sign, mc, mk = popstrat.poisson_survivors(counts, config)
    fit = popstrat.fit(counts, config, hit)
    n = counts.keys.shape[1]

    def accepted(p: torch.Tensor):
        return popstrat.accept(p, config["correction"], config["significance"],
                               n).cpu().numpy()

    loose, strict = accepted(fit.p * (1 - fit.band)), accepted(fit.p * (1 + fit.band))
    recs = records(counts.keys[:, hit], counts.k, fit.p, sign, mc, mk)
    sep = fit.separated.cpu().numpy()
    return PopExpected(counts.hists, n, recs,
                       {km for km, s in zip(recs, strict) if s},
                       {km for km, s in zip(recs, loose) if s},
                       {km for km, s in zip(recs, sep) if s},
                       fit.eig_gap(config["n_pc"]), fit.n_geno)


def free(counts: Counts) -> None:
    counts.keys = counts.s_c = counts.s_k = counts.samples = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

