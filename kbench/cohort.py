"""The cohort of a configuration, made from a seed: FASTA files and a fof.

A vectorised copy of the port's cohort model (kmdiff_tpu_torch/pipeline/
simulate.py, ``popsim``), which loops in Python once a read and writes once
a read. The model is the same:

- a random genome of ``genome_len`` bases;
- ``nb_sv_controls`` control-pool and ``nb_sv_cases`` case-pool variants,
  each an insertion of novel sequence (length ~ N(mean_sv_len, sd_sv_len),
  at least 50) at a random locus;
- each sample carries each variant of its own pool with probability
  ``sv_per_indiv`` and each of the other pool with ``prob_case`` (a case
  variant in a control) or ``prob_control`` (a control variant in a case);
- its reads are ``read_size`` bases from uniform starts on its own genome,
  with substitution errors at ``error_rate`` (a random base each).

Departures from popsim, none of which changes what is counted: every
sample has ``genome_len * coverage // read_size`` reads (popsim takes its
own genome's length, which varies by a few reads with the variants it
carries), so every seed gives the same amount of work; insertions are
placed at their loci in the base genome all at once; the error count is
drawn once (binomial) and its positions with replacement. Read names are
fixed width (``>r`` and six digits), so a file is ``n_reads`` records of
``read_size + 10`` bytes.

Every sample draws from its own stream of ``np.random.SeedSequence(seed)``,
so the files are the same whatever threads write them.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import numpy as np

_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
#: ">r" and six digits: the bytes of a read's name line before its newline
NAME_BYTES = 8


@dataclasses.dataclass
class Cohort:
    fof: str
    paths: list[str]
    ids: list[str]
    nb_controls: int
    n_reads: int
    read_size: int

    @property
    def record_bytes(self) -> int:
        return NAME_BYTES + 1 + self.read_size + 1

    @property
    def codes(self) -> int:
        """The 2-bit codes that reading every file gives (every byte but the
        newlines): what the count's K-EXT reads."""
        return len(self.paths) * self.n_reads * (NAME_BYTES + self.read_size)


def n_reads(config: dict) -> int:
    n = config["genome_len"] * config["coverage"] // config["read_size"]
    if not 0 < n < 10**6:
        raise ValueError(f"{n} reads a sample: the names hold six digits")
    return n


def _variants(rng, genome_len: int, n: int, mean: float, sd: float):
    lens = np.maximum(50, rng.normal(mean, sd, n).astype(np.int64))
    loci = rng.integers(0, genome_len, n)
    return [(int(p), _ASCII[rng.integers(0, 4, int(ln))]) for p, ln in zip(loci, lens)]


def _sample_genome(genome, own, other, rng, p_own: float, p_other: float):
    carried = [v for v, c in zip(own, rng.random(len(own)) < p_own) if c]
    carried += [v for v, c in zip(other, rng.random(len(other)) < p_other) if c]
    if not carried:
        return genome
    at = np.repeat([p for p, _ in carried], [len(s) for _, s in carried])
    return np.insert(genome, at, np.concatenate([s for _, s in carried]))


def _records(genome, rng, n: int, read_size: int, error_rate: float):
    """[n, read_size + 10] uint8: every record's name line, bases and
    newline."""
    starts = rng.integers(0, len(genome) - read_size, n)
    out = np.empty((n, NAME_BYTES + 1 + read_size + 1), dtype=np.uint8)
    reads = out[:, NAME_BYTES + 1:-1]
    reads[:] = np.lib.stride_tricks.sliding_window_view(genome, read_size)[starts]
    n_err = rng.binomial(n * read_size, error_rate)
    flat = rng.integers(0, n * read_size, n_err)
    reads[flat // read_size, flat % read_size] = _ASCII[rng.integers(0, 4, n_err)]
    out[:, 0] = ord(">")
    out[:, 1] = ord("r")
    idx = np.arange(n)
    for d in range(NAME_BYTES - 2):
        out[:, 2 + d] = ord("0") + (idx // 10 ** (NAME_BYTES - 3 - d)) % 10
    out[:, NAME_BYTES] = ord("\n")
    out[:, -1] = ord("\n")
    return out


def make(config: dict, seed: int, directory: str, threads: int = 8) -> Cohort:
    """Write the cohort of `config` under `directory` (created): one FASTA
    a sample and ``fof.txt``."""
    os.makedirs(directory, exist_ok=True)
    nc, nk = config["nb_controls"], config["nb_cases"]
    streams = np.random.SeedSequence(seed).spawn(1 + nc + nk)
    rng = np.random.default_rng(streams[0])
    genome = _ASCII[rng.integers(0, 4, config["genome_len"])]
    v_ctrl = _variants(rng, len(genome), config["nb_sv_controls"],
                       config["mean_sv_len"], config["sd_sv_len"])
    v_case = _variants(rng, len(genome), config["nb_sv_cases"],
                       config["mean_sv_len"], config["sd_sv_len"])
    n = n_reads(config)
    ids = [f"control_{i}" if i < nc else f"case_{i}" for i in range(nc + nk)]
    paths = [os.path.join(directory, f"{sid}.fasta") for sid in ids]

    def one(i: int) -> None:
        r = np.random.default_rng(streams[1 + i])
        if i < nc:
            g = _sample_genome(genome, v_ctrl, v_case, r, config["sv_per_indiv"],
                               config["prob_case"])
        else:
            g = _sample_genome(genome, v_case, v_ctrl, r, config["sv_per_indiv"],
                               config["prob_control"])
        with open(paths[i], "wb") as f:
            _records(g, r, n, config["read_size"], config["error_rate"]).tofile(f)
            # on the disk before the window: no write-back of the set-up's
            # files runs beside the jobs
            f.flush()
            os.fsync(f.fileno())

    with cf.ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, range(nc + nk)))
    fof = os.path.join(directory, "fof.txt")
    with open(fof, "w") as f:
        f.writelines(f"{sid} : {p}\n" for sid, p in zip(ids, paths))
    return Cohort(fof, paths, ids, nc, n, config["read_size"])


def reads(cohort: Cohort, i: int) -> np.ndarray:
    """Sample i's reads as written: [n_reads, read_size] ascii."""
    rec = np.fromfile(cohort.paths[i], dtype=np.uint8)
    return rec.reshape(cohort.n_reads, cohort.record_bytes)[:, NAME_BYTES + 1:-1]
