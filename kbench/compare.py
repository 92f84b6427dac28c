"""The comparison that decides ``correct``: what one job wrote against
what the plain reference computes from the same reads.

Every number compared, and its limit (``LIMITS``; a number is within it
when it is at most the limit), for a job of the Poisson test:

  hist_off   histogram fields that differ, over every sample's
             ``histograms/<id>.hist`` (unique, total, oversize, 255 bins of
             k-mers and of mass); a missing file counts all 513 of its
             fields. Exact: 0.
  tested_off |k-mers tested (the job's total_kmers) - the reference's|. 0.
  missing    reference-significant k-mers that no output file holds. 0.
  extra      k-mers in an output file that the reference does not report. 0.
  wrong_file k-mers written to the other group's file (the sign). 0.
  means_off  k-mers whose written control or case mean differs. 0.
  pval_off   k-mers whose written p-value differs from the reference's
             printed as kmdiff prints it (6 significant digits), but for a
             reference that lies within 1e-9 of its own value from the
             rounding boundary between the two (a tie that the order of
             f64 operations decides). 0.

Every limit is 0: the program's sound runs read 0 on every number, and the
control (kbench.control: the reference in f32) reads thousands on
pval_off (PERF.md).

A popstrat job (``pop_correction`` in the mix's analysis) is held to
``POP_LIMITS``: hist_off, tested_off, wrong_file and means_off as above
(popstrat changes no count), and against the f64 reference
(reference.popstrat), each of whose p-values a band surrounds: 1%
(``popstrat.BAND``), or 25% (``popstrat.SEP_BAND``) where the fit is
quasi-separated (a fitted probability within 1e-9 of 0 or 1: the
likelihood has no maximum, and p depends on where a solver stops):

  pop_pval_off  written k-mers whose p-value lies outside its band
                (relative to the reference's), the most of any one job.
                10: the port fits in f32, ~1e-5 (relative) from the
                reference, but kmdiff's IRLS stop rule (|delta mse| < 1e-6)
                ends a fit with one outlier after 3-4 iterations, 1-3.4%
                off, and a quasi-separated fit stops up to 9% off: sound
                jobs read 0-2; wrong PCs, fits in bf16 or uncorrected
                p-values read thousands.
  missing       k-mers that the configuration's correction accepts with
                every reference p-value at the top of its band (the strict
                set) and that no output file holds. 0.
  extra         written k-mers that the correction does not accept with
                every reference p-value at the bottom of its band (the
                loose set). 0. The bands are pop_pval_off's: a k-mer at the
                bound may fall either way, and benjamini's walk stops at
                its first rejection, so one such k-mer could move many.

PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from kbench.reference import Expected, PopExpected, Record, popstrat

LIMITS = {"hist_off": 0, "tested_off": 0, "missing": 0, "extra": 0,
          "wrong_file": 0, "means_off": 0, "pval_off": 0}
POP_LIMITS = {"hist_off": 0, "tested_off": 0, "missing": 0, "extra": 0,
              "wrong_file": 0, "means_off": 0, "pop_pval_off": 10}
#: numbers held a job at a time: a run reads their largest, not their sum
PER_JOB = {"pop_pval_off"}

_HEADER = re.compile(r"^(\d+)_pval=([^_]+)_control=(-?\d+)_case=(.+)$")
_HIST_FIELDS = 4 + 2 * 255


def read_hist(path: str) -> dict:
    """A kmtricks ``khist`` file: 21 bytes of header (magic, version,
    compression flag, type), k and the sample index, eight u64 (lower,
    upper, unique, total, oversize unique, oversize total, two reserved),
    then the unique and mass vectors of upper - lower + 1 u64 each."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[13:21].rstrip(b"\x00") != b"khist":
        raise ValueError(f"{path}: not a khist file")
    lower, upper, uniq, total, ov_u, ov_t = struct.unpack_from("<6Q", raw, 29)
    nb = upper - lower + 1
    vecs = np.frombuffer(raw, dtype="<u8", count=2 * nb, offset=29 + 64)
    if (lower, upper) != (1, 255):
        raise ValueError(f"{path}: bins {lower}..{upper}, expected 1..255")
    return {"unique": uniq, "total": total, "oversize_unique": ov_u,
            "oversize_total": ov_t, "unique_per_bin": vecs[:nb].astype(np.int64),
            "total_per_bin": vecs[nb:].astype(np.int64)}


def hist_off(got: dict, want: dict) -> int:
    off = sum(int(got[f] != want[f]) for f in
              ("unique", "total", "oversize_unique", "oversize_total"))
    for f in ("unique_per_bin", "total_per_bin"):
        off += int(np.count_nonzero(got[f] != want[f]))
    return off


def read_outputs(out_dir: str) -> dict[str, Record]:
    """Both output FASTA files -> {k-mer: Record}; a k-mer written twice
    keeps its last record (and counts as extra once more, in ``extra``)."""
    records: dict[str, Record] = {}
    for group in ("control", "case"):
        path = os.path.join(out_dir, f"{group}_kmers.fasta")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            lines = f.read().splitlines()
        for head, kmer in zip(lines[0::2], lines[1::2]):
            m = _HEADER.match(head[1:])
            if m is None:
                raise ValueError(f"{path}: malformed header {head!r}")
            if kmer in records:
                records[f"{kmer}#dup{len(records)}"] = records[kmer]
            records[kmer] = Record(group, float(m.group(2)), int(m.group(3)),
                                   float(m.group(4)))
    return records


def same_print(printed: float, exact: float) -> bool:
    """Whether `printed` is `exact` as kmdiff prints it (``%g``), a tie at
    the rounding boundary between the two taken either way."""
    ref = float(f"{exact:g}")
    return printed == ref or abs(exact - (printed + ref) / 2) <= 1e-9 * abs(exact)


def compare_records(got: dict[str, Record], want: dict[str, Record]) -> dict:
    wrong = means = pvals = 0
    for kmer in got.keys() & want.keys():
        g, w = got[kmer], want[kmer]
        wrong += g.file != w.file
        means += (g.mean_control, g.mean_case) != (w.mean_control, w.mean_case)
        pvals += not same_print(g.p, w.p)
    return {"missing": len(want.keys() - got.keys()),
            "extra": len(got.keys() - want.keys()),
            "wrong_file": wrong, "means_off": means, "pval_off": pvals}


def compare_pop_records(got: dict[str, Record], want: PopExpected) -> dict:
    wrong = means = pvals = 0
    for kmer in got.keys() & want.records.keys():
        g, w = got[kmer], want.records[kmer]
        wrong += g.file != w.file
        means += (g.mean_control, g.mean_case) != (w.mean_control, w.mean_case)
        band = popstrat.SEP_BAND if kmer in want.separated else popstrat.BAND
        pvals += abs(g.p - w.p) > band * w.p
    return {"missing": len(want.strict - got.keys()),
            "extra": len(got.keys() - want.loose),
            "wrong_file": wrong, "means_off": means, "pop_pval_off": pvals}


def limits_of(want: Expected | PopExpected) -> dict:
    return POP_LIMITS if isinstance(want, PopExpected) else LIMITS


def compare_job(run_dir: str, out_dir: str, ids: list[str], total_kmers,
                want: Expected | PopExpected) -> dict:
    """The numbers of one job (see the module's docstring)."""
    off = 0
    for sid, h in zip(ids, want.hists):
        path = os.path.join(run_dir, "histograms", f"{sid}.hist")
        off += hist_off(read_hist(path), h) if os.path.exists(path) else _HIST_FIELDS
    tested = abs(int(total_kmers) - want.n_tested) if total_kmers is not None \
        else want.n_tested
    got = read_outputs(out_dir)
    records = compare_pop_records(got, want) if isinstance(want, PopExpected) \
        else compare_records(got, want.records)
    return {"hist_off": off, "tested_off": tested, **records}


def merge(numbers: list[dict], limits: dict = LIMITS) -> dict:
    """Several jobs' numbers -> the run's: summed, but the largest of a
    number held a job at a time (PER_JOB)."""
    out = dict.fromkeys(limits, 0)
    for n in numbers:
        for key, v in n.items():
            out[key] = max(out[key], v) if key in PER_JOB else out[key] + v
    return out


def failures(numbers: dict, limits: dict = LIMITS) -> list[str]:
    return [k for k, lim in limits.items() if not numbers[k] <= lim]
