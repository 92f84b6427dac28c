"""Popstrat's knife edges, CUDA against the CPU: the corrected k-mers that
the popstrat `diff` keeps on one side and drops on the other, refitted.

Run on a CUDA card from the root of a checkout:

    python3 -m kmdiff_tpu_torch.tools.knife_edges --seed 8 -k 63

simulates the bench cohort (10 + 10 samples of a 2^23 bp genome, 150 bp
reads, coverage 1, error rate 0.001) from --seed, counts it at -k (4
partitions, hard-min 1), runs the popstrat `diff` (-s 0.001 --cutoff 1 -c
disabled --pop-correction --save-sk) on the card and on the CPU, and prints
the card and what `compare` and `describe` find. chip_smoke.py's phases 5
and 7 judge the bench cohort (seed 7) with the same two functions.

Each corrected k-mer's alt model is refitted three ways (`refit`): K-IRLS
with the CUDA run's null fit, its twin `glm.irls_plain` on the CPU with the
CPU run's, both in f32 as the two runs fitted them, and, as a witness that
shares no f32 rounding with either, the twin on the card in f64 with its
own f64 null fit. `describe` refits them once more, also with the twin in
f32 on the card, and reports, for the k-mers in one FASTA only, how many
distinct alt designs they are and how each side's fits stopped.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

GENOME = 1 << 23
N_CONTROLS = N_CASES = 10
POP_FLAGS = ["-s", "0.001", "--cutoff", "1", "-c", "disabled",
             "--pop-correction", "--save-sk", "--keep-tmp"]


def _read_fasta(path):
    with open(path) as f:
        lines = f.read().split("\n")
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines) - 1, 2)]


def fasta_pvalues(out) -> dict:
    """{k-mer: p-value} of a `diff`'s two FASTA files."""
    return {seq: float(name.split("pval=")[1].split("_")[0])
            for g in ("control", "case")
            for name, seq in _read_fasta(os.path.join(out, f"{g}_kmers.fasta"))}


def _alt_fits(corr, ratios, fit, where, dtype, null_ll=None):
    """The alt fits of the count-ratio rows `ratios` ([H, n], centered and
    max-abs scaled as PopStratCorrector.correct_block makes them) with
    `fit` (glm.irls or glm.irls_plain) in dtype on `where`, against
    null_ll (the corrector's own null fit by default) -> (p [H], stop [H],
    iters [H], weights [H, F]), the LLR rule of correct_block."""
    from kmdiff_tpu_torch.ops import glm
    from kmdiff_tpu_torch.pipeline.popstrat import _condition_design, chi2_sf1

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=where)

    y = t(corr.Y)
    if null_ll is None:
        null_ll = corr.null_loglik
    shared, _c, _s = _condition_design(corr.alt_features[:, :-1])
    w, _e, iters, ll, stop = fit(t(np.column_stack([shared, np.zeros(corr.size)])[None]),
                                  t(ratios), y, corr.max_iteration)
    ll = ll.cpu().numpy().astype(np.float64)
    llr = -2.0 * (null_ll - ll)
    llr = np.where((np.abs(llr) < corr.epsilon) | (llr < 0.0) | ~np.isfinite(ll),
                   0.0, llr)
    return (chi2_sf1(llr), stop.cpu().numpy(), iters.cpu().numpy(),
            w.cpu().numpy().astype(np.float64))


def _f64_null(corr, dev) -> float:
    """The null fit's log-likelihood by the twin in f64 on dev."""
    from kmdiff_tpu_torch.ops import glm
    from kmdiff_tpu_torch.pipeline.popstrat import _condition_design

    null_c, _c, _s = _condition_design(corr.null_features)
    X, y = (torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)
            for a in (null_c[None], corr.Y))
    return float(glm.irls_plain(X, None, y, corr.max_iteration)[3][0])


def refit(dev, opt, run_dir, gpu_out, cpu_out, nb_samples):
    """Refit the alt model of every k-mer the popstrat `diff`s corrected
    (the CUDA run's kept spills): through PopStratCorrector.correct_block
    on the card with the CUDA run's null fit ("gpu") and on the CPU with the
    CPU run's ("cpu"), and the f64 witness ("f64"). Returns (k-mers [H] as
    strings, {"gpu" | "cpu" | "f64": p-values [H]}, ratios [H, n])."""
    from kmdiff_tpu_torch.cmd.diff import read_config
    from kmdiff_tpu_torch.core.kmer import packed_to_strings
    from kmdiff_tpu_torch.ops import glm
    from kmdiff_tpu_torch.pipeline.popstrat import (
        FileAccumulator,
        KmerSignBlock,
        load_corrector,
    )

    config = read_config(run_dir)
    blocks = []
    for p in range(config.nb_partitions):
        acc = FileAccumulator(os.path.join(gpu_out, "partitions", f"p{p}_uncorrected"),
                              config.kmer_size, read=True, nb_samples=nb_samples)
        blocks.extend(acc.blocks())
    blk = KmerSignBlock.concat(blocks)
    ps = {}
    for label, where, out in (("gpu", dev, gpu_out),
                              ("cpu", torch.device("cpu"), cpu_out)):
        sub = KmerSignBlock(blk.kmers, blk.pvalues.copy(), blk.signs,
                            blk.mean_control, blk.mean_case, blk.counts_ratio)
        load_corrector(opt, config, os.path.join(out, "popstrat"),
                       where).correct_block(sub)
        ps[label] = sub.pvalues
    corr = load_corrector(opt, config, os.path.join(gpu_out, "popstrat"), dev)
    r = blk.counts_ratio / corr.totals[None, :]
    r = r - r.mean(axis=1, keepdims=True)
    r = r / np.maximum(np.abs(r).max(axis=1, keepdims=True), 1e-300)
    ps["f64"] = _alt_fits(corr, r, glm.irls_plain, dev, torch.float64,
                          _f64_null(corr, dev))[0]
    return np.array(packed_to_strings(blk.kmers, config.kmer_size)), ps, r


def design_ids(kmers, ratios, chosen) -> dict:
    """{k-mer: id of its alt design} for the k-mers in chosen: k-mers with
    equal count-ratio rows have one design, and so one fit."""
    at = np.isin(kmers, sorted(chosen))
    _d, group = np.unique(ratios[at], axis=0, return_inverse=True)
    return dict(zip(kmers[at].tolist(), group.ravel().tolist()))


def compare(dev, opt, run_dir, gpu_out, cpu_out, alpha, nb_samples) -> dict:
    """The two popstrat `diff`s' FASTA and every alt fit refitted (refit):
    the k-mers in both FASTA ("both") and their largest relative p-value
    gap ("rel"), those within 1% of alpha ("near"), those in one FASTA only
    but not near ("gpu_only", "cpu_only", "only") and the alt design of
    each of these ("design": k-mer -> id; k-mers with equal count ratios
    have one design and one fit, as a variant's k-mers often do), each
    side's significant set after the refit ("sig", with "f64"), and refit's
    "kmers", "ps" and "ratios"."""
    got, want = fasta_pvalues(gpu_out), fasta_pvalues(cpu_out)
    keys, ps, ratios = refit(dev, opt, run_dir, gpu_out, cpu_out, nb_samples)
    sig = {k: set(keys[p < alpha].tolist()) for k, p in ps.items()}
    both = set(got) & set(want)
    near = {k for k, p in {**got, **want}.items() if abs(p - alpha) <= 0.01 * alpha}
    gpu_only = set(got) - set(want) - near
    cpu_only = set(want) - set(got) - near
    only = gpu_only | cpu_only
    return {
        "got": got, "want": want, "both": both, "near": near,
        "rel": max((abs(got[k] - want[k]) / want[k] for k in both if want[k] > 0),
                   default=0.0),
        "gpu_only": gpu_only, "cpu_only": cpu_only, "only": only,
        "design": design_ids(keys, ratios, only),
        "sig": sig, "kmers": keys, "ps": ps, "ratios": ratios,
    }


def describe(dev, opt, run_dir, gpu_out, cpu_out, cmp: dict, alpha) -> str:
    """The k-mers in one FASTA only (cmp from compare) and how their alt
    fits went on four sides, each refitted in one batch of every corrected
    k-mer as compare's refits: K-IRLS and the twin on the CPU, each with its
    run's null fit, the twin in f32 on the card with the CUDA run's null
    fit, and f64. Reports how many distinct alt designs they are (k-mers
    with equal count ratios have equal designs) and, a side at a time, how
    many are significant and how the fits stopped (stop 0 converged, 1
    frozen by the solve, 2 at max_iters); then a line a design
    (_design_line)."""
    from kmdiff_tpu_torch.cmd.diff import read_config
    from kmdiff_tpu_torch.ops import glm
    from kmdiff_tpu_torch.pipeline.popstrat import load_corrector

    at = np.isin(cmp["kmers"], sorted(cmp["only"]))
    if not at.any():
        return "no k-mer in one FASTA only"
    design = design_ids(cmp["kmers"], cmp["ratios"], cmp["only"])
    group = np.array([design[k] for k in cmp["kmers"][at].tolist()])
    config = read_config(run_dir)
    cpu = torch.device("cpu")
    c_gpu = load_corrector(opt, config, os.path.join(gpu_out, "popstrat"), dev)
    c_cpu = load_corrector(opt, config, os.path.join(cpu_out, "popstrat"), cpu)
    r = cmp["ratios"]
    fits = {
        "K-IRLS": _alt_fits(c_gpu, r, glm.irls, dev, torch.float32),
        "twin (CPU)": _alt_fits(c_cpu, r, glm.irls_plain, cpu, torch.float32),
        "twin (card, f32)": _alt_fits(c_gpu, r, glm.irls_plain, dev, torch.float32),
        "f64": _alt_fits(c_gpu, r, glm.irls_plain, dev, torch.float64,
                         _f64_null(c_gpu, dev)),
    }
    # the batch refits must be compare's, which went through correct_block
    off = [side for side, label in (("K-IRLS", "gpu"), ("twin (CPU)", "cpu"),
                                    ("f64", "f64"))
           if not np.array_equal(fits[side][0], cmp["ps"][label])]
    if off:
        raise AssertionError(f"knife edges: the {', '.join(off)} refits differ "
                             "from compare's")
    f64 = fits["f64"][0][at] < alpha
    parts = []
    for side, (p, stop, iters, _w) in fits.items():
        sig, stop, iters = p[at] < alpha, stop[at], iters[at]
        parts.append(
            f"{side} significant on {int(sig.sum())} ({len(np.unique(group[sig]))} "
            f"designs), stops 0/1/2 = "
            + "/".join(str(int((stop == c).sum())) for c in range(3))
            + f", iterations {int(iters.min())}-{int(iters.max())}"
            + ("" if side == "f64" else f", f64 sides with it on {int((sig == f64).sum())}"))
    sizes = np.bincount(group)
    rows = np.flatnonzero(at)
    designs = [_design_line(c_gpu, r, rows[group == g][0], dev, alpha, fits)
               for g in range(len(sizes))]
    return (f"{int(at.sum())} k-mers in one FASTA only are {len(sizes)} distinct "
            f"alt designs ({', '.join(map(str, sorted(sizes.tolist(), reverse=True)))} "
            "k-mers); " + "; ".join(parts) + "\n" + "\n".join(designs))


def _design_line(corr, ratios, i, dev, alpha, fits) -> str:
    """One alt design (row i of ratios) on every side of describe's fits:
    p / alpha and iterations, and whether the f64 fit stopped at a
    maximum: the f64 fit run on past its stopping rule (no tolerance, up to
    max_iteration), its p / alpha, iterations and largest |weight| and
    linear predictor |eta| before and after (a likelihood that keeps rising
    as the weights grow has no finite maximum: a separated fit)."""
    import functools

    from kmdiff_tpu_torch.ops import glm
    from kmdiff_tpu_torch.pipeline.popstrat import _condition_design

    shared, _c, _s = _condition_design(corr.alt_features[:, :-1])

    def eta(w):
        return float(np.abs(shared @ w[:-1] + ratios[i] * w[-1]).max())

    sides = ", ".join(f"{side} p/alpha {fit[0][i] / alpha:.4f} in {int(fit[2][i])} "
                      "iterations" for side, fit in fits.items())
    w64 = fits["f64"][3][i]
    p, stop, iters, w = _alt_fits(corr, ratios[i:i + 1],
                                  functools.partial(glm.irls_plain, eps_conv=0.0),
                                  dev, torch.float64, _f64_null(corr, dev))
    return (f"  design of k-mer row {i}: {sides}; f64 max|w| {np.abs(w64).max():.4g}, "
            f"max|eta| {eta(w64):.4g}; run on with no tolerance: p/alpha "
            f"{p[0] / alpha:.4f} after {int(iters[0])} iterations (stop {int(stop[0])}), "
            f"max|w| {np.abs(w[0]).max():.4g}, max|eta| {eta(w[0]):.4g}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7, help="the cohort's popsim seed")
    ap.add_argument("-k", type=int, default=63, help="k-mer size")
    args = ap.parse_args()

    from kmdiff_tpu_torch.cli import diff_options, main as cli, parse_args

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    work = os.path.join(os.getcwd(), "build", "knife_edges")
    shutil.rmtree(work, ignore_errors=True)
    sim, run = os.path.join(work, "sim"), os.path.join(work, "run")
    t0 = time.perf_counter()
    cli(["popsim", "-o", sim, "--genome-len", str(GENOME), "-1", str(N_CONTROLS),
         "-2", str(N_CASES), "--read-size", "150", "--coverage", "1",
         "--error-rate", "0.001", "--random-seed", str(args.seed)], device=dev)
    cli(["count", "--file", os.path.join(sim, "fof.txt"), "--kmer-size", str(args.k),
         "--hard-min", "1", "--nb-partitions", "4", "--threads", "4",
         "--run-dir", run], device=dev)
    outs = {}
    for label, where in (("gpu", dev), ("cpu", "cpu")):
        outs[label] = os.path.join(work, label)
        cli(["diff", "--km-run-dir", run, "-1", str(N_CONTROLS), "-2", str(N_CASES),
             "--threads", "4", *POP_FLAGS, "--output-dir", outs[label]], device=where)
    opt = diff_options(parse_args(["diff", "--km-run-dir", run, "-1", str(N_CONTROLS),
                                   "-2", str(N_CASES), *POP_FLAGS]))
    cmp = compare(dev, opt, run, outs["gpu"], outs["cpu"], 0.001,
                  N_CONTROLS + N_CASES)
    miss = {s: len(cmp["sig"][s] ^ cmp["sig"]["f64"]) for s in ("gpu", "cpu")}
    right = {s: sum((k in cmp["sig"][s]) == (k in cmp["sig"]["f64"])
                    for k in cmp["only"]) for s in ("gpu", "cpu")}
    print(f"seed {args.seed}, k = {args.k}: {len(cmp['both'])} k-mers in both FASTA, "
          f"p-values within {cmp['rel']:.3g} relative; {len(cmp['gpu_only'])} on "
          f"CUDA only, {len(cmp['cpu_only'])} on the CPU only; the f64 refit sides "
          f"with CUDA on {right['gpu']} of them, with the CPU on {right['cpu']}; "
          f"f64's set ({len(cmp['sig']['f64'])}) {miss['gpu']} k-mers off CUDA's, "
          f"{miss['cpu']} off the CPU's ({time.perf_counter() - t0:.1f} s)")
    print(describe(dev, opt, run, outs["gpu"], outs["cpu"], cmp, 0.001))
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
