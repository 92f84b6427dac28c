"""Population-stratification correction (port of kmdiff_tpu/pipeline/popstrat.py).

The stage is the JAX package's (its docstring has the reference and the
re-design): the merge samples geno rows by k-mer hash (K-GENO and K-ROWS
in ops.merge_dev), the Eigenstrat PCA runs over them (ops.pca, K-GRAM),
one null logistic fit on [1 | PCs | covariates | gender | totals] and one
alt fit per significant k-mer with its count ratios as an extra column
(ops.glm, K-IRLS) give each k-mer's corrected p-value.

What is host work is imported from the JAX package as it is, since it
imports no JAX when loaded: the sampler and the Eigenstrat artifact writers
and readers, design conditioning, the reference-verbatim compat path
(kmdiff_tpu.core.linear_model) and the partition drains. This module
subclasses PopStratCorrector where the JAX class reaches its device
programs (the null fit's IRLS branch and correct_block) and rebuilds the
functions that construct a corrector or run the PCA.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kmdiff_tpu.core.model import chi2_sf1
from kmdiff_tpu.io.accumulator import FileAccumulator, KmerSignBlock
from kmdiff_tpu.pipeline import popstrat as _jpop
from kmdiff_tpu.pipeline.popstrat import (  # noqa: F401  (re-exports)
    NULL_FIT_FILE,
    GenoSampler,
    _condition_design,
    _read_geno,
    correct_partition,
    correct_partitions_pipelined,
    load_covariates_file,
    load_gender_file,
    write_gwas_info,
    write_parfile,
    write_pcs_evec,
    write_totals,
)
from kmdiff_tpu.utils.logging import logger
from kmdiff_tpu.utils.timer import Timer
from kmdiff_tpu_torch.ops.glm import default_dtype, irls
from kmdiff_tpu_torch.ops.pca import eigenstrat_pca


class PopStratCorrector(_jpop.PopStratCorrector):
    """The JAX package's corrector with its device fits on K-IRLS, on
    `device`. The compat path and the host Newton fit (irls=False) are the
    parent's."""

    def __init__(self, *args, device: torch.device, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = device

    def _tensor(self, a) -> torch.Tensor:
        # contiguous: numpy may give a new leading axis any stride
        return torch.as_tensor(np.asarray(a), dtype=default_dtype(),
                               device=self.device).contiguous()

    def init_global_features(self) -> None:
        if self.compat or not self.irls:
            super().init_global_features()
            return
        # the parent's feature columns, in its order
        # (kmdiff_tpu/pipeline/popstrat.py:329-365, the non-compat branch)
        cols = [np.ones(self.size), self.Z[:, : self.npc]]
        if self.C is not None:
            cols.append(self.C)
        if self.ginfo is not None:
            cols.append(self.ginfo[:, None])
        cols.append(self.totals[:, None])
        null = np.column_stack(cols)
        if self.stand:
            mean = null[:, 1:].mean(axis=0)
            std = null[:, 1:].std(axis=0)
            std = np.where(std > 1e-305, std, 1.0)
            null[:, 1:] = (null[:, 1:] - mean) / std
        self.null_features = null
        self.alt_features = np.column_stack([null, np.zeros(self.size)])

        # the same solver as the alt fits, on unit-max-abs centered columns
        # (log-likelihoods are invariant; the weights go back to raw space
        # for the persisted fit)
        Xc, center, scale = _condition_design(null)
        W, _err, _it, ll, _stop = irls(self._tensor(Xc[None]), None,
                                       self._tensor(self.Y), self.max_iteration)
        wc = W[0].cpu().numpy().astype(np.float64)
        w_raw = wc.copy()
        w_raw[1:] = wc[1:] / scale
        w_raw[0] = wc[0] - float(np.dot(wc[1:] / scale, center))
        self.null_model = w_raw
        self.null_loglik = float(ll[0])

    def correct_block(self, block: KmerSignBlock) -> None:
        """Correct a block of significant k-mers in place: one K-IRLS launch
        fits every k-mer's alt model, each on the shared conditioned design
        with its own centered, max-abs-scaled count-ratio column."""
        B = len(block)
        if B == 0:
            return
        if block.counts_ratio is None:
            raise ValueError("popstrat needs count-carrying accumulators")
        if self.compat:
            self._compat_correct_block(block)
            return
        shared_c, _c, _s = _condition_design(self.alt_features[:, :-1])
        Xb = np.column_stack([shared_c, np.zeros(self.size)])
        ratios = block.counts_ratio / self.totals[None, :]
        ratios = ratios - ratios.mean(axis=1, keepdims=True)
        ratios = ratios / np.maximum(
            np.abs(ratios).max(axis=1, keepdims=True), 1e-300
        )
        _w, _err, _it, ll, _stop = irls(
            self._tensor(Xb[None]), self._tensor(ratios), self._tensor(self.Y),
            self.max_iteration)
        alt_ll = ll.cpu().numpy().astype(np.float64)
        llr = -2.0 * (self.null_loglik - alt_ll)
        llr = np.where(
            (np.abs(llr) < self.epsilon) | (llr < 0.0) | ~np.isfinite(alt_ll),
            0.0,
            llr,
        )
        block.pvalues[:] = chi2_sf1(llr)


def _make_corrector(opt, total_controls, total_cases,
                    device: torch.device) -> PopStratCorrector:
    return PopStratCorrector(
        opt.nb_controls, opt.nb_cases, total_controls, total_cases, opt.npc,
        stand=opt.stand, irls=opt.irls, learning_rate=opt.learning_rate,
        max_iteration=opt.max_iteration, epsilon=opt.epsilon,
        compat=getattr(opt, "compat_popstrat", False), device=device,
    )


def fit_corrector(opt, config, pop_dir: str, device: torch.device,
                  timings: dict | None = None) -> PopStratCorrector:
    """PCA over the sampled geno matrix and the one null fit; writes the
    Eigenstrat artifacts and null_fit.npz, as the JAX package does.
    timings, when given, receives the wall seconds of "pca" and
    "null_fit"."""
    if timings is None:
        timings = {}
    from kmdiff_tpu.io.kmtricks import get_total_kmer, read_fof

    fof = read_fof(opt.kmtricks_dir)
    gender = load_gender_file(opt.gender)
    write_parfile(os.path.join(pop_dir, "parfile.txt"))
    write_gwas_info(
        fof, os.path.join(pop_dir, "gwas_eigenstratX.ind"),
        opt.nb_controls, gender,
    )
    total_controls, total_cases = get_total_kmer(
        opt.kmtricks_dir, opt.nb_controls, opt.nb_cases, config.abundance_min
    )
    write_totals(
        os.path.join(pop_dir, "gwas_eigenstratX.total"),
        total_controls, total_cases,
    )

    geno = _read_geno(os.path.join(pop_dir, "gwas_eigenstratX.geno"),
                      opt.nb_controls + opt.nb_cases)
    t0 = Timer()
    Z, evals = eigenstrat_pca(geno, device, is_diploid=opt.is_diploid,
                              n_evec=10)
    write_pcs_evec(os.path.join(pop_dir, "pcs.evec"), Z)
    timings["pca"] = t0.elapsed()
    logger.info("PCA: %d sampled k-mers, top eigenvalues %s (%s).",
                len(geno), np.round(evals[: opt.npc], 4).tolist(),
                t0.formatted())

    corr = _make_corrector(opt, total_controls, total_cases, device)
    corr.set_Z(Z)
    corr.set_covariates(
        load_covariates_file(opt.covariates, opt.nb_controls + opt.nb_cases)
    )
    if gender and all(e.id in gender and gender[e.id] != "U" for e in fof.entries):
        corr.set_gender(
            np.array([1.0 if gender[e.id] == "M" else 0.0 for e in fof.entries])
        )
    t0 = Timer()
    corr.init_global_features()
    timings["null_fit"] = t0.elapsed()
    logger.info("Null fit: log-likelihood %.6g (%s).", corr.null_loglik,
                t0.formatted())

    np.savez(
        os.path.join(pop_dir, NULL_FIT_FILE),
        null_features=corr.null_features,
        alt_features=corr.alt_features,
        null_model=corr.null_model,
        null_loglik=np.float64(corr.null_loglik),
        null_prod=np.float64(getattr(corr, "_null_prod", 0.0)),
    )
    return corr


def load_corrector(opt, config, pop_dir: str,
                   device: torch.device) -> PopStratCorrector:
    """A ready corrector from a persisted null fit (null_fit.npz, written by
    either package): the design and the null model load verbatim."""
    from kmdiff_tpu.io.kmtricks import get_total_kmer

    total_controls, total_cases = get_total_kmer(
        opt.kmtricks_dir, opt.nb_controls, opt.nb_cases, config.abundance_min
    )
    corr = _make_corrector(opt, total_controls, total_cases, device)
    with np.load(os.path.join(pop_dir, NULL_FIT_FILE)) as fit:
        corr.null_features = fit["null_features"]
        corr.alt_features = fit["alt_features"]
        corr.null_model = fit["null_model"]
        corr.null_loglik = float(fit["null_loglik"])
        if "null_prod" in fit:
            corr._null_prod = float(fit["null_prod"])
    return corr


def do_pop(opt, config, accumulators, pop_dir: str, part_dir: str,
           device: torch.device, timings: dict | None = None):
    """The popstrat stage: fit, then correct every partition's hits into
    new accumulators, which it returns. timings, when given, receives the
    wall seconds of "pca", "null_fit" and "alt_fits"."""
    if timings is None:
        timings = {}
    timer = Timer()
    logger.info("Population stratification correction...")
    corr = fit_corrector(opt, config, pop_dir, device, timings)

    nb_samples = opt.nb_controls + opt.nb_cases
    pop_accs = []
    for i in range(len(accumulators)):
        if opt.in_memory:
            from kmdiff_tpu.io.accumulator import VectorAccumulator

            pacc = VectorAccumulator()
        else:
            pacc = FileAccumulator(
                os.path.join(part_dir, f"p{i}_popstrat_uncorrected"),
                config.kmer_size,
                read=False,
                delete_on_destroy=not opt.keep_tmp,
                nb_samples=nb_samples,
            )
        pop_accs.append(pacc)
    t0 = Timer()
    correct_partitions_pipelined(corr, list(zip(accumulators, pop_accs)))
    timings["alt_fits"] = t0.elapsed()
    logger.info("Alt fits done (%s).", t0.formatted())
    logger.info("Population stratification corrected (%s).", timer.formatted())
    return pop_accs
