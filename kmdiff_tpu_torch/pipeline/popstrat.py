"""Population-stratification correction (port of kmdiff_tpu/pipeline/popstrat.py).

Reference: include/kmdiff/popstrat.hpp + src/popstrat.cpp — the do_pop
stage: (1) during merge, Bernoulli-sample k-mers into an Eigenstrat geno
matrix; (2) run smartpca + evec2pca subprocesses for per-sample PCs;
(3) fit a null logistic model [1 | PCs | covariates | gender | totals] ->
label once; (4) per significant k-mer, fit an alt model with one extra
feature (count/total per sample) and correct the p-value via the
likelihood ratio.

Here, as in the JAX package:
  * sampling is DETERMINISTIC: a k-mer is sampled iff its avalanche hash
    (keyed by --random-seed) falls below kmer_pca * 2^32 — reproducible
    regardless of thread scheduling (the reference's std::uniform draw is
    thread-order-dependent, cli.cpp:349-352). The merge samples geno rows
    on the device (K-GENO and K-ROWS in ops.merge_dev); sample_mask is the
    host form of the same hash chain.
  * PCA runs in-process (ops.pca, K-GRAM); Eigenstrat text artifacts
    (.geno/.snp/.ind/.total/parfile/pcs.evec) are still written for
    interop/debugging parity, byte-identical to the JAX package's.
  * the null fit and the per-k-mer alt fits run on K-IRLS (ops.glm), one
    launch a spill block, instead of a scalar fit per k-mer per thread.

Reference divergences (both are reference *bugs*, reproduced as intended
behavior instead):
  * when every sample has known gender the reference writes the totals
    feature one slot past the allocated row (popstrat.cpp:298-306, an
    out-of-bounds std::vector write); we size the feature matrix to hold
    both gender and totals.
  * the reference's standardize() divides feature columns by
    stddev[row_index] (popstrat.cpp:331-369); we standardize each column
    by its own stddev. The reference also force-enables standardization
    (s_stand=true cannot be unset, popstrat.hpp:150-176 set_params);
    we honor --stand (default off, like the CLI flag suggests).

`--compat-popstrat` disables both fixes and replicates the reference
verbatim for A/B runs: forced buggy standardize, reference glm_irls per
k-mer (core.linear_model), raw per-sample likelihood PRODUCTS with the
0.001/1.0 both-underflow fallback, s_epsilon=1e-30, s_max_iter=100
(popstrat.hpp:147-176, 249-333). Gender-known cohorts drop the totals
column exactly like the reference's overflowing write effectively does.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from kmdiff_tpu_torch.core.linear_model import (
    glm_irls,
    glm_newton_raphson,
    predict,
    sigmoid,
)
from kmdiff_tpu_torch.core.model import chi2_sf1
from kmdiff_tpu_torch.io.accumulator import FileAccumulator, KmerSignBlock
from kmdiff_tpu_torch.io.kmtricks import get_total_kmer, read_fof
from kmdiff_tpu_torch.ops.glm import default_dtype, irls
from kmdiff_tpu_torch.ops.pca import eigenstrat_pca
from kmdiff_tpu_torch.utils.logging import logger
from kmdiff_tpu_torch.utils.timer import Timer

_SAMPLE_SEED = np.uint32(0x51ED2700)


def _avalanche_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def sample_mask(kmers: np.ndarray, rate: float, seed: int) -> np.ndarray:
    """Deterministic Bernoulli(rate) mask keyed on the k-mer value."""
    with np.errstate(over="ignore"):
        h = np.full(len(kmers), _SAMPLE_SEED ^ np.uint32(seed), dtype=np.uint32)
        for w in range(kmers.shape[1]):
            hi = (kmers[:, w] >> np.uint64(32)).astype(np.uint32)
            lo = (kmers[:, w] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            h = _avalanche_np(hi ^ h)
            h = _avalanche_np(lo ^ h)
    return h < np.uint32(min(rate, 1.0) * 4294967295.0)


class GenoSampler:
    """Collects the sampled presence matrix during merge and writes the
    Eigenstrat artifacts (reference: EigGenoFile/EigSnpFile/Sampler,
    popstrat.hpp:56-146). Thread-safe; rows are kept per partition and
    concatenated in partition order so output is deterministic."""

    def __init__(self, pop_dir: str, rate: float, seed: int, nb_samples: int):
        self.pop_dir = pop_dir
        self.rate = rate
        self.seed = seed
        self.nb_samples = nb_samples
        self._rows: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        self.geno: np.ndarray | None = None

    def add_sampled(self, partition: int, presence: np.ndarray) -> None:
        """One partition's sampled presence rows, sampled on the device
        with sample_mask's hash chain (ops.merge_dev)."""
        with self._lock:
            self._rows[partition] = presence

    def close(self) -> None:
        parts = [self._rows[p] for p in sorted(self._rows)]
        self.geno = (
            np.concatenate(parts)
            if parts
            else np.zeros((0, self.nb_samples), np.uint8)
        )
        self._write_eigen_files(self.geno)

    def _write_eigen_files(self, geno: np.ndarray) -> None:
        geno_path = os.path.join(self.pop_dir, "gwas_eigenstratX.geno")
        snp_path = os.path.join(self.pop_dir, "gwas_eigenstratX.snp")
        with open(geno_path, "w") as g, open(snp_path, "w") as s:
            for i, row in enumerate(geno):
                g.write("\t".join("1" if v else "0" for v in row) + "\t\n")
                s.write(f"{i}\t1\t0.0\t0\n")

    # multi-process protocol: every rank saves its partitions' sampled rows;
    # after the merge barrier the primary joins them in partition order, so
    # the .geno is a single process's

    def close_parts(self) -> None:
        for p, rows in self._rows.items():
            np.save(os.path.join(self.pop_dir, f"geno_part_{p}.npy"), rows)

    @staticmethod
    def assemble_parts(pop_dir: str, nb_partitions: int,
                       nb_samples: int) -> np.ndarray:
        sampler = GenoSampler(pop_dir, 0.0, 0, nb_samples)
        for p in range(nb_partitions):
            path = os.path.join(pop_dir, f"geno_part_{p}.npy")
            if os.path.exists(path):
                sampler.add_sampled(p, np.load(path))
                os.remove(path)
        sampler.close()
        return sampler.geno


def write_parfile(path: str) -> None:
    """Parity artifact (reference: popstrat.hpp:28-37, popstrat.cpp:9-15)."""
    entries = {
        "genotypename": "gwas_eigenstratX.geno",
        "snpname": "gwas_eigenstratX.snp",
        "indivname": "gwas_eigenstratX.ind",
        "evecoutname": "gwas_eigenstrat.evec",
        "evaloutname": "gwas_eigenstrat.eval",
        "usenorm": "YES",
        "numoutlieriter": "0",
        "numoutevec": "10",
    }
    with open(path, "w") as f:
        for k, v in sorted(entries.items()):
            f.write(f"{k}: {v}\n")


def write_gwas_info(fof, path: str, nb_controls: int, gender: dict[str, str]):
    """.ind files (reference: src/popstrat.cpp:17-88)."""
    parent = os.path.dirname(path)
    with open(path, "w") as out, \
            open(os.path.join(parent, "control.ind"), "w") as co, \
            open(os.path.join(parent, "case.ind"), "w") as ca:
        for i, e in enumerate(fof.entries):
            g = gender.get(e.id, "U")
            label = "Control" if i < nb_controls else "Case"
            line = f"{e.id}\t{g}\t{label}\n"
            out.write(line)
            (co if i < nb_controls else ca).write(line)


def write_totals(path: str, total_controls, total_cases) -> None:
    with open(path, "w") as f:
        for t in list(total_controls) + list(total_cases):
            f.write(f"{t}\n")


def write_pcs_evec(path: str, Z: np.ndarray) -> None:
    """pcs.evec: one row per sample, n_evec PC columns
    (reference: src/popstrat.cpp:114-134 output of evec2pca)."""
    with open(path, "w") as f:
        for row in Z:
            f.write("".join(f" {v: .4f}" for v in row) + "\n")


def load_gender_file(path: str) -> dict[str, str]:
    """gender file: lines '<sample_id> <M|F|U>' (reference:
    src/popstrat.cpp:22-42)."""
    out = {}
    if not path:
        return out
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                g = parts[1][0].upper()
                if g not in "MFU":
                    raise ValueError(f"Unknown gender: {parts[1]}")
                out[parts[0]] = g
    return out


def load_covariates_file(path: str, nb_samples: int) -> np.ndarray | None:
    """covariates: whitespace-separated doubles, row-major
    [nb_samples, n_cov] (reference: src/popstrat.cpp:178-226)."""
    if not path:
        return None
    raw = np.loadtxt(path, dtype=np.float64).ravel()
    if len(raw) % nb_samples:
        raise ValueError(
            f"covariate count {len(raw)} not divisible by {nb_samples} samples"
        )
    return raw.reshape(nb_samples, len(raw) // nb_samples)


def _compat_standardize(null: np.ndarray, alt: np.ndarray) -> None:
    """The reference standardize() with VERBATIM semantics, bugs included
    (src/popstrat.cpp:325-369): column means divided by the COLUMN count
    (not the row count), and each row i divided by stddev[i] — the stddev
    of COLUMN i — so row 0 and rows past the feature count are left
    unscaled. In-place on both matrices; alt's last (ratio) column is not
    touched (the reference loop bounds at ncols(null))."""
    n, F = null.shape
    means = null.sum(axis=0)
    means[1:] = means[1:] / F  # reference divides by ncols, not nrows
    stddev = np.zeros(max(n, F))
    for j in range(1, F):
        stddev[j] = np.sqrt(((null[:, j] - means[j]) ** 2).sum() / n)
    for i in range(n):
        s = stddev[i]
        if abs(s) > 1e-305:
            null[i, 1:] = (null[i, 1:] - means[1:F]) / s
            alt[i, 1:F] = (alt[i, 1:F] - means[1:F]) / s


def _condition_design(X: np.ndarray):
    """Center + max-abs-scale columns 1.. (the intercept stays) for the
    DEVICE fits. Exactly log-likelihood-invariant: the intercept spans
    the centering shift and scaling reparametrizes each weight; what it
    changes is NUMERICS — raw designs mix ~1e6 totals with O(1) PCs
    (f32-fatal condition), and even max-abs scaling alone leaves
    near-constant columns collinear with the intercept, a flat likelihood
    direction where the mse-delta stop rule parks differently per
    platform (~0.3 nats of null-LL slack observed TPU vs CPU, shifting
    EVERY corrected p). Returns (X_conditioned, center, scale)."""
    c = X[:, 1:].mean(axis=0)
    Xc = np.array(X, dtype=np.float64, copy=True)
    Xc[:, 1:] -= c
    s = np.max(np.abs(Xc[:, 1:]), axis=0)
    s[s == 0] = 1.0
    Xc[:, 1:] /= s
    return Xc, c, s


def _likelihood_product(features: np.ndarray, model: np.ndarray,
                        y: np.ndarray) -> float:
    """Raw per-sample likelihood product in the reference's sequential
    accumulation order (popstrat.hpp:267-310) — underflows to 0.0 for
    large cohorts exactly like the reference does."""
    out = 1.0
    for f in range(len(features)):
        p = predict(model, features[f])
        out = out * (p if y[f] == 1 else 1.0 - p)
    return out


class PopStratCorrector:
    """Null/alt logistic LRT corrector (reference: pop_strat_corrector,
    popstrat.hpp:147-367, src/popstrat.cpp:136-370), with its K-IRLS fits
    on `device`."""

    def __init__(self, nb_controls: int, nb_cases: int, total_controls,
                 total_cases, npc: int, *, stand: bool = False,
                 irls: bool = True, learning_rate: float = 0.1,
                 max_iteration: int | None = None,
                 epsilon: float | None = None,
                 compat: bool = False, device: torch.device):
        self.compat = compat
        self.device = device
        self.nb_controls = nb_controls
        self.nb_cases = nb_cases
        self.size = nb_controls + nb_cases
        self.totals = np.asarray(
            list(total_controls) + list(total_cases), dtype=np.float64
        )
        self.npc = npc
        self.stand = stand
        self.irls = irls
        self.learning_rate = learning_rate
        # None = not explicitly set; the default path uses 500 / 1e-7 and
        # the compat path the reference defaults (see _compat_* below)
        self._max_iter_arg = max_iteration
        self._epsilon_arg = epsilon
        self.max_iteration = 500 if max_iteration is None else max_iteration
        self.epsilon = 1e-7 if epsilon is None else epsilon
        # label: Control -> 1, Case -> 0 (src/popstrat.cpp:164-172)
        self.Y = np.concatenate(
            [np.ones(nb_controls), np.zeros(nb_cases)]
        )
        self.Z: np.ndarray | None = None
        self.C: np.ndarray | None = None
        self.ginfo: np.ndarray | None = None
        self.null_features: np.ndarray | None = None
        self.alt_features: np.ndarray | None = None
        self.null_model: np.ndarray | None = None
        self.null_loglik: float = 0.0

    def _tensor(self, a, device: torch.device | None = None) -> torch.Tensor:
        # contiguous: numpy may give a new leading axis any stride
        return torch.as_tensor(np.asarray(a), dtype=default_dtype(),
                               device=device or self.device).contiguous()

    def set_Z(self, Z: np.ndarray) -> None:
        self.Z = np.asarray(Z, dtype=np.float64)

    def set_covariates(self, C: np.ndarray | None) -> None:
        self.C = None if C is None else np.asarray(C, dtype=np.float64)

    def set_gender(self, ginfo: np.ndarray | None) -> None:
        """ginfo: per-sample 1(M)/0(F), or None when any sample unknown
        (the reference only uses gender when ALL are known,
        popstrat.cpp:293-311)."""
        self.ginfo = None if ginfo is None else np.asarray(ginfo, np.float64)

    def init_global_features(self) -> None:
        cols = [np.ones(self.size)]
        cols.append(self.Z[:, : self.npc])
        if self.C is not None:
            cols.append(self.C)
        if self.ginfo is not None:
            cols.append(self.ginfo[:, None])
            if not self.compat:
                cols.append(self.totals[:, None])
            # compat: the reference writes totals one slot PAST the null
            # row when gender is known (popstrat.cpp:298-306) and the alt
            # slot it lands in is then overwritten by the ratio column
            # (popstrat.hpp:252-257) — totals are effectively dropped
        else:
            cols.append(self.totals[:, None])
        null = np.column_stack(cols)

        if self.compat:
            # alt = null + the per-k-mer ratio slot, BEFORE standardize so
            # the shared columns transform together (reference order:
            # init_global_features fills both, then standardize())
            alt = np.column_stack([null, np.zeros(self.size)])
            _compat_standardize(null, alt)
            self.null_features = null
            self.alt_features = alt
            self._compat_fit_null()
            return

        if self.stand:
            mean = null[:, 1:].mean(axis=0)
            std = null[:, 1:].std(axis=0)
            std = np.where(std > 1e-305, std, 1.0)
            null[:, 1:] = (null[:, 1:] - mean) / std

        self.null_features = null
        # alt adds the per-k-mer count-ratio column last
        self.alt_features = np.column_stack([null, np.zeros(self.size)])

        if self.irls:
            # the SAME batched device solver as the per-k-mer alt fits:
            # null and alt must share numerics or every LLR is biased by
            # solver asymmetry (the reference's pivot-free LU fails on
            # separable cohorts where a pivoted solve converges).
            #
            # Column conditioning: raw designs mix ~1e6-scale totals with
            # O(1) PCs (and the alt fits add ~1e-6 ratios) — condition
            # ~1e12, beyond f32 (observed on TPU: the null fit diverged by
            # ~1e11 in weight space at 100-sample scale). Logistic
            # log-likelihoods are EXACTLY invariant under per-column
            # scaling (weights transform inversely), so the device fits
            # run on unit-max-abs columns; artifacts keep raw features.
            Xc, center, scale = _condition_design(null)
            W, _err, _it, ll, _stop = irls(self._tensor(Xc[None]), None,
                                           self._tensor(self.Y),
                                           self.max_iteration)
            # translate weights back to RAW-feature space for the manifest
            wc = W[0].cpu().numpy().astype(np.float64)
            w_raw = wc.copy()
            w_raw[1:] = wc[1:] / scale
            w_raw[0] = wc[0] - float(np.dot(wc[1:] / scale, center))
            self.null_model = w_raw
            self.null_loglik = float(ll[0])
        else:
            model, singular, nan, _err, _it = glm_newton_raphson(
                self.null_features, self.Y, self.learning_rate,
                self.max_iteration,
            )
            if singular or nan:
                logger.warning("null logistic fit hit a singular Hessian.")
            self.null_model = model
            p = sigmoid(self.null_features @ model)
            with np.errstate(divide="ignore"):
                self.null_loglik = float(
                    np.sum(np.where(self.Y == 1, np.log(p), np.log1p(-p)))
                )

    # -- compat (reference-verbatim) path --------------------------------------

    def _compat_max_iter(self) -> int:
        # reference default s_max_iter=100; the setter only overrides on an
        # explicit --max-iteration (popstrat.hpp:168-176)
        return 100 if self._max_iter_arg is None else self._max_iter_arg

    def _compat_epsilon(self) -> float:
        # reference default s_epsilon=1e-30, overridden only explicitly
        return 1e-30 if self._epsilon_arg is None else self._epsilon_arg

    def _compat_fit_null(self) -> None:
        model, singular, nan, _err, _it = glm_irls(
            self.null_features, self.Y, self._compat_max_iter()
        )
        if singular or nan:
            logger.warning("compat null logistic fit hit a singular Hessian.")
        self.null_model = model
        self._null_prod = _likelihood_product(
            self.null_features, model, self.Y
        )
        # log-likelihood kept for the persisted-fit manifest only
        with np.errstate(divide="ignore"):
            self.null_loglik = float(np.log(max(self._null_prod, 1e-320)))

    def _compat_correct_block(self, block: KmerSignBlock) -> None:
        """Per-k-mer scalar fits with the reference's exact semantics
        (popstrat.hpp:249-333): glm_irls on [shared | ratio] features, raw
        per-sample likelihood products, the 0.001/1.0 both-zero fallback,
        LLR clips with s_epsilon, chi^2_1. Host-sequential by design —
        this is an A/B diagnostic mode, not the performance path."""
        ratios = block.counts_ratio / self.totals[None, :]
        max_iter = self._compat_max_iter()
        eps = self._compat_epsilon()
        for r in range(len(block)):
            feats = self.alt_features.copy()
            feats[:, -1] = ratios[r]
            model, _sing, _nan, _err, _it = glm_irls(feats, self.Y, max_iter)
            alt_prod = _likelihood_product(feats, model, self.Y)
            null_prod = self._null_prod
            if null_prod == 0.0 and alt_prod == 0.0:
                null_prod, alt_prod = 0.001, 1.0
            with np.errstate(divide="ignore", invalid="ignore"):
                # np.float64 division: alt_prod alone underflowing to 0
                # gives IEEE inf -> llr=-inf -> clipped to 0 below, the
                # reference's C++ flow (popstrat.hpp:318-332) — a Python
                # float here would raise ZeroDivisionError instead
                llr = -2.0 * np.log(np.float64(null_prod) / np.float64(alt_prod))
            if abs(llr) < eps or llr < 0.0 or np.isnan(alt_prod):
                llr = 0.0
            block.pvalues[r] = chi2_sf1(llr)

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
        from kmdiff_tpu_torch.parallel.mesh import Mesh
        from kmdiff_tpu_torch.parallel.runtime import get_mesh

        mesh = get_mesh(self.device)
        if self.device.type != "cuda":
            # K-IRLS fits an item alone, so a split changes no bit on the
            # card; the CPU twin's batched f32 products round by batch
            # size, so on the CPU, where shards gain nothing, one fits all
            mesh = Mesh(mesh.devices[:1])
        alt_ll = self._alt_loglik(Xb, ratios, mesh)
        llr = -2.0 * (self.null_loglik - alt_ll)
        llr = np.where(
            (np.abs(llr) < self.epsilon) | (llr < 0.0) | ~np.isfinite(alt_ll),
            0.0,
            llr,
        )
        block.pvalues[:] = chi2_sf1(llr)

    def _alt_loglik(self, Xb: np.ndarray, ratios: np.ndarray,
                    mesh) -> np.ndarray:
        """The alt fits' log-likelihoods, [B] f64: one K-IRLS launch a shard
        of the mesh (parallel.mesh.Mesh) over contiguous item ranges,
        concatenated in order (kmdiff_tpu/pipeline/popstrat.py:520-540,
        which shards the hits axis)."""
        def fit(rows: np.ndarray, dev: torch.device) -> np.ndarray:
            _w, _err, _it, ll, _stop = irls(
                self._tensor(Xb[None], dev), self._tensor(rows, dev),
                self._tensor(self.Y, dev), self.max_iteration)
            return ll.cpu().numpy().astype(np.float64)

        blocks = mesh.blocks(len(ratios))
        return np.concatenate(mesh.map(
            lambda d, dev: fit(ratios[slice(*blocks[d])], dev), len(blocks)))


#: persisted null-fit artifact, read back by load_corrector
NULL_FIT_FILE = "null_fit.npz"


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


def correct_partition(corr: PopStratCorrector, acc, pacc) -> None:
    """Drain one partition's uncorrected hits through the batched device
    IRLS into the popstrat accumulator (the per-partition unit of work the
    reference schedules on its thread pool, popstrat.hpp:212-238)."""
    for block in acc.blocks():
        corr.correct_block(block)
        pacc.push_block(block)
    pacc.finish()
    acc.destroy()


_PART_DONE = object()


def correct_partitions_pipelined(corr: PopStratCorrector, pairs,
                                 *, depth: int = 2) -> None:
    """Drain every (acc -> pacc) pair with the spill reads overlapped
    against the device fits: a prefetch thread LZ4-decodes the next
    block(s) while the batched IRLS corrects the current one. The
    reference hides this IO by running one CPU fit-loop per partition
    thread (popstrat.hpp:212-238); here the device is the parallel axis,
    so one bounded-queue reader suffices. Output order — and therefore
    every downstream byte — is identical to the serial drain."""
    import queue

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _reader():
        try:
            for i, (acc, _pacc) in enumerate(pairs):
                for block in acc.blocks():
                    _put(q, (i, block), stop)
                _put(q, (i, _PART_DONE), stop)
            _put(q, None, stop)
        except BaseException as e:  # re-raised by the consumer
            _put(q, e, stop)

    t = threading.Thread(target=_reader, name="popstrat-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            i, block = item
            acc, pacc = pairs[i]
            if block is _PART_DONE:
                pacc.finish()
                acc.destroy()
            else:
                corr.correct_block(block)
                pacc.push_block(block)
    finally:
        stop.set()
        t.join()


def _put(q, item, stop: threading.Event) -> None:
    """Bounded put that gives up when the consumer died."""
    import queue

    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return
        except queue.Full:
            continue


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
            from kmdiff_tpu_torch.io.accumulator import VectorAccumulator

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


def _read_geno(path: str, nb_samples: int) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if vals:
                rows.append([int(v) for v in vals])
    if not rows:
        return np.zeros((0, nb_samples), np.uint8)
    return np.asarray(rows, dtype=np.uint8)
