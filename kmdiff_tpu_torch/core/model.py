"""Statistical models: the HAWK Poisson likelihood-ratio test.

Reference: include/kmdiff/model.hpp:94-192 (PoissonLikelihood) and
include/kmdiff/imodel.hpp:23-72 (IModel ABI). Per k-mer with per-group count
sums sC (controls) and sK (cases), and per-group total k-mer masses
Tc = sum(total_controls), Tk = sum(total_cases):

  mu   = (sC + sK) / (Tc + Tk)
  alt  = pp(sC, sC)    + pp(sK, sK)
  null = pp(sC, mu*Tc) + pp(sK, mu*Tk)
  pp(k, lam) = 0 if lam <= 0 else -lam + k*log(lam) - log(k!)
  LR   = max(alt - null, 0)
  p    = chi2_sf(2*LR, df=1)
  sign = CONTROL if sC*Tk/Tc > sK else CASE if < else NO

Key algebraic fact exploited by the device kernel (ops.lrt, K-LRT): the
log-factorial terms cancel between alt and null, and
mu*(Tc+Tk) == sC+sK, so  LR = sC*log(sC/(mu*Tc)) + sK*log(sK/(mu*Tk))
with the convention 0*log(0) = 0. The device computes this reduced form in
f32 for the bulk filter; this module provides the exact f64 scoring (same
operation order as the reference, including the log-factorial table and the
int truncation of sums in poisson_prob) used to re-score the small survivor
set so final p-values / signs match kmdiff.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
from scipy.stats import chi2 as _chi2


class Significance(enum.IntEnum):
    """Reference: include/kmdiff/kmer.hpp:33-53 (enum order matters: it is
    serialized as an int in spill files)."""

    CONTROL = 0
    CASE = 1
    NO = 2


class LogFactorialTable:
    """Precomputed log(k!) with on-the-fly fallback past the table
    (reference: include/kmdiff/log_factorial_table.hpp:9-26, default size
    10000, flag --log-factorial). Table built via cumulative sum of logs;
    fallback uses lgamma(k+1) (the reference's naive descending sum agrees
    to ~1e-12 relative — and the terms cancel exactly between alt and null
    hypotheses, so this has no observable effect on p-values)."""

    def __init__(self, size: int = 10000):
        self.size = max(2, int(size))
        self._table = np.concatenate(
            ([0.0], np.cumsum(np.log(np.arange(1, self.size, dtype=np.float64))))
        )

    def __getitem__(self, k):
        k = np.asarray(k, dtype=np.int64)
        import scipy.special as sps

        small = k < self.size
        out = np.where(
            small, self._table[np.minimum(k, self.size - 1)], sps.gammaln(k + 1.0)
        )
        return out if out.ndim else float(out)

def chi2_sf1(x):
    """Upper-tail chi-square survival, 1 dof — replaces
    alglib::chisquarecdistribution(1, x) (reference: model.hpp:162).
    scipy's implementation is the same cephes igamc double-precision code
    family alglib derives from."""
    return _chi2.sf(x, 1)


class IModel:
    """Model interface (reference: include/kmdiff/imodel.hpp). Custom models
    plug in via kmdiff_tpu_torch.plugins. The pipeline scores a custom
    model's [B, S] count rows through the first of these ABIs the model
    has:

      * `process_block_torch(counts, nb_controls)`: counts an int32 tensor
        of at most pipeline.merge.BLOCK_ROWS rows on the processor's device
        (u32 counts of 2^31 or more wrap negative); returns (p, sign,
        mean_control, mean_case) tensors on that device;
      * `process_block(counts, nb_controls)`: numpy, defined below as a
        loop over
      * `process(controls, cases)`: the scalar per-k-mer ABI.

    PoissonLikelihood takes the device merge and K-LRT instead."""

    def process(self, controls: np.ndarray, cases: np.ndarray):
        """-> (p_value, Significance, mean_control, mean_case)"""
        raise NotImplementedError

    def process_block(self, counts: np.ndarray, nb_controls: int):
        """counts [B, S] -> (p [B], sign [B], mean_control [B], mean_case [B])"""
        B = counts.shape[0]
        p = np.empty(B)
        sg = np.empty(B, dtype=np.int8)
        mc = np.empty(B)
        mk = np.empty(B)
        for i in range(B):
            p[i], sg[i], mc[i], mk[i] = self.process(
                counts[i, :nb_controls], counts[i, nb_controls:]
            )
        return p, sg, mc, mk


@dataclass
class PoissonLikelihood(IModel):
    """Exact (f64) HAWK Poisson LRT, vectorized over k-mer blocks."""

    nb_controls: int
    nb_cases: int
    total_controls: list
    total_cases: list
    log_size: int = 10000

    def __post_init__(self):
        self.sum_controls = int(np.sum(np.asarray(self.total_controls, dtype=object)))
        self.sum_cases = int(np.sum(np.asarray(self.total_cases, dtype=object)))
        self.lf = LogFactorialTable(self.log_size)

    # -- scalar path (plugin/parity ABI) ------------------------------------
    def process(self, controls: np.ndarray, cases: np.ndarray):
        p, sg, mc, mk = self.process_sums(
            np.asarray([int(np.sum(controls))]), np.asarray([int(np.sum(cases))])
        )
        return float(p[0]), Significance(int(sg[0])), float(mc[0]), float(mk[0])

    # -- vectorized path ----------------------------------------------------
    def process_block(self, counts: np.ndarray, nb_controls: int):
        counts = np.asarray(counts)
        s_c = counts[:, :nb_controls].sum(axis=1, dtype=np.int64)
        s_k = counts[:, nb_controls:].sum(axis=1, dtype=np.int64)
        return self.process_sums(s_c, s_k)

    def process_sums(self, s_c: np.ndarray, s_k: np.ndarray):
        """Score from per-group sums; replicates reference operation order
        (model.hpp:142-176) in f64."""
        s_c = np.asarray(s_c, dtype=np.int64)
        s_k = np.asarray(s_k, dtype=np.int64)
        Tc = float(self.sum_controls)
        Tk = float(self.sum_cases)
        mean = (s_c + s_k).astype(np.float64) / (self.sum_controls + self.sum_cases)

        lf_c = self.lf[s_c]
        lf_k = self.lf[s_k]

        def pp(k_int, k_float, lam, lf_val):
            # poisson_prob(int k, double lambda): 0 when lam <= 0
            with np.errstate(divide="ignore", invalid="ignore"):
                val = -lam + (k_float * np.log(lam) - lf_val)
            return np.where(lam > 0, val, 0.0)

        fc = s_c.astype(np.float64)
        fk = s_k.astype(np.float64)
        alt = pp(s_c, fc, fc, lf_c) + pp(s_k, fk, fk, lf_k)
        null = pp(s_c, fc, mean * Tc, lf_c) + pp(s_k, fk, mean * Tk, lf_k)
        lr = alt - null
        lr = np.where(lr < 0, 0.0, lr)
        p_value = chi2_sf1(2.0 * lr)

        # sign rule (model.hpp:164-173): compare sC*Tk/Tc against sK.
        # Computed exactly in integers (sub-ulp ties in the reference's
        # double division cannot flip a strict ordering here).
        lhs = s_c.astype(object) * self.sum_cases
        rhs = s_k.astype(object) * self.sum_controls
        sign = np.where(
            lhs < rhs,
            np.int8(Significance.CASE),
            np.where(lhs > rhs, np.int8(Significance.CONTROL), np.int8(Significance.NO)),
        )
        mean_control = fc * Tk / Tc
        mean_case = fk
        return p_value, sign, mean_control, mean_case
