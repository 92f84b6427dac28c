"""Poisson likelihood-ratio filter (port of kmdiff_tpu/ops/lrt.py).

  LR(sC, sK) = sC*log(sC/(tot*rc)) + sK*log(sK/(tot*rk)),  0*log(0) := 0

with tot = sC + sK and rc, rk the cohort's control and case mass ratios.
p <= t  <=>  LR >= erfcinv(t)^2, so the filter is one f32 comparison
against a host constant; the f32 LR carries a per-row margin and the small
survivor set is rescored exactly in f64 on the host
(core.model), so final sets match kmdiff.

``lrt_block`` and ``lrt_filter_block`` are the plain PyTorch forms: they
are the CPU path and the twin that the K-LRT kernel
(``ops.lrt_kernel``) is held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import erfcinv


def lr_threshold_for_pvalue(p_threshold: float) -> float:
    """LR cut such that p <= p_threshold <=> LR >= cut (host, f64)."""
    if p_threshold >= 1.0:
        return 0.0
    if p_threshold <= 0.0:
        return float("inf")
    return float(erfcinv(p_threshold) ** 2)


# Per-row f32 error bound: the LR's absolute rounding error grows with the
# row's total count, so the cut is lowered by MARGIN_PER_COUNT*(sC+sK) +
# MARGIN_ABS (the same constants as the JAX package and the CUDA kernel).
MARGIN_PER_COUNT = 4e-6
MARGIN_ABS = 1e-3


class LrtParams:
    """Host-precomputed scalars binding a cohort to the filter; built from
    the same totals as kmdiff_tpu.ops.lrt.LrtParams, bit for bit."""

    def __init__(self, nb_controls: int, nb_cases: int, sum_controls: int,
                 sum_cases: int, p_threshold: float):
        self.nb_controls = nb_controls
        self.nb_cases = nb_cases
        self.sum_controls = int(sum_controls)
        self.sum_cases = int(sum_cases)
        tsum = self.sum_controls + self.sum_cases
        self.ratio_c = np.float32(self.sum_controls / tsum)
        self.ratio_k = np.float32(self.sum_cases / tsum)
        self.p_threshold = p_threshold
        self.lr_min = lr_threshold_for_pvalue(p_threshold)
        # a k-mer's group sum is bounded by the cohort's whole k-mer mass:
        # below 2^31 the packed merge's int32 sums are exact; at or above
        # it the merges take the full branch, whose group sums are int64
        # (K-RUN's full form, K-LRT's int64 form), and prebuilt matrices
        # are scored in int64 on the host
        self.wide_sums = tsum >= 2**31


def _lr_from_sums(s_c: torch.Tensor, s_k: torch.Tensor, ratio_c, ratio_k):
    fc = s_c.to(torch.float32)
    fk = s_k.to(torch.float32)
    rc = torch.tensor(np.float32(ratio_c), device=fc.device)
    rk = torch.tensor(np.float32(ratio_k), device=fc.device)
    tot = fc + fk
    safe_tot = torch.clamp(tot, min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=fc.device)
    term_c = torch.where(
        s_c > 0, fc * torch.log(torch.clamp(fc, min=1.0) / (safe_tot * rc)), zero
    )
    term_k = torch.where(
        s_k > 0, fk * torch.log(torch.clamp(fk, min=1.0) / (safe_tot * rk)), zero
    )
    lr = torch.where(tot > 0, term_c + term_k, zero)
    return torch.clamp(lr, min=0.0)


def lrt_block(counts: torch.Tensor, nb_controls: int, ratio_c, ratio_k):
    """counts [B, S] int32 or int64 (controls first) -> (lr [B] f32, s_c,
    s_k [B] of the counts' type)."""
    s_c = counts[:, :nb_controls].sum(dim=1, dtype=counts.dtype)
    s_k = counts[:, nb_controls:].sum(dim=1, dtype=counts.dtype)
    return _lr_from_sums(s_c, s_k, ratio_c, ratio_k), s_c, s_k


def lrt_filter_block(counts: torch.Tensor, nb_controls: int, ratio_c, ratio_k,
                     lr_min):
    """LR plus the margin-backed keep mask:
        keep <=> lr + MARGIN_PER_COUNT*tot + MARGIN_ABS >= lr_min
    returns (keep [B] bool, lr [B] f32, s_c [B], s_k [B]), the sums of the
    counts' type. int32 counts take tot = f32(s_c + s_k), the JAX package's
    matrix filter; int64 counts (the wide merge's [U, 2] group sums) take
    tot = f32(s_c) + f32(s_k), its wide merge's (merge_dev.py:256-265),
    whose f32(hi) * 65536 + f32(lo) is the correctly rounded f32 of each
    sum while a half-sum stays below 2^24 (S <= 256)."""
    lr, s_c, s_k = lrt_block(counts, nb_controls, ratio_c, ratio_k)
    if counts.dtype == torch.int64:
        tot = s_c.to(torch.float32) + s_k.to(torch.float32)
    else:
        tot = (s_c + s_k).to(torch.float32)
    cut = torch.tensor(np.float32(lr_min), device=lr.device)
    keep = lr + MARGIN_PER_COUNT * tot + MARGIN_ABS >= cut
    return keep, lr, s_c, s_k


def run_filter(params: LrtParams, counts, device: torch.device):
    """Filter one [B, S] block on `device` through K-LRT (its plain twin on
    the CPU); returns numpy (keep, s_c, s_k): no lr, which no caller
    reads."""
    from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter

    c = torch.as_tensor(np.ascontiguousarray(counts).view(np.int32)
                        if counts.dtype == np.uint32 else counts)
    c = c.to(device=device, dtype=torch.int32).contiguous()
    keep, _lr, s_c, s_k = lrt_filter(c, params.nb_controls, params.ratio_c,
                                     params.ratio_k, params.lr_min, want_lr=False)
    return keep.cpu().numpy(), s_c.cpu().numpy(), s_k.cpu().numpy()
