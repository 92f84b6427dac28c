"""Vectorized multiple-testing correction over sorted p-value arrays.

The reference's order-dependent correctors (Benjamini, Holm) run as a
sequential walk over a global priority queue with stop-at-first-rejection
(reference: aggregator.hpp:240-322 + src/corrector.cpp:24-35,68-71). Over a
sorted ascending p array that walk reduces to a prefix predicate, which
vectorizes: keep[i] = all_{j<=i} pass[j], i.e. a cumulative AND — a device
sort + scan instead of a spinlocked heap.

Equivalence with the scalar classes in core.corrector is covered by tests.
"""

from __future__ import annotations

import numpy as np

from kmdiff_tpu_torch.core.corrector import CorrectionType


def threshold_at_rank(ctype: CorrectionType, threshold: float, total: int, rank):
    """THE single definition of every corrector's acceptance boundary: a
    p-value at 0-based acceptance `rank` passes iff p < this value
    (reference: src/corrector.cpp:9-89; strict `<` on all paths). `rank`
    may be a scalar or an ndarray — order-free correctors ignore it."""
    ctype = CorrectionType(ctype)
    if ctype == CorrectionType.BONFERRONI:
        return threshold / total
    if ctype == CorrectionType.SIDAK:
        return 1.0 - (1.0 - threshold) ** (1.0 / total)
    if ctype == CorrectionType.NOTHING:
        return threshold
    if ctype == CorrectionType.BENJAMINI:
        # rank advances only on acceptance; before the first rejection,
        # rank_i == i+1; the walk stops there, so the mask is the prefix
        return ((np.asarray(rank, dtype=np.float64) + 1.0) / total) * threshold
    if ctype == CorrectionType.HOLM:
        # denominator decrements per call: call i uses total - i
        return threshold / (total - np.asarray(rank, dtype=np.float64))
    raise ValueError(ctype)


def correction_mask_sorted(
    p_sorted: np.ndarray, ctype: CorrectionType, threshold: float, total: int
) -> np.ndarray:
    """Keep-mask over ascending-sorted p-values, replicating the reference
    aggregation semantics for every corrector type."""
    ctype = CorrectionType(ctype)
    n = len(p_sorted)
    if n == 0:
        return np.zeros(0, dtype=bool)
    bound = threshold_at_rank(ctype, threshold, total, np.arange(n))
    passes = p_sorted < bound
    if ctype in (CorrectionType.BENJAMINI, CorrectionType.HOLM):
        return np.cumprod(passes).astype(bool)
    return passes

