"""Multiple-testing correction rules.

Reference: src/corrector.cpp:1-118, include/kmdiff/corrector.hpp,
include/kmdiff/icorrector.hpp. Scalar classes replicate the reference's
stateful semantics exactly (Benjamini's rank only advances on acceptance;
Holm's denominator decrements on every call); vectorized prefix forms for
sorted p-value arrays live in ops.correct and are proven equivalent by
the JAX package's tests.
"""

from __future__ import annotations

import enum


class CorrectionType(enum.IntEnum):
    """Order matches the reference enum (serialized into options.bin)."""

    NOTHING = 0
    BONFERRONI = 1
    BENJAMINI = 2
    HOLM = 3
    SIDAK = 4


_STR = {
    CorrectionType.NOTHING: "disabled",
    CorrectionType.BONFERRONI: "bonferroni",
    CorrectionType.BENJAMINI: "benjamini",
    CorrectionType.HOLM: "holm",
    CorrectionType.SIDAK: "sidak",
}


def correction_type_str(t: CorrectionType) -> str:
    return _STR[CorrectionType(t)]


def correction_type_from_str(s: str) -> CorrectionType:
    for t, name in _STR.items():
        if name == s:
            return t
    if s == "disabled":
        return CorrectionType.NOTHING
    raise ValueError(f"unknown correction: {s}")


class ICorrector:
    #: True when acceptance depends on ascending-p processing order
    #: (drives aggregator choice, reference: aggregator.hpp:343-365)
    order_dependent = False

    def apply(self, pvalue: float) -> bool:
        raise NotImplementedError

    def type(self) -> CorrectionType:
        raise NotImplementedError

class Bonferroni(ICorrector):
    """p < alpha / N (reference: src/corrector.cpp:9-12)."""

    def __init__(self, threshold: float, total: int):
        self.threshold = threshold
        self.total = total

    def apply(self, pvalue: float) -> bool:
        return pvalue < (self.threshold / self.total)

    def type(self):
        return CorrectionType.BONFERRONI


class Benjamini(ICorrector):
    """Sequential Benjamini-Hochberg walk: rank starts at 1 and advances
    only on acceptance; the sorted aggregator stops at the first rejection
    (reference: src/corrector.cpp:24-35 + aggregator.hpp:286-310)."""

    order_dependent = True

    def __init__(self, fdr: float, total: int):
        self.fdr = fdr
        self.total = total
        self.rank = 1

    def apply(self, pvalue: float) -> bool:
        if pvalue < (self.rank / self.total) * self.fdr:
            self.rank += 1
            return True
        return False

    def type(self):
        return CorrectionType.BENJAMINI


class Sidak(ICorrector):
    """p < 1 - (1-alpha)^(1/N) (reference: src/corrector.cpp:50-53)."""

    def __init__(self, threshold: float, total: int):
        self.threshold = threshold
        self.total = total

    def apply(self, pvalue: float) -> bool:
        return pvalue < (1.0 - (1.0 - self.threshold) ** (1.0 / self.total))

    def type(self):
        return CorrectionType.SIDAK


class Holm(ICorrector):
    """p < alpha / N--, N decrementing on every call; with ascending-p
    processing + stop-at-first-rejection this is Holm step-down
    (reference: src/corrector.cpp:68-71)."""

    order_dependent = True

    def __init__(self, threshold: float, total: int):
        self.threshold = threshold
        self.total = total

    def apply(self, pvalue: float) -> bool:
        keep = pvalue < (self.threshold / self.total)
        self.total -= 1
        return keep

    def type(self):
        return CorrectionType.HOLM


class BasicThreshold(ICorrector):
    """p < alpha, no correction (reference: src/corrector.cpp:86-89)."""

    def __init__(self, threshold: float):
        self.threshold = threshold

    def apply(self, pvalue: float) -> bool:
        return pvalue < self.threshold

    def type(self):
        return CorrectionType.NOTHING


def make_corrector(
    ctype: CorrectionType, threshold: float, total_kmers: int
) -> ICorrector:
    """Factory (reference: src/corrector.cpp:101-116)."""
    ctype = CorrectionType(ctype)
    if ctype == CorrectionType.BONFERRONI:
        return Bonferroni(threshold, total_kmers)
    if ctype == CorrectionType.SIDAK:
        return Sidak(threshold, total_kmers)
    if ctype == CorrectionType.BENJAMINI:
        return Benjamini(threshold, total_kmers)
    if ctype == CorrectionType.HOLM:
        return Holm(threshold, total_kmers)
    return BasicThreshold(threshold)
