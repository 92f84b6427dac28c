"""The bytes a kernel needs for one call, from its shapes: the numerator of
its roofline share (each input byte read once, each output byte written
once)."""

from __future__ import annotations


def kext_bytes(codes: int, k: int) -> int:
    """K-EXT (kmdiff_tpu_torch/csrc/canonical_kmers.cu): reads one 2-bit code
    a byte and writes one key of ceil(k / 32) int64 words a window, about
    one window a code."""
    return codes * (1 + 8 * ((k + 31) // 32))
