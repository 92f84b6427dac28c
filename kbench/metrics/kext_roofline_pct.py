"""kext_roofline_pct: K-EXT's share of its bytes roofline in the profiled
job: the least time its bytes need at the HBM peak (kbench.rooflines,
the codes counted from the benchmark's own reads) over the device time of
its launches (one-word and multi-word forms), in %."""

from kbench import peaks, rooflines


def read(ctx: dict):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs = tr["kernel_s"].get("K-EXT", 0.0) + tr["kernel_s"].get("K-EXT-mw", 0.0)
    if secs <= 0:
        return None
    least = rooflines.kext_bytes(ctx["codes"], ctx["k"]) / peaks.HBM_BYTES_S
    return 100.0 * least / secs
