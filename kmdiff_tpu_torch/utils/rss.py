"""Peak RSS reporting (reference: src/utils.cpp:196-229)."""

import resource


def get_peak_rss() -> int:
    """Peak resident set size in KiB (as getrusage reports on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def get_peak_rss_mb() -> int:
    """Peak RSS in MB as the reference reports it at exit
    (diff.hpp:372-376: KiB * 0.0009765625)."""
    return int(get_peak_rss() * 0.0009765625)

