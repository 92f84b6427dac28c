"""pop_kernel_s: the device seconds of popstrat's kernels in the profiled
job (device_trace): K-GENO (both forms), K-ROWS (the survivors' count rows
and the geno rows), K-GRAM and K-IRLS, by their K-names (kbench.knames);
nothing where none ran."""

KERNELS = ("K-GENO", "K-GENO-mw", "K-ROWS", "K-GRAM", "K-IRLS")


def read(ctx: dict):
    tr = ctx["trace"]
    secs = sum(tr["kernel_s"].get(k, 0.0) for k in KERNELS) if tr is not None else 0.0
    return secs if secs > 0 else None
