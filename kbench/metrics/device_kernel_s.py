"""device_kernel_s: the card's kernel seconds in the profiled job, summed
over the kernels of its ``kb:job`` range (device_trace): the compute a job
costs the card. Copies and memsets are left out: the copies from pageable
host memory are paced by the host and move with its load from run to run."""


def read(ctx: dict):
    tr = ctx["trace"]
    secs = sum(tr["kernel_s"].values()) if tr is not None else 0.0
    return secs if secs > 0 else None
