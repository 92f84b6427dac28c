"""device_idle_pct: the share of the profiled job's span in which nothing
ran on the card (100 minus the union of its kernels', copies' and memsets'
intervals over the ``kb:job`` range), in %."""


def read(ctx: dict):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
