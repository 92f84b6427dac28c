"""setup_s: seconds from the process's start to the window: imports, the
card's start, the kernel and native libraries (built on a checkout's first
run), the cohort written from the seed, and the warm-up job."""


def read(ctx: dict):
    return ctx["setup_s"]
