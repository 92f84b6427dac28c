"""job_s: the window's wall seconds over the whole jobs it completed (host
clock; the window ends when its last job does): the job's wall as its user
sees it, one job at a time."""


def read(ctx: dict):
    return ctx["window_s"] / len(ctx["jobs"]) if ctx["jobs"] else None
