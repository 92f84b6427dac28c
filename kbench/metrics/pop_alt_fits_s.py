"""pop_alt_fits_s: popstrat's alt fits in wall seconds (the command's
timings["alt_fits"]: every partition's survivors read back from their spill
and fitted by K-IRLS, one launch a block, then spilled again), the mean over
the window's jobs, which run without the profiler; nothing where the jobs
have no such key."""


def read(ctx: dict):
    secs = [j["phases"]["alt_fits"] for j in ctx["jobs"] if "alt_fits" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
