"""run_merge_s: the fused merge's wall seconds (main_run's
timings["merge"]: chunk plan, K-ASM, merge, K-LRT, f64 rescore), the mean
over the window's jobs, which run without the profiler; nothing where the
jobs have no merge phase."""


def read(ctx: dict):
    walls = [j["phases"]["merge"] for j in ctx["jobs"] if "merge" in j["phases"]]
    return sum(walls) / len(walls) if walls else None
