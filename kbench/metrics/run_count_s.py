"""run_count_s: the fused count's wall seconds (main_run's
timings["count"]: FASTA parse, each sample's device count, histograms),
the mean over the window's jobs, which run without the profiler; nothing
where the jobs have no count phase."""


def read(ctx: dict):
    walls = [j["phases"]["count"] for j in ctx["jobs"] if "count" in j["phases"]]
    return sum(walls) / len(walls) if walls else None
