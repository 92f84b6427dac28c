"""count_parse_thread_s: the fused count's FASTA parse (flat_codes, a file at a
time on the sample threads), in thread-seconds (the command's
timings["parse_thread_s"]: its ``kmd:parse`` spans summed over every thread,
kmdiff_tpu_torch.profiling.span), the mean over the window's jobs, which run
without the profiler; nothing where the jobs have no such key."""


def read(ctx: dict):
    secs = [j["phases"]["parse_thread_s"] for j in ctx["jobs"]
            if "parse_thread_s" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
