"""count_h2d_thread_s: the fused count's copies of each chunk's codes to the
card (pageable, on the stream the sample threads share, so a copy's wait
behind other samples' work is in it), in thread-seconds (the command's
timings["h2d_thread_s"]: its ``kmd:h2d`` spans summed over every thread,
kmdiff_tpu_torch.profiling.span), the mean over the window's jobs, which run
without the profiler; nothing where the jobs have no such key."""


def read(ctx: dict):
    secs = [j["phases"]["h2d_thread_s"] for j in ctx["jobs"]
            if "h2d_thread_s" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
