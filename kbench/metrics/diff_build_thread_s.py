"""diff_build_thread_s: diff's build of each merge chunk's int64 keys and
packed counts on the host, in thread-seconds (the command's
timings["build_thread_s"]: its ``kmd:build`` spans summed over every thread,
kmdiff_tpu_torch.profiling.span), the mean over the window's jobs, which run
without the profiler; nothing where the jobs have no such key."""


def read(ctx: dict):
    secs = [j["phases"]["build_thread_s"] for j in ctx["jobs"]
            if "build_thread_s" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
