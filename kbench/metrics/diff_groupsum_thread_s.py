"""diff_groupsum_thread_s: diff's host group pre-sum of each partition's
streams into one control and one case stream, in thread-seconds (the
command's timings["groupsum_thread_s"]: its ``kmd:groupsum`` spans summed
over every thread, kmdiff_tpu_torch.profiling.span), the mean over the
window's jobs, which run without the profiler; nothing where the jobs have
no such key."""


def read(ctx: dict):
    secs = [j["phases"]["groupsum_thread_s"] for j in ctx["jobs"]
            if "groupsum_thread_s" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
