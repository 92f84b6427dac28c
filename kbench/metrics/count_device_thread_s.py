"""count_device_thread_s: the fused count's device count of each sample
(chunking, K-EXT, the sort, K-RUN, dedup_sum, K-HIST, hard-min and the tight
copies, with the waits for the card; the copies of the codes left out), in
thread-seconds (the command's timings["count_thread_s"]: its ``kmd:count``
spans summed over every thread, kmdiff_tpu_torch.profiling.span), the mean
over the window's jobs, which run without the profiler; nothing where the
jobs have no such key."""


def read(ctx: dict):
    secs = [j["phases"]["count_thread_s"] for j in ctx["jobs"]
            if "count_thread_s" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
