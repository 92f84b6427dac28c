"""diff_decode_thread_s: diff's decode of each partition's count files (LZ4,
read_kmer_file) on the partition threads, in thread-seconds (the command's
timings["decode_thread_s"]: its ``kmd:decode`` spans summed over every
thread, kmdiff_tpu_torch.profiling.span), the mean over the window's jobs,
which run without the profiler; nothing where the jobs have no such key."""


def read(ctx: dict):
    secs = [j["phases"]["decode_thread_s"] for j in ctx["jobs"]
            if "decode_thread_s" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
