"""diff_device_thread_s: diff's device merge of each chunk, in thread-seconds:
the chunk's copies to the card and its merge there (the sort, K-RUN, K-LRT,
K-CMP and the survivors' way back, waits included): the command's
timings["h2d_thread_s"] + timings["device_thread_s"], its ``kmd:h2d`` and
``kmd:device`` spans summed over every thread
(kmdiff_tpu_torch.profiling.span), the mean over the window's jobs, which
run without the profiler; nothing where the jobs have no such keys."""

KEYS = ("h2d_thread_s", "device_thread_s")


def read(ctx: dict):
    secs = [sum(j["phases"][k] for k in KEYS) for j in ctx["jobs"]
            if all(k in j["phases"] for k in KEYS)]
    return sum(secs) / len(secs) if secs else None
