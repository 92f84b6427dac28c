"""K-RUN and K-ASM times of one or two checkouts of kmdiff_tpu_torch, at
chip_smoke.py phase 2's shapes, with where a call's host time goes.

Run on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/run_asm_times.py --root DIR
    python3 kmdiff_tpu_torch/tools/run_asm_times.py --paired OTHER_DIR

The two forms are tools/paired_runs.py's: one checkout's JSON line, or
four in turns with another checkout's and a table.

Inputs and timers are this checkout's chip_smoke.py's (run_inputs,
assemble_plan, median_ms, events_ms). Calls, in the forms the main path
makes them: codec.run_encode's count form on 2^23 sorted keys (random
k-mers, eight runs of 2*10^4 copies, a 5,000-row sentinel tail) without
starts, as sort_rle calls it; its merge form on 2^23 rows with int16 packed
counts through the sort's permutation without starts, as merge_dev.merge_lrt
calls it; a chunk of a fused.ChunkTable built beforehand, 20 streams into a
15,488,474-row chunk in p16, p32 and p32 with sample ids. Every result is
checked against the plain twins first. Each call is reported as: the median
whole call (CUDA events around one call, 15 after 3 warm-ups), CUDA events
around 20 calls queued back to back over 20, the device time of a call
from torch.profiler (every device operation, and the kernels of the timed
kernel's own name alone), and "host": one torch.profiler trace of 20 calls
with CPU and CUDA activities, each call inside a record_function span,
split into mean microseconds a call (host_split); and "wrapper_us", the
host cost of a wrapper's pieces alone (wrapper_parts).
"""

from __future__ import annotations

import json
import os
import sys

import paired_runs

_DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def _profile(fn, kernel: str, reps: int = 10) -> tuple[float, float]:
    """Device ms a call of fn: (every device operation, the kernels whose
    name holds `kernel`), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device time")
    every = sum(e.time_range.elapsed_us() for e in events)
    own = sum(e.time_range.elapsed_us() for e in events if kernel in e.name)
    return every / reps / 1e3, own / reps / 1e3


def _union(spans) -> float:
    """Length of the union of (start, end) spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def host_split(fn, trace_path: str, reps: int = 20) -> dict:
    """Mean microseconds a call of fn (which waits for its device work),
    from one torch.profiler trace (CPU and CUDA activities) of reps calls,
    each in a record_function span: call (the span), torch_ops (time inside
    aten operators), runtime_<name> (each CUDA runtime or driver call, as
    the trace names it), other_host (the span outside both: the Python
    wrapper, ctypes, argument checks and the profiler's own span),
    device (device operations' time), before_device (span start to the
    first device operation's start), after_device (the last device
    operation's end to span end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            with record_function("kmd_timed_call"):
                fn()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e["name"] == "kmd_timed_call" and e.get("cat") == "user_annotation")
    if len(calls) != reps:
        raise AssertionError(f"trace holds {len(calls)} timed calls, not {reps}")
    sums: dict[str, float] = {}

    def add(key, us):
        sums[key] = sums.get(key, 0.0) + us

    for a, b in calls:
        inside = [e for e in events if a <= e["ts"] < b]
        ops = [(e["ts"], e["ts"] + e["dur"]) for e in inside if e.get("cat") == "cpu_op"]
        rts = [e for e in inside if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        dev = [(e["ts"], e["ts"] + e["dur"]) for e in inside
               if e.get("cat") in _DEVICE_CATS]
        add("call", b - a)
        add("torch_ops", _union(ops))
        for e in rts:
            add(f"runtime_{e['name']}", e["dur"])
        add("other_host", (b - a) - _union(ops + [(e["ts"], e["ts"] + e["dur"])
                                                  for e in rts]))
        add("device", sum(y - x for x, y in dev))
        if dev:
            add("before_device", min(x for x, _ in dev) - a)
            add("after_device", b - max(y for _, y in dev))
    return {k: round(v / reps, 2) for k, v in sums.items()}


def wrapper_parts(dev, n: int = 2000) -> dict:
    """Mean host microseconds of the pieces of a kernel wrapper such as
    codec.run_encode, each alone in a loop of n: a 2^24-row torch.empty
    (served by the caching allocator), one slice view, entering and leaving
    torch.cuda.device, one require_cuda_tensor check, the current stream's
    raw handle, and a ctypes call of kmd_run_encode with its 14 arguments
    and N = 0 (it returns at once, no CUDA call)."""
    import ctypes
    import time

    import torch

    from kmdiff_tpu_torch import kernels

    buf = torch.empty(1 << 24, dtype=torch.int64, device=dev)
    slot = ctypes.c_longlong(0)
    entry = kernels.lib().kmd_run_encode

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    parts = {
        "torch_empty": lambda: torch.empty(1 << 24, dtype=torch.int64, device=dev),
        "view": lambda: buf[5:1000],
        "device_ctx": device_ctx,
        "check": lambda: kernels.require_cuda_tensor("keys", buf, torch.int64),
        "stream_handle": lambda: torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()),
        "ctypes_call": lambda: entry(buf.data_ptr(), 0, 1, None, None, None, 0,
                                     None, buf.data_ptr(), None, buf.data_ptr(),
                                     buf.data_ptr(), ctypes.addressof(slot), None),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = round((time.perf_counter() - t0) / n * 1e6, 3)
    return out


def _same(name, a, b) -> None:
    import torch

    if a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel and plain twin differ")


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import kmdiff_tpu_torch
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec
    from kmdiff_tpu_torch.pipeline import fused

    if not kmdiff_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"kmdiff_tpu_torch came from {kmdiff_tpu_torch.__file__}")
    smoke = paired_runs.smoke()
    kernels.lib()
    dev = torch.device("cuda", 0)
    trace_dir = os.path.join(os.path.abspath(root), "build", "tools")
    os.makedirs(trace_dir, exist_ok=True)
    out = {"root": root, "wrapper_us": wrapper_parts(dev)}
    keys_s, mkeys_s, perm, mcount = smoke.run_inputs(dev, np.random.default_rng(7))

    def timed(name, call, kernel):
        every, own = _profile(call, kernel)
        out[name] = {"ms": smoke.median_ms(call), "queued_ms": smoke.events_ms(call),
                     "device_ms": every, "kernel_ms": own,
                     "host": host_split(call, os.path.join(trace_dir, f"{name}.json"))}

    for name, args in (("run_count", (keys_s, None, None, True)),
                       ("run_merge", (mkeys_s, perm, mcount, False))):
        def call(args=args):
            return codec.run_encode(*args, starts=False)

        for part, g, w in zip(("run keys", "n_valid", "third"), call()[1:],
                              codec.run_encode_plain(*args)[1:]):
            _same(f"K-RUN {name} {part}", g, w)
        timed(name, call, "run")

    S, U, starts, lens = smoke.assemble_plan()
    for name, pack16, top, ids in (("p16", True, 1 << 15, False),
                                   ("p32", False, 1 << 32, False),
                                   ("p32_ids", False, 1 << 31, True)):
        keys, counts = smoke._random_streams(dev, S, U, 3, top)
        table = fused.ChunkTable(keys, counts, starts, lens, 10)

        def call(pack16=pack16, ids=ids):
            return table.assemble(0, pack16, ids)

        for part, g, w in zip("kcs", call(), fused.assemble_chunk_plain(
                keys, counts, starts, lens, 10, pack16, ids)):
            _same(f"K-ASM {name} {part}", g, w)
        timed(f"asm_{name}", call, "assemble")
        del keys, counts, table
    return out


if __name__ == "__main__":
    paired_runs.main(__doc__, measure, __file__)
