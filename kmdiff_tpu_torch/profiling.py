"""``--profile DIR``: a torch.profiler trace of one command (the port's
counterpart of the JAX CLI's ``jax.profiler.trace``, kmdiff_tpu/cli.py:299-305).

``trace(directory, device, worker)`` runs the command under
``torch.profiler.profile`` with the CPU activity, and the CUDA activity when
the command's device is a card, and writes one Chrome trace,
``DIR/<worker>.<ns>.pt.trace.json``: the CLI names the worker ``rank<r>``
under --distributed (one file a rank) and ``process`` otherwise.

Most of the port's work runs on worker threads (a partition, a sample or a
mesh shard a thread, and ``run``'s spills), which torch.profiler records only
with ``profile_all_threads``; the trace passes it. While a trace runs
(``active``), each hand-written kernel's launch is a ``kmd:<kernel>`` range
on the CPU side (kernels.launch: ctypes calls are no torch op, so the
trace would show their device time alone) and each shard of a mesh's work a
``kmd:shard<d>`` range on its thread (parallel.mesh.Mesh.map). Without a
trace, ``active`` is False and nothing else is done.

``span(name)`` is the port's one span of its own host work (a sample's
parse, copy and count in ``run``, a partition's stages in ``diff``, a merge
chunk). While a trace runs it is a ``record_function`` range, on the same
clock as the card's activity in the trace. While a command collects
(``collect(timings)``: main_run and main_diff, given timings), it also adds
its wall seconds to ``timings["<name without kmd:>_thread_s"]``, summed over
every thread that opens it. Kernel launches and mesh shards open trace-only
ranges (``timed=False``). With neither a trace nor a collector a span is a
null context. ``tally(name, n)`` adds an integer count to a collecting
command's timings (the fused run's files decoded, ``parse_files``, and those
that took the host record parser, ``parse_fallback_files``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from kmdiff_tpu_torch.utils.logging import logger

#: True while a command's trace runs (a process has one profiler)
active = False

#: the timings that spans add to while a command collects (a process runs
#: one command at a time; the sample, partition and shard threads it starts
#: inherit no context variable, so the collector is process-wide)
_sink: dict | None = None
_sink_lock = threading.Lock()


def span(name: str, timed: bool = True):
    """A ``record_function`` range named `name` while a trace runs; and,
    when `timed` and a command collects, its wall seconds added to the
    command's timings under ``<name without kmd:>_thread_s``. A null context
    with neither."""
    sink = _sink if timed else None
    if sink is None:
        if not active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)
    return _timed_span(name, sink)


@contextlib.contextmanager
def _timed_span(name: str, sink: dict):
    key = name.removeprefix("kmd:") + "_thread_s"
    t0 = time.perf_counter()
    try:
        with (torch.profiler.record_function(name) if active
              else contextlib.nullcontext()):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _sink_lock:
            sink[key] = sink.get(key, 0.0) + dt


def tally(name: str, n: int = 1) -> None:
    """While a command collects, add n to its ``timings[name]`` (an integer
    count, created at 0 by the first tally: a tally of 0 shows that the
    path ran); nothing otherwise."""
    sink = _sink
    if sink is not None:
        with _sink_lock:
            sink[name] = sink.get(name, 0) + n


@contextlib.contextmanager
def collect(timings: dict | None):
    """While the block runs, every timed span adds its wall seconds to
    `timings` (span); nothing for None. The collector in place before is
    restored after the block."""
    global _sink
    if timings is None:
        yield
        return
    outer, _sink = _sink, timings
    try:
        yield
    finally:
        _sink = outer


@contextlib.contextmanager
def trace(directory: str, device: torch.device, worker: str = "process"):
    """Profile the block into a Chrome trace in `directory` (no-op for an
    empty one)."""
    global active
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{worker}.{time.time_ns()}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=activities,
                                  experimental_config=config)
    prof.start()
    active = True
    try:
        yield
    finally:
        active = False
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("profile: trace written to %s", path)
