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
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from kmdiff_tpu_torch.utils.logging import logger

#: True while a command's trace runs (a process has one profiler)
active = False


def span(name: str):
    """A ``record_function`` range named `name` while a trace runs; a null
    context otherwise."""
    if not active:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


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
