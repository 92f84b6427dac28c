"""Reduce a torch.profiler Chrome trace of one job to the card's busy time,
its time by kernel and the idle gaps, each gap named by what the host had
open in its middle: the innermost of the port's own ranges (``kmd:<kernel>``,
kmdiff_tpu_torch.profiling) and torch operators on each thread.

The card's activity is the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; busy time is the union of their intervals
(kmdiff_tpu_torch/tools/trace_walls.py::busy, copied). The job is the
``kb:job`` range the harness opens around it; every interval is clipped to
it.
"""

from __future__ import annotations

import collections
import json

from kbench import knames

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
JOB_RANGE = "kb:job"


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_name(ranges: dict, t: float) -> str:
    """The innermost host range or operator open at t on each thread,
    joined by '+'; "host" where none is (the port's own host code, such as
    the FASTA parse, opens none)."""
    names = set()
    for spans in ranges.values():
        inner = None
        for a, b, name in spans:
            if a <= t <= b and (inner is None or b - a < inner[1] - inner[0]):
                inner = (a, b, name)
        if inner is not None:
            names.add(inner[2])
    return "+".join(sorted(names)) or "host"


def reduce(path: str, top: int = 10) -> dict:
    """-> {"busy_s", "span_s", "kernel_s": {name: s}, "device_ops":
    [[name, s]] (top), "idle_gaps": [[name, s]] (top)}; times in seconds.
    Raises when the trace has no ``kb:job`` range."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    jobs = [e for e in events if e.get("name") == JOB_RANGE]
    if not jobs:
        raise ValueError(f"{path}: no {JOB_RANGE} range")
    t0 = jobs[0]["ts"]
    t1 = t0 + jobs[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    clipped = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev]
    busy = _union([c for c in clipped if c[1] > c[0]])
    by_op: dict[str, float] = collections.Counter()
    kernel_s: dict[str, float] = collections.Counter()
    for e, (a, b) in zip(dev, clipped):
        if b <= a:
            continue
        name = knames.name(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_op[name] += (b - a) / 1e6
        if e["cat"] == "kernel":
            kernel_s[name] += (b - a) / 1e6
    ranges: dict = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in HOST_CATS and e["name"] != JOB_RANGE:
            ranges[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)[:top]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "span_s": (t1 - t0) / 1e6,
        "kernel_s": dict(kernel_s),
        "device_ops": [[n, s] for n, s in by_op.most_common(top)],
        "idle_gaps": [[_host_name(ranges, (a + b) / 2), d / 1e6] for d, a, b in gaps],
    }
