"""The harness: one cell of BENCHMARK.json, run once.

    python3 -B -m kbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up: the card (no card, or fewer than the cell asks for: exit 2, no
   result), this process made a child subreaper (kbench.reaper), the
   port's kernel and native libraries (built into the checkout's
   build/kmdiff_tpu_torch/ on its first run; nvcc and make are waited for
   here), the cohort written from the seed (kbench.cohort) under a
   directory of its own in TMPDIR, the mix's set-up commands
   (kbench.traffic) and one warm-up job on it.
2. The window: jobs one after another (kbench.traffic), each in this
   process on fresh directories, a new one started while less than
   --seconds has passed; it ends when the job in flight does. The card's
   peak memory is reset before each job and read after it.
3. With --trace 1, one more job under torch.profiler (the port's
   profiling.trace): the per-layer device numbers and the breakdown; no
   wall is taken from it.
4. The plain reference (kbench.reference) counts the same reads once the
   program's state is freed, and every job's outputs are compared with it
   (kbench.compare), then deleted.
5. On every way out, every descendant process is ended (kbench.reaper);
   any that was left makes the run not correct. A run in which JAX, jaxlib,
   flax or the JAX package got imported exits 3 with no result.

The last line of standard output is the result (JSON); the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key, ``checks``.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time

KBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(KBENCH)
#: top-level module names that no run may load, compared whole
BANNED = ("jax", "jaxlib", "flax", "kmdiff_tpu")
#: the fewest significant k-mers the reference must find, or the comparison
#: says nothing
MIN_HITS = 100


def _start_age() -> float:
    """Seconds since this process started (its start time in /proc against
    CLOCK_BOOTTIME, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start / os.sysconf("SC_CLK_TCK")


def _log(msg: str) -> None:
    print(f"kbench: {msg}", file=sys.stderr, flush=True)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts: str) -> dict:
    with open(os.path.join(KBENCH, *parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones, or with
    trace its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(
        f"kbench_metric_{len(sys.modules)}", os.path.join(KBENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _power_limit_w() -> float | None:
    """The enforced power limit of card 0 in W, through NVML's C library in
    this process; None where NVML cannot be loaded."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        dev, mw = ctypes.c_void_p(), ctypes.c_uint()
        if (nvml.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(dev)) != 0
                or nvml.nvmlDeviceGetEnforcedPowerLimit(dev, ctypes.byref(mw)) != 0):
            return None
        return mw.value / 1000
    finally:
        nvml.nvmlShutdown()


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, config: dict | None = None, start_age=_start_age) -> dict:
    """Run cell `name` once on `device` (a CPU device runs the port's plain
    twins: the tests' path), under its configuration file or `config`;
    returns the result line's object."""
    import torch

    from kbench import cohort, compare, reference, traffic
    from kbench import trace as trace_mod
    from kmdiff_tpu_torch import kernels, native

    cell = next(w for w in bench["workloads"] if w["name"] == name)
    config = config or load_json("configs", f"{cell['config']}.json")
    mix = traffic.load(KBENCH, cell["traffic"])
    cuda = device.type == "cuda"
    scratch = tempfile.mkdtemp(prefix="kbench-", dir=tempfile.gettempdir())
    try:
        if cuda:
            torch.empty(0, device=device)  # the card's context and allocator
            kernels.lib()
        if not native.available():
            raise RuntimeError("the port's native library did not build: its "
                               "pure-Python fallback would change what is measured")
        co = cohort.make(config, seed, os.path.join(scratch, "cohort"))
        work = os.path.join(scratch, "jobs")
        setup_run_dir = traffic.setup(config, mix, co.fof, work, device)

        def job(i: int):
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            j = traffic.run_job(i, config, mix, co.fof, work, device, setup_run_dir)
            peaks.append(torch.cuda.max_memory_allocated(device) if cuda else 0)
            _log(f"job {i}: {j.wall_s:.3f} s, peak {peaks[-1]} B, phases "
                 f"{ {k: round(v, 3) for k, v in j.phases.items()} }"
                 + (" FELL BACK to count + diff" if j.fell_back else "")
                 + (f" FAILED\n{j.error}" if j.error else ""))
            return j

        def ok(j) -> bool:
            return not (j.error or j.fell_back)

        peaks: list[int] = []
        jobs = [job(0)]
        power = _power_limit_w() if cuda else None
        setup_s = start_age()
        t0 = time.perf_counter()
        window = []
        while time.perf_counter() - t0 < seconds and ok(jobs[-1]):
            window.append(job(len(jobs)))
            jobs.append(window[-1])
        window_s = time.perf_counter() - t0
        # the peak over the window: each job's own, reset before it
        peak = max(peaks[1:], default=0)
        _log(f"window {window_s:.3f} s, {len(window)} jobs; setup {setup_s:.3f} s; "
             f"peak {peak} B; power limit {power} W")

        # with --trace 1, one more job under the profiler: the per-layer
        # device numbers; no wall is taken from it
        tr = None
        if trace and ok(jobs[-1]):
            from kmdiff_tpu_torch import profiling

            prof_dir = os.path.join(scratch, "trace")
            with profiling.trace(prof_dir, device):
                with torch.profiler.record_function(trace_mod.JOB_RANGE):
                    jobs.append(job(len(jobs)))
            (path,) = os.listdir(prof_dir)
            tr = trace_mod.reduce(os.path.join(prof_dir, path))
            shutil.rmtree(prof_dir)
            _log(f"profiled job: busy {tr['busy_s']:.4f} s of {tr['span_s']:.3f} s; "
                 f"kernels {tr['kernel_s']}")

        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        counts = reference.count_cohort(co, config["kmer_size"], config["hard_min"], device)
        want = reference.expected(counts, config)
        reference.free(counts)
        numbers, failed = [], 0
        for j in jobs:
            got = compare.compare_job(j.run_dir, j.out_dir, co.ids,
                                      (j.result or {}).get("total_kmers"), want)
            j.remove()
            failed += bool(compare.failures(got)) or not ok(j)
            numbers.append(got)
        _log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s; "
             f"{want.n_tested} k-mers tested, {len(want.records)} significant")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    checks = {k: {"value": v, "limit": compare.LIMITS[k]}
              for k, v in compare.merge(numbers).items()}
    checks["jobs_failed"] = {"value": sum(not ok(j) for j in jobs), "limit": 0}
    checks["ref_hits"] = {"value": len(want.records), "min": MIN_HITS}
    ctx = {"window_s": window_s, "setup_s": setup_s,
           "jobs": [{"wall_s": j.wall_s, "phases": j.phases} for j in window],
           "trace": tr, "codes": co.codes, "k": config["kmer_size"]}
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if power is not None:
        dev["power_limit_w"] = power
    result = {"correct": False, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["span_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def finish(result: dict, leftover: list[str]) -> None:
    """Add the checks of what outlived the run's work, and decide
    ``correct`` from every check."""
    others = [t for t in threading.enumerate() if t is not threading.main_thread()]
    for t in others:
        t.join(timeout=10)
    threads = [t.name for t in others if t.is_alive()]
    if leftover or threads:
        _log(f"left running: processes {leftover}, threads {threads}")
    checks = result.pop("checks")
    checks["procs_left"] = {"value": len(leftover), "limit": 0}
    checks["threads_left"] = {"value": len(threads), "limit": 0}
    result["correct"] = all(
        c["value"] >= c["min"] if "min" in c else c["value"] <= c["limit"]
        for c in checks.values())
    result["checks"] = checks


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -B -m kbench",
                                 description="run one cell of BENCHMARK.json once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"needs {chips} CUDA card(s), found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
             "no run, no result")
        return 2
    from kbench import reaper
    from kmdiff_tpu_torch.utils.logging import set_verbosity_level

    reaper.become_subreaper()
    set_verbosity_level("warning")
    guard = reaper.Guard()
    try:
        with guard:
            result = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0))
    except reaper.Terminated as e:
        _log(f"ended by {e}; descendants ended: {guard.found}")
        return 143
    finally:
        if guard.found:
            _log(f"descendants ended on the way out: {guard.found}")
    finish(result, guard.found)
    banned = banned_modules()
    if banned:
        _log(f"modules of {banned} were imported: no result")
        return 3
    for key, c in result["checks"].items():
        bound = f">= {c['min']}" if "min" in c else f"<= {c['limit']}"
        print(f"check {key} {c['value']!r} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
