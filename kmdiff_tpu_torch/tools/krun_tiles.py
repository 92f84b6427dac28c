"""K-RUN's tile shape and cache hints: device time of codec.run_encode in
its count and merge forms at several (threads a block, rows a thread in
the count form, rows a thread in the merge form, evict-first hints).

Run on a CUDA card from the root of a checkout, for every variant or the
ones named:

    python3 -m kmdiff_tpu_torch.tools.krun_tiles [NAME ...]

Each variant is built from a copy of the package under build/tools/ whose
csrc/run_bounds.cu has kThreads, the rows a thread (Tile::kRounds) and
kStreamHints set to it. At chip_smoke.py phase 2's shapes (the count form
on 2^23 sorted keys with eight runs of 2*10^4 copies and a 5,000-row
sentinel tail; the merge form on 2^23 rows, ~1.4 a run, int16 counts read
through the sort's permutation) it checks every output against
run_encode_plain (inputs from chip_smoke.py's run_inputs) and prints
ptxas's register lines and, for each form,
the device time of a call under torch.profiler (every device operation,
over 20 calls), the median whole call (CUDA events, 15 after 3 warm-ups)
and the host microseconds a call.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import textwrap

#: name -> (kThreads, count-form rows a thread, merge-form rows a thread,
#: evict-first hints: "cs" in every form, "mcs" in the merge forms only,
#: "" in none); the shipped variant is T256_R8_M4_mcs. The scan needs
#: threads / 32 * rows >= 32 in both forms (T256_R4_M2, T256_R8_M2 and
#: T128_R8_M4 do not build)
VARIANTS = {"T256_R16_M8_cs": (256, 16, 8, "cs"), "T256_R16_M8": (256, 16, 8, ""),
            "T256_R8_M4_cs": (256, 8, 4, "cs"), "T512_R8_M4_cs": (512, 8, 4, "cs"),
            "T128_R16_M8_cs": (128, 16, 8, "cs"), "T256_R8_M4_mcs": (256, 8, 4, "mcs"),
            "T512_R4_M2_mcs": (512, 4, 2, "mcs"),
            "T512_R8_M4_mcs": (512, 8, 4, "mcs")}
HINTS = {"cs": "true", "mcs": "kMerge", "": "false"}

CHILD = textwrap.dedent(r'''
    import importlib.util, statistics, sys, time
    import numpy as np, torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec

    kernels.lib()
    regs = [l.strip() for l in kernels.build_log["run_bounds"].splitlines()
            if "registers" in l]
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)

    def prof_ms(fn, reps=20):
        fn(); torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in p.events()
                 if e.device_type == DeviceType.CUDA]
        return sum(spans) / reps / 1e3

    def call_ms(fn, reps=15):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
            s.record(); fn(); e.record(); torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def host_us(fn, n=100):
        fn(); torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    spec = importlib.util.spec_from_file_location("_chip_smoke", sys.argv[2])
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    keys_s, mkeys_s, perm, mcount = smoke.run_inputs(dev, rng)

    out = [sys.argv[1], "; ".join(regs)]
    for form, args in (("count", (keys_s, None, None, True)),
                       ("merge", (mkeys_s, perm, mcount, False))):
        ok = all(torch.equal(g, w) for g, w in zip(codec.run_encode(*args),
                                                   codec.run_encode_plain(*args))
                 if w is not None)
        f = lambda: codec.run_encode(*args)
        out.append(f"{form} eq={ok} prof {prof_ms(f):.4f} call {call_ms(f):.4f} "
                   f"host {host_us(f):.1f}us")
    print(" | ".join(out), flush=True)
''')


def main() -> int:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.path.join(os.path.dirname(pkg), "build", "tools")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for name in sys.argv[1:] or VARIANTS:
        threads, rows, merge_rows, hints = VARIANTS[name]
        root = os.path.join(base, f"krun_{name}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(pkg, os.path.join(root, "kmdiff_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(root, "kmdiff_tpu_torch", "csrc", "run_bounds.cu")
        with open(src) as f:
            text = f.read()
        for pattern, value in (
                (r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};"),
                (r"kRounds = kMerge \? \d+ : \d+;", f"kRounds = kMerge ? {merge_rows} : {rows};"),
                (r"constexpr bool kStreamHints = \w+;",
                 f"constexpr bool kStreamHints = {HINTS[hints]};")):
            text, hits = re.subn(pattern, value, text)
            if hits != 1:
                raise RuntimeError(f"run_bounds.cu matches {pattern!r} {hits} times")
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.run([sys.executable, "-c", CHILD, name,
                               os.path.join(os.path.dirname(pkg), "chip_smoke.py")],
                              cwd=root, env=dict(os.environ, PYTHONPATH=root))
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
