"""K-EXT's tile shape: device time of canonical_kmers at several
(threads a block, windows a thread, blocks an SM).

Run on a CUDA card from the root of a checkout:

    python3 -m kmdiff_tpu_torch.tools.kext_tiles

Each shape is built from a copy of the package under build/tools/ whose
csrc/canonical_kmers.cu has kThreads, kRuns and kBlocksPerSm set to it. At
2^24 codes (INVALID every 151 bytes, as chip_smoke.py phase 2) for k = 31
and 15 it checks the keys against canonical_kmers_plain and prints ptxas's
register line and three times: the summed kernel time of 20 launches under
torch.profiler over 20, CUDA events around 20 queued launches over 20, and
the host microseconds a launch.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import textwrap

#: name -> (kThreads, kRuns, kBlocksPerSm); the shipped shape is T128_R32_B5
SHAPES = {"T256_R16_B4": (256, 16, 4), "T128_R16_B8": (128, 16, 8),
          "T128_R32_B5": (128, 32, 5), "T64_R32_B8": (64, 32, 8),
          "T64_R64_B5": (64, 64, 5)}

CHILD = textwrap.dedent(r'''
    import sys, time
    import numpy as np, torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec

    kernels.lib()
    regs = [l for l in kernels.build_log["canonical_kmers"].splitlines() if "registers" in l]
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

    def ev_ms(fn, n=20):
        fn(); torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record(); torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    def host_us(fn, n=200):
        fn(); torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    out = [sys.argv[1], regs[0].strip() if regs else "?"]
    for k in (31, 15):
        codes_np = rng.integers(0, 4, 1 << 24).astype(np.uint8)
        codes_np[150::151] = 255
        c = torch.from_numpy(codes_np).to(dev)
        ok = torch.equal(codec.canonical_kmers(c, k), codec.canonical_kmers_plain(c, k))
        f = lambda: codec.canonical_kmers(c, k)
        out.append(f"k={k} eq={ok} prof {prof_ms(f):.4f} ev20 {ev_ms(f):.4f} "
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
    for name, (threads, runs, blocks) in SHAPES.items():
        root = os.path.join(base, f"kext_{name}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(pkg, os.path.join(root, "kmdiff_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(root, "kmdiff_tpu_torch", "csrc", "canonical_kmers.cu")
        with open(src) as f:
            text = f.read()
        for const, value in (("kThreads", threads), ("kRuns", runs),
                             ("kBlocksPerSm", blocks)):
            text, hits = re.subn(rf"constexpr int {const} = \d+;",
                                 f"constexpr int {const} = {value};", text)
            if hits != 1:
                raise RuntimeError(f"canonical_kmers.cu holds {const} {hits} times")
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.run([sys.executable, "-c", CHILD, name], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root))
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
