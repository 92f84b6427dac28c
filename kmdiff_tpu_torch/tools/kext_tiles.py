"""K-EXT's tile shapes: device time of canonical_kmers at several (threads
a block, windows a thread, blocks an SM) of the one-word kernel and (threads
a block, windows a thread at nw = 2, 3, 4) of the multi-word one.

Run on a CUDA card from the root of a checkout, for every shape or the ones
named:

    python3 -m kmdiff_tpu_torch.tools.kext_tiles [NAME ...]

Each shape is built from a copy of the package under build/tools/ whose
csrc/canonical_kmers.cu has kThreads, kRuns and kBlocksPerSm (SHAPES) or
kMwThreads, kMwRuns2, kMwRuns3 and kMwRuns4 (MW_SHAPES) set to it. At
2^24 codes (INVALID every 151 bytes, as chip_smoke.py phase 2), for k = 31
and 15 (one-word) or k = 63 and 128 (multi-word), it checks the keys
against the plain twin and prints ptxas's register lines and three times:
the summed kernel time of 20 launches under torch.profiler over 20, CUDA
events around 20 queued launches over 20, and the host microseconds a
launch.
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

#: name -> (kMwThreads, kMwRuns2, kMwRuns3, kMwRuns4): windows a thread at
#: nw = 2, 3, 4 (multiples of 16); the shipped shape is MW_T128_R32_16_16.
#: A tile's staged keys take nw x 8 bytes x threads x (runs + 1) of dynamic
#: shared memory; the blocks an SM follow from it
MW_SHAPES = {"MW_T128_R32_16_16": (128, 32, 16, 16), "MW_T128_R16_16_16": (128, 16, 16, 16),
             "MW_T64_R32_32_32": (64, 32, 32, 32), "MW_T256_R16_16_16": (256, 16, 16, 16),
             "MW_T128_R32_32_32": (128, 32, 32, 32)}

CHILD = textwrap.dedent(r'''
    import sys, time
    import numpy as np, torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec

    kernels.lib()
    regs = [l.strip() for l in kernels.build_log["canonical_kmers"].splitlines()
            if "registers" in l or "spill" in l]
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    ks = [int(k) for k in sys.argv[2].split(",")]

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

    out = [sys.argv[1], "; ".join(regs) or "?"]
    for k in ks:
        codes_np = rng.integers(0, 4, 1 << 24).astype(np.uint8)
        codes_np[150::151] = 255
        c = torch.from_numpy(codes_np).to(dev)
        plain = codec.canonical_kmers_plain if k <= 32 else codec.canonical_kmers_mw_plain
        ok = torch.equal(codec.canonical_kmers(c, k), plain(c, k))
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
    for name in sys.argv[1:] or [*SHAPES, *MW_SHAPES]:
        if name in MW_SHAPES:
            consts = zip(("kMwThreads", "kMwRuns2", "kMwRuns3", "kMwRuns4"),
                         MW_SHAPES[name])
            ks = "63,128"
        else:
            consts = zip(("kThreads", "kRuns", "kBlocksPerSm"), SHAPES[name])
            ks = "31,15"
        root = os.path.join(base, f"kext_{name}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(pkg, os.path.join(root, "kmdiff_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(root, "kmdiff_tpu_torch", "csrc", "canonical_kmers.cu")
        with open(src) as f:
            text = f.read()
        for const, value in consts:
            text, hits = re.subn(rf"constexpr int {const} = \d+;",
                                 f"constexpr int {const} = {value};", text)
            if hits != 1:
                raise RuntimeError(f"canonical_kmers.cu holds {const} {hits} times")
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.run([sys.executable, "-c", CHILD, name, ks], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root))
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
