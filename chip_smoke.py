#!/usr/bin/env python3
"""Smoke run of kmdiff_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the port's seven CUDA kernels from csrc/ with nvcc
   (one nvcc a source, all at once).
2. Holds each kernel against its plain PyTorch twin on the card at the
   main path's shapes and prints both median times (CUDA events); K-CMP
   at its dense shape (run starts) and its sparse one (LRT survivors),
   with its achieved bandwidth and its launches and host syncs a call;
   K-ASM on 20 streams into a ~2^24-row chunk in both packings, K-WRUN
   on three overlapping 2^22-key streams with hard-min 2, K-HIST on 2^23
   counts with a tail above 255. Integers must be equal; lr within rtol
   1e-6 and atol 1e-6; keep equal except where the margin-adjusted lr
   lies within 1e-5*max(1, lr) of lr_min.
3. Drives count + diff through the port's CLI: popsim of the bench cohort
   (10 controls + 10 cases, 2^23 bp genome, 150 bp reads, coverage 1, error
   rate 0.001, seed 7), `count` (k=31, 4 partitions, hard-min 1) and `diff`
   (-1 10 -2 10, defaults) on CUDA, with the launch counts reset just
   before and required > 0 just after for the four kernels this path
   runs. Then it reruns `diff` and recounts sample 0 with device="cpu"
   (the plain twins) and requires byte-identical outputs.
4. Drives the fused `run` (cmd.run.main_run, with the options the CLI
   builds) on the same cohort and count flags, twice, the launch counts
   reset before each: (a) the defaults, whose FASTA must equal phase 3's
   and whose count files and histograms must equal phase 3's run
   directory; (b) `-s 0.001 --cutoff 1 -c disabled` with the count's
   SORT_ROWS lowered to 2^22 - 128, so that every sample counts in two
   chunks and K-WRUN merges them, whose FASTA must equal phase 3's loose
   `diff`. Both must be served by the fused path and launch its kernels.

Exits non-zero, printing no result, without CUDA or without the rest of the
checkout. The last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")

GENOME = 1 << 23
N_CONTROLS = N_CASES = 10


def median_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_equal(name: str, a, b) -> int:
    import torch

    if a.shape != b.shape or not torch.equal(a, b):
        diff = "shape" if a.shape != b.shape else int((a != b).sum())
        raise AssertionError(f"{name}: kernel and plain twin differ ({diff})")
    return 0


def compare_lrt(dev, rng, B, S, nb_controls, params, max_count):
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops.lrt import MARGIN_ABS, MARGIN_PER_COUNT
    from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter, lrt_filter_plain

    counts = torch.from_numpy(
        rng.integers(0, max_count, size=(B, S), dtype=np.int32)).to(dev)
    args = (nb_controls, params.ratio_c, params.ratio_k, params.lr_min)
    keep, lr, s_c, s_k = lrt_filter(counts, *args)
    keep_p, lr_p, s_c_p, s_k_p = lrt_filter_plain(counts, *args)
    torch.cuda.synchronize()
    check_equal("lrt_filter s_c", s_c, s_c_p)
    check_equal("lrt_filter s_k", s_k, s_k_p)
    if not torch.allclose(lr, lr_p, rtol=1e-6, atol=1e-6):
        raise AssertionError("lrt_filter: lr outside rtol/atol 1e-6")
    tot = (s_c_p + s_k_p).double()
    adj = lr_p.double() + MARGIN_PER_COUNT * tot + MARGIN_ABS
    boundary = (adj - params.lr_min).abs() <= 1e-5 * torch.clamp(lr_p.double(), min=1.0)
    if not torch.equal(keep[~boundary], keep_p[~boundary]):
        raise AssertionError("lrt_filter: keep differs off the boundary")
    err = float((lr - lr_p).abs().max())
    ms = median_ms(lambda: lrt_filter(counts, *args))
    plain = median_ms(lambda: lrt_filter_plain(counts, *args))
    print(f"[K-LRT] lrt_filter [{B}, {S}] nb_controls={nb_controls}: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, max|dlr| {err:.3g}, "
          f"kept {int(keep.sum())}, boundary rows {int(boundary.sum())}")
    return ms, plain, err


def compare_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain twin at main-path shapes."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec
    from kmdiff_tpu_torch.ops.lrt import LrtParams

    rng = np.random.default_rng(7)
    out = {}

    # K-LRT: the merge's [U, 2] group sums, and matrix-path [2^17, S] tiles
    params = LrtParams(N_CONTROLS, N_CASES, 80_000_000, 84_000_000, 0.05 / 1e5)
    ms, plain, err = compare_lrt(dev, rng, 1 << 22, 2, 1, params, 400)
    compare_lrt(dev, rng, 1 << 17, N_CONTROLS + N_CASES, N_CONTROLS, params, 64)
    out["lrt_filter"] = (ms, plain, err)

    # K-EXT: 2^24 codes at k=31, INVALID every 151 bytes (150 bp reads)
    codes_np = rng.integers(0, 4, 1 << 24).astype(np.uint8)
    codes_np[150::151] = codec.INVALID
    codes = torch.from_numpy(codes_np).to(dev)
    keys = codec.canonical_kmers(codes, 31)
    check_equal("canonical_kmers", keys, codec.canonical_kmers_plain(codes, 31))
    ms = median_ms(lambda: codec.canonical_kmers(codes, 31))
    plain = median_ms(lambda: codec.canonical_kmers_plain(codes, 31))
    print(f"[K-EXT] canonical_kmers 2^24 codes k=31: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms")
    out["canonical_kmers"] = (ms, plain, 0.0)

    # K-RUN and K-CMP on 2^23 sorted keys: random k-mers, eight repeats of
    # 2*10^4 copies each, and a sentinel tail
    n = 1 << 23
    raw = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    raw[: 8 * 20_000] = np.repeat(raw[:8], 20_000)
    raw[-5000:] = codec.SENTINEL
    keys_s = torch.sort(torch.from_numpy(raw).to(dev)).values
    flags, n_valid = codec.run_flags(keys_s)
    flags_p, n_valid_p = codec.run_flags_plain(keys_s)
    check_equal("run_flags", flags, flags_p)
    check_equal("run_flags n_valid", n_valid, n_valid_p)
    starts, run_keys = codec.compact(flags, keys_s)
    starts_p, run_keys_p = codec.compact_plain(flags, keys_s)
    check_equal("compact indices", starts, starts_p)
    check_equal("compact payload", run_keys, run_keys_p)
    lengths = codec.run_lengths(starts, n_valid)
    check_equal("run_lengths", lengths, codec.run_lengths_plain(starts, n_valid))
    if int(lengths.max()) <= 10_000:
        raise AssertionError("the run test input lost its long runs")

    # group sums at the merge's shape: ~2 rows per distinct k-mer, packed
    # int16 counts with the control flag in bit 15, read through the sort's
    # permutation
    half = rng.integers(-(2**62), 2**62, n // 2, dtype=np.int64)
    mkeys = np.concatenate([half, np.where(rng.random(n // 2) < 0.6, half,
                                           half ^ 0x5A5A)])
    mcount = rng.integers(1, 300, n).astype(np.int16)
    mcount[: n // 2] |= np.int16(-0x8000)
    mkeys_s, perm = torch.sort(torch.from_numpy(mkeys).to(dev))
    mcount_d = torch.from_numpy(mcount).to(dev)
    mflags, mn_valid = codec.run_flags(mkeys_s)
    mstarts, _ = codec.compact(mflags)
    sums = codec.run_group_sums(mstarts, mn_valid, perm, mcount_d)
    check_equal("run_group_sums", sums,
                codec.run_group_sums_plain(mstarts, mn_valid, perm, mcount_d))

    t_flags = median_ms(lambda: codec.run_flags(keys_s))
    t_flags_p = median_ms(lambda: codec.run_flags_plain(keys_s))
    t_len = median_ms(lambda: codec.run_lengths(starts, n_valid))
    t_len_p = median_ms(lambda: codec.run_lengths_plain(starts, n_valid))
    t_sums = median_ms(lambda: codec.run_group_sums(mstarts, mn_valid, perm, mcount_d))
    t_sums_p = median_ms(
        lambda: codec.run_group_sums_plain(mstarts, mn_valid, perm, mcount_d))
    print(f"[K-RUN] run_flags 2^23 keys: kernel {t_flags:.4f} ms, plain "
          f"{t_flags_p:.4f} ms; run_lengths {len(starts)} runs (longest "
          f"{int(lengths.max())}): kernel {t_len:.4f} ms, plain {t_len_p:.4f} "
          f"ms; run_group_sums {len(mstarts)} runs of 2^23 rows: kernel "
          f"{t_sums:.4f} ms, plain {t_sums_p:.4f} ms")
    out["run_bounds"] = (t_flags + t_len + t_sums,
                         t_flags_p + t_len_p + t_sums_p, 0.0)

    # K-CMP, dense: the run starts above with their keys (codec.py sort_rle,
    # merge_dev.py merge_lrt); times are whole calls, host read included
    ms = median_ms(lambda: codec.compact(flags, keys_s))
    plain = median_ms(lambda: codec.compact_plain(flags, keys_s))
    costs, dev_ms = compact_costs(flags, keys_s)
    floor = n + 24 * len(starts)  # mask read; index write; payload read + write
    print(f"[K-CMP] compact 2^23 rows -> {len(starts)} with payload: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms; {costs}; byte floor {floor} B "
          f"= {floor / 3.35e9:.4f} ms at 3.35 TB/s; achieved "
          f"{floor / dev_ms / 1e6:.1f} GB/s over its device time, "
          f"{floor / ms / 1e6:.1f} GB/s over the call")
    out["compact"] = (ms, plain, 0.0)

    # K-CMP, sparse: the LRT survivors of merge_dev.py merge_lrt, ~0.1% of
    # 2^22 rows at random, with their keys
    sparse = torch.from_numpy(rng.random(1 << 22) < 0.001).to(dev)
    values = torch.from_numpy(
        rng.integers(-(2**62), 2**62, 1 << 22, dtype=np.int64)).to(dev)
    hit, hit_keys = codec.compact(sparse, values)
    hit_p, hit_keys_p = codec.compact_plain(sparse, values)
    check_equal("compact sparse indices", hit, hit_p)
    check_equal("compact sparse payload", hit_keys, hit_keys_p)
    ms = median_ms(lambda: codec.compact(sparse, values))
    plain = median_ms(lambda: codec.compact_plain(sparse, values))
    print(f"[K-CMP] compact 2^22 rows -> {len(hit)} (sparse) with payload: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms; "
          f"{compact_costs(sparse, values)[0]}")

    out["assemble_chunk"] = compare_assemble(dev)
    out["weighted_runs"] = compare_weighted_runs(dev)
    out["abundance_hist"] = compare_hist(dev, rng)
    return out


def _random_streams(dev, S, U, seed, top):
    """S sorted distinct int64 key streams of U rows from one key pool, with
    u32 counts (int32) below top."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.unique(torch.randint(-(2**62), 2**62, (3 * U,), generator=gen,
                                      device=dev))
    keys, counts = [], []
    for _ in range(S):
        pick = torch.randperm(pool.numel(), generator=gen, device=dev)[:U]
        keys.append(torch.sort(pool[pick]).values)
        counts.append(torch.randint(1, top, (U,), generator=gen, device=dev,
                                    dtype=torch.int64).to(torch.int32))
    return keys, counts


def compare_assemble(dev):
    """K-ASM at the merge's shape: a ~2^24-row chunk from 20 streams."""
    import numpy as np

    from kmdiff_tpu_torch.pipeline.fused import assemble_chunk, assemble_chunk_plain

    S, U = N_CONTROLS + N_CASES, 900_000
    rng = np.random.default_rng(11)
    lens = rng.integers(780_000, 850_000, S)
    lens[3] = 0  # a stream with nothing in this key range
    starts = rng.integers(0, U - lens + 1)
    res = {}
    for pack16, top in ((True, 1 << 15), (False, 1 << 32)):
        keys, counts = _random_streams(dev, S, U, 3, top)
        args = (keys, counts, starts, lens, N_CONTROLS, pack16)
        got, want = assemble_chunk(*args), assemble_chunk_plain(*args)
        check_equal("assemble_chunk keys", got[0], want[0])
        check_equal("assemble_chunk counts", got[1], want[1])
        ms = median_ms(lambda: assemble_chunk(*args))
        plain = median_ms(lambda: assemble_chunk_plain(*args))
        name = "p16" if pack16 else "p32"
        print(f"[K-ASM] assemble_chunk {S} streams -> {int(lens.sum())} rows "
              f"({name}): kernel {ms:.4f} ms, plain {plain:.4f} ms")
        res[name] = (ms, plain, 0.0)
    return res["p16"]


def compare_weighted_runs(dev):
    """K-WRUN at a multi-chunk sample's shape: three overlapping distinct
    streams of 2^22 keys, their counts summed per k-mer, hard-min 2."""
    import torch

    from kmdiff_tpu_torch.ops import codec

    keys, counts = _random_streams(dev, 3, 1 << 22, 5, 40)
    keys, weights = torch.cat(keys), torch.cat(counts)
    keys_s, perm = torch.sort(keys)
    flags, n_valid = codec.run_flags(keys_s)
    starts, _ = codec.compact(flags)
    args = (starts, n_valid, perm, weights)
    sums = codec.weighted_run_sums(*args)
    check_equal("weighted_run_sums", sums, codec.weighted_run_sums_plain(*args))
    run_rows = codec.run_lengths(starts, n_valid)
    kept, kept_counts, _stats = codec.dedup_sum(keys, weights, hard_min=2)
    if kept.numel() != int((sums >= 2).sum()) or int(kept_counts.min()) < 2:
        raise AssertionError("dedup_sum: hard-min 2 kept the wrong runs")
    ms = median_ms(lambda: codec.weighted_run_sums(*args))
    plain = median_ms(lambda: codec.weighted_run_sums_plain(*args))
    print(f"[K-WRUN] weighted_run_sums {starts.numel()} runs of {keys.numel()} "
          f"rows (1 to {int(run_rows.max())} rows a run), {kept.numel()} kept at "
          f"hard-min 2: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return ms, plain, 0.0


def compare_hist(dev, rng):
    """K-HIST at a sample's shape: 2^23 counts, mostly 1, with a tail above
    255."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    n = 1 << 23
    c = np.minimum(rng.geometric(0.6, n), 255).astype(np.int32)
    c[:: 1 << 12] = rng.integers(256, 2**31, len(c[:: 1 << 12]))
    counts = torch.from_numpy(c).to(dev)
    hist = codec.abundance_hist(counts)
    check_equal("abundance_hist", hist, codec.abundance_hist_plain(counts))
    if int(hist[256]) < 2048:
        raise AssertionError("the histogram test input lost its tail")
    ms = median_ms(lambda: codec.abundance_hist(counts))
    plain = median_ms(lambda: codec.abundance_hist_plain(counts))
    print(f"[K-HIST] abundance_hist 2^23 counts ({int(hist[1])} at 1, "
          f"{int(hist[256])} above 255): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms")
    return ms, plain, 0.0


def device_work(fn, reps: int = 10) -> tuple[float, int]:
    """Device ms and device operations (kernels, memsets, copies) per call
    of fn, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        raise AssertionError("torch.profiler recorded no device time")
    return sum(spans) / reps / 1e3, round(len(spans) / reps)


def compact_costs(mask, payload) -> tuple[str, float]:
    """What one codec.compact call costs beside one compact_plain call:
    entry-point calls, device operations and device time (torch.profiler),
    host syncs (the plain call's seen by CUDA sync debug mode; K-CMP's one
    sync is inside its C entry point). Also returns K-CMP's device ms."""
    import warnings

    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            codec.compact_plain(mask, payload)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_sync_p = sum("synchroniz" in str(w.message) for w in caught)
    before = kernels.launch_counts()["compact"]
    codec.compact(mask, payload)
    n_launch = kernels.launch_counts()["compact"] - before
    dev_ms, n_ops = device_work(lambda: codec.compact(mask, payload))
    dev_ms_p, n_ops_p = device_work(lambda: codec.compact_plain(mask, payload))
    return (f"a call: {n_launch} entry-point call, {n_ops} device ops in "
            f"{dev_ms:.4f} ms, 1 host sync; plain: {n_ops_p} device ops in "
            f"{dev_ms_p:.4f} ms, {n_sync_p} host sync(s)"), dev_ms


def _read_fasta(path):
    with open(path) as f:
        lines = f.read().split("\n")
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines) - 1, 2)]


def _diff_cpu_vs_gpu(main, dev, args, label, alpha):
    """Run `diff` with args on the CPU (and on `dev` unless out_gpu of this
    label exists); require byte-identical FASTA of 31-mers with p < alpha.
    Returns (k-mers tested, {group: significant k-mers})."""
    outs = {}
    for name, where in (("gpu", dev), ("cpu", "cpu")):
        out = os.path.join(WORK, f"{label}_{name}")
        if not os.path.exists(out):
            main([*args, "--output-dir", out], device=where)
        outs[name] = out
    tested = []
    for out in outs.values():
        with open(os.path.join(out, "options.json")) as f:
            tested.append(json.load(f)["total_kmers"])
    if tested[0] != tested[1]:
        raise AssertionError(f"{label}: k-mers tested differ: {tested}")
    n_sig = {}
    for g in ("control", "case"):
        a, b = (os.path.join(o, f"{g}_kmers.fasta") for o in outs.values())
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{label} {g}_kmers.fasta: CUDA and "
                                     "CPU differ")
        recs = _read_fasta(a)
        for name, seq in recs:
            p = float(name.split("pval=")[1].split("_")[0])
            if len(seq) != 31 or not 0.0 <= p < alpha:
                raise AssertionError(f"{label} {g}: bad record {name} {seq}")
        n_sig[g] = len(recs)
    return tested[0], n_sig


def run_main_path(dev) -> dict:
    """Phase 3: popsim -> count -> diff on CUDA, then the CPU reruns."""
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.cli import main

    sim = os.path.join(WORK, "sim")
    t0 = time.perf_counter()
    main(["popsim", "-o", sim, "--genome-len", str(GENOME), "-1",
          str(N_CONTROLS), "-2", str(N_CASES), "--read-size", "150",
          "--coverage", "1", "--error-rate", "0.001", "--random-seed", "7"],
         device=dev)
    print(f"[cohort] {N_CONTROLS}+{N_CASES} samples x {GENOME} bp, 150 bp "
          f"reads, coverage 1 (simulated in {time.perf_counter() - t0:.1f} s)")
    fof = os.path.join(sim, "fof.txt")
    run = os.path.join(WORK, "run")
    count_args = ["count", "--file", fof, "--kmer-size", "31", "--hard-min",
                  "1", "--nb-partitions", "4", "--threads", "4"]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    main([*count_args, "--run-dir", run], device=dev)
    t_count = time.perf_counter() - t0
    t0 = time.perf_counter()
    diff_args = ["diff", "--km-run-dir", run, "-1", str(N_CONTROLS), "-2",
                 str(N_CASES), "--threads", "4"]
    main([*diff_args, "--output-dir", os.path.join(WORK, "defaults_gpu")],
         device=dev)
    t_diff = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[main path] count {t_count:.3f} s, diff {t_diff:.3f} s "
          f"(wall, CUDA); launches {launches}")
    require_launches("count + diff", launches, COUNT_DIFF_KERNELS)

    t0 = time.perf_counter()
    tested, n_sig = _diff_cpu_vs_gpu(main, dev, diff_args, "defaults", 0.05)
    print(f"[main path] {tested} k-mers tested, significant {n_sig}; "
          f"CPU+CUDA rerun {time.perf_counter() - t0:.3f} s, FASTA "
          f"byte-identical")
    # the defaults (alpha 0.05 over ~10^7 tests, Bonferroni) may keep no
    # k-mer of a coverage-1 cohort; a looser cut exercises non-empty
    # survivor sets on the same run dir
    loose = [*diff_args, "-s", "0.001", "--cutoff", "1", "-c", "disabled"]
    t0 = time.perf_counter()
    _tested, n_loose = _diff_cpu_vs_gpu(main, dev, loose, "loose", 0.001)
    if not n_loose["case"] or not n_loose["control"]:
        raise AssertionError(f"no k-mer passed p < 0.001: {n_loose}")
    print(f"[check] diff -s 0.001 --cutoff 1 -c disabled: {n_loose} "
          f"k-mers, CPU and CUDA byte-identical "
          f"({time.perf_counter() - t0:.3f} s)")

    # recount sample 0 on the CPU
    with open(fof) as f:
        first = f.readline()
    fof0 = os.path.join(WORK, "fof0.txt")
    with open(fof0, "w") as f:
        f.write(first)
    sid = first.split(":")[0].strip()
    run0 = os.path.join(WORK, "run_cpu0")
    t0 = time.perf_counter()
    main([*count_args[:2], fof0, *count_args[3:], "--run-dir", run0],
         device="cpu")
    t_cpu0 = time.perf_counter() - t0
    rels = [os.path.join("histograms", f"{sid}.hist")] + [
        os.path.join("counts", f"partition_{p}", f"{sid}.kmer.lz4")
        for p in range(4)
    ]
    for rel in rels:
        with open(os.path.join(run, rel), "rb") as fa, \
                open(os.path.join(run0, rel), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{rel}: CUDA and CPU counts differ")
    print(f"[main path] sample {sid} recounted on CPU in {t_cpu0:.3f} s: "
          f".kmer.lz4 and .hist byte-identical")
    return {"launches": launches, "count": t_count, "diff": t_diff,
            "fof": fof, "run": run}


#: the kernels each path launches
COUNT_DIFF_KERNELS = ("canonical_kmers", "run_bounds", "compact", "lrt_filter")
RUN_KERNELS = (*COUNT_DIFF_KERNELS, "assemble_chunk", "abundance_hist")


def require_launches(path: str, launches: dict, names) -> None:
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{path} never launched {missing}")


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def run_fused(dev, phase3) -> dict:
    """Phase 4: the fused `run` on CUDA, through cmd.run.main_run with the
    options the CLI builds; (a) the defaults, (b) the loose cut with
    two-chunk samples. Returns each run's launch counts."""
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.cli import count_options, diff_options, parse_args
    from kmdiff_tpu_torch.cmd.run import main_run
    from kmdiff_tpu_torch.pipeline import count as count_mod

    base = ["run", "--file", phase3["fof"], "--kmer-size", "31", "--hard-min",
            "1", "--nb-partitions", "4", "--threads", "4", "-1",
            str(N_CONTROLS), "-2", str(N_CASES)]
    cases = {
        "a": ([], "defaults_gpu", RUN_KERNELS, None),
        "b": (["-s", "0.001", "--cutoff", "1", "-c", "disabled"], "loose_gpu",
              (*RUN_KERNELS, "weighted_runs"), (1 << 22) - 128),
    }
    out = {}
    sort_rows = count_mod.SORT_ROWS
    for label, (extra, ref, needed, rows) in cases.items():
        run_dir = os.path.join(WORK, f"fused_run_{label}")
        out_dir = os.path.join(WORK, f"fused_out_{label}")
        args = parse_args([*base, *extra, "--run-dir", run_dir,
                           "--output-dir", out_dir])
        timings = {}
        if rows:
            count_mod.SORT_ROWS = rows
        try:
            kernels.reset_launch_counts()
            res = main_run(count_options(args), diff_options(args), dev,
                           recurrence_min=args.recurrence_min,
                           count_files=not args.no_count_files,
                           timings=timings)
            launches = kernels.launch_counts()
        finally:
            count_mod.SORT_ROWS = sort_rows
        if "merge" not in timings:
            raise AssertionError(f"run ({label}) was not served by the fused path")
        require_launches(f"run ({label})", launches, needed)
        for g in ("control", "case"):
            name = f"{g}_kmers.fasta"
            if not _same_bytes(os.path.join(out_dir, name),
                               os.path.join(WORK, ref, name)):
                raise AssertionError(f"run ({label}) {name} differs from diff's")
        if label == "a":
            for p in range(4):
                pdir = os.path.join("counts", f"partition_{p}")
                names = sorted(os.listdir(os.path.join(phase3["run"], pdir)))
                if sorted(os.listdir(os.path.join(run_dir, pdir))) != names:
                    raise AssertionError(f"run (a) {pdir}: other files")
                for n in names:
                    if not _same_bytes(os.path.join(run_dir, pdir, n),
                                       os.path.join(phase3["run"], pdir, n)):
                        raise AssertionError(f"run (a) {pdir}/{n} differs")
            hdir = "histograms"
            for n in sorted(os.listdir(os.path.join(phase3["run"], hdir))):
                if not _same_bytes(os.path.join(run_dir, hdir, n),
                                   os.path.join(phase3["run"], hdir, n)):
                    raise AssertionError(f"run (a) {hdir}/{n} differs")
        elif not res["control"] or not res["case"]:
            raise AssertionError(f"run ({label}) kept no k-mer: {res}")
        print(f"[run {label}] {' '.join(extra) or 'defaults'}: count "
              f"{timings['count']:.3f} s, merge {timings['merge']:.3f} s, "
              f"total {timings['total']:.3f} s (wall, CUDA; phase 3: count "
              f"{phase3['count']:.3f} s, diff {phase3['diff']:.3f} s); "
              f"{res['total_kmers']} k-mers tested, significant "
              f"{res['control']} control / {res['case']} case, FASTA "
              f"byte-identical to diff's"
              + ("; count files and histograms byte-identical to count's"
                 if label == "a" else "")
              + f"; launches {launches}")
        out[label] = launches
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from kmdiff_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the kmdiff_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.lib()
    print(f"kernels built in {kernels.build_seconds:.1f} s (loaded "
          f"{time.perf_counter() - t0:.1f} s): {kernels.library_path()}")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        timings = compare_kernels(dev)
        phase3 = run_main_path(dev)
        fused_launches = run_fused(dev, phase3)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    if loaded:
        raise AssertionError(f"JAX was imported: {loaded}")

    # name -> (TPU function it replaces, the path run whose launches count)
    meta = {
        "lrt_filter": ("kmdiff_tpu/ops/lrt_pallas.py:68", phase3["launches"]),
        "canonical_kmers": ("kmdiff_tpu/ops/codec.py:73", phase3["launches"]),
        "run_bounds": ("kmdiff_tpu/ops/codec.py:341", phase3["launches"]),
        "compact": ("kmdiff_tpu/ops/merge_dev.py:49", phase3["launches"]),
        "assemble_chunk": ("kmdiff_tpu/pipeline/fused.py:387",
                           fused_launches["a"]),
        "weighted_runs": ("kmdiff_tpu/ops/codec.py:396", fused_launches["b"]),
        "abundance_hist": ("kmdiff_tpu/ops/codec.py:418", fused_launches["a"]),
    }
    rows = []
    for name, (replaces, launches) in meta.items():
        ms, plain, err = timings[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"kmdiff_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
