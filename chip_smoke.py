#!/usr/bin/env python3
"""Smoke run of kmdiff_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the port's twelve CUDA kernels from csrc/ with nvcc
   (one nvcc a source, all at once), printing K-EXT's, K-GRAM's and
   K-PART's registers, spills and shared memory (-Xptxas -v); builds and loads the port's native host-IO
   library (native/), which must come from build/kmdiff_tpu_torch/native/.
2. Holds each kernel against its plain PyTorch twin on the card at the
   main path's shapes and prints both median times (CUDA events), each
   kernel's bound (the larger of its bytes over 3.35 TB/s and its
   operations over the card's peak for their type: BOUND_RATES) and, where
   one PyTorch call computes the same function, that call's time; K-LRT
   in its callers' forms and in the full form, each with its device time
   (CUDA events around 20 launches queued back to back): keep alone on the
   merge's [2^22, 2] sums (a view 8 bytes past a 16-byte boundary), keep
   and the sums on a [2^17, 20] matrix tile, and keep alone on the wide
   merge's [2^22, 2] int64 sums (every 16th row from 2^31 to 2^34); K-EXT
   at 2^24 codes for k = 31, 15, 21, 32 and at a bench sample's 8,444,524
   codes, each also as device time (CUDA events around 20 launches queued
   back to back); K-RUN (run_encode) in its count form on 2^23 sorted keys
   (random k-mers, eight runs of 2*10^4 copies, a 5,000-row sentinel tail)
   beside torch.unique_consecutive, its merge form on 2^23 rows with int16
   packed counts read through the sort's permutation, both without run
   starts as sort_rle and merge_lrt call them (and checked with them), and
   its dedup form on the same keys, and its full form (int64 sums of raw
   u32 counts, every eighth from 2^31 to 2^32, with sample ids) on 2^23
   rows from 20 streams, with and without starts, each form's device time
   from torch.profiler (the call waits for its count); K-CMP at its dense shape (the run starts of
   K-RUN's input), with and without its payload, and its sparse one (LRT
   survivors), with its achieved bandwidth and its launches and host syncs
   a call; K-ASM on 20 streams into a ~2^24-row chunk in both packings and
   with the full merge's sample ids (raw counts), a chunk's whole call and its device
   time (20 queued launches), the per-merge table timed apart; K-WRUN
   on three overlapping 2^22-key streams with hard-min 2, K-HIST
   (rle_stats: n_valid, the max and the histogram) on 2^23 counts with a
   tail above 255, as int32 (a view 8 bytes past a 16-byte boundary) and as
   int64, with one launch and one device operation a call and its device
   time from torch.profiler; K-GENO on 2^23 run keys at rates 0.001 and
   0.05, K-ROWS for ~13,700 survivors and ~12,000 sampled starts of 2^23
   sorted rows from 20 streams (raw counts, every 16th from 2^31 to 2^32,
   which the count rows must hold), each with its device time (20 queued
   launches) and its one device operation a call (torch.profiler), K-GENO's
   device time (20 queued launches), K-GRAM on [2^20, 20] and [2^18, 200]
   0/1 blocks beside torch._int_mm (the same blocks as int8, S padded to a
   multiple of 8, held equal to K-GRAM's Gram), each with its device time
   (20 queued launches) and its device operations a call (torch.profiler),
   K-IRLS on 2^14 conditioned alt
   designs at n = 20, F = 5 and n = 200, F = 12 (one singular item, one
   separable) and on their first 1,024 (popstrat's launch size), alone
   bit-identical to the same fits among 2^14, each with its device time
   (20 queued launches); and the multi-word forms (k > 32, [nw, N]
   word-major keys): K-EXT at 2^24 codes for k = 63 and 128, K-RUN's count
   form without starts on 2^23 two-word keys (the first 2^20 rows sharing
   512 leading words, eight runs of 2*10^4 copies, a 5,000-row sentinel
   tail) beside torch.unique_consecutive(dim=0) on the [N, 2] rows, with its
   dedup and count-with-starts forms checked too, K-ASM on 20 two-word
   streams (p16, and raw counts with sample ids), K-GENO on 2^23 two-word
   keys as a view of a wider buffer, each with its device time (20 queued
   launches; K-RUN's from torch.profiler, as its call waits for its count).
   K-PART (partition_targets, the mesh count's bucketing) on 2^24
   one-word keys (k = 31) and 2^23 two-word keys (k = 63), and at phase
   10's per-call shapes (a bench sample's windows over D shards, k = 31 and
   63), every 151st a sentinel row, 4 partitions, D = 2 and 4, equal to its
   twin, with its device time (20 queued launches).
   K-FASTA (fasta_codes, the fused run's decode) on a kbench sample's
   FASTA bytes (123,777 reads of 150 bp, 19.8 MB) and a bench sample's
   (2^23 bp at coverage 1), equal to its twin, with its device time
   (torch.profiler, as its call waits for its code count).
   Also plan_key_chunks (the fused merge's chunk plan, plain torch) on
   phase 4's plan shape, 20 streams of 4,700,000 keys, timed as a whole
   call beside its bytes bound. Integers, masks and
   statistics must be equal; lr within rtol 1e-6 and atol 1e-6;
   K-IRLS with an f64 refit as witness: iteration counts equal on 97% of
   the items, and on the fits the witness finds at a maximum the stop
   codes equal and, at equal iteration counts, ll within rtol 1e-5 and
   atol 1e-4 (separated or diverged fits have no maximum and are counted;
   kmdiff_tpu_torch/tools/irls_seeds.py sweeps this over many draws).
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
5. Population-stratification correction on phase 3's run directory with
   `-s 0.001 --cutoff 1 -c disabled --pop-correction --save-sk` and the
   default `--kmer-pca 0.001 --n-pc 2`: (a) `diff` on CUDA, which must
   launch K-RUN, K-CMP, K-ROWS, K-GENO, K-GRAM, K-IRLS and K-LRT, then on
   the CPU: the
   popstrat artifacts (.geno, .snp, .ind, .total, parfile.txt, pcs.evec)
   and the --save-sk matrices byte-identical, the FASTA the same k-mers
   with p-values within 1% relative, but for at most KNIFE_EDGES_MAX
   quasi-separated fits that f32 IRLS drove to p = 1 on one side, split
   between the sides, which an f64 refit of every alt model judges
   (check_popstrat_fasta: the splits are counted in distinct alt designs,
   from SPLIT_MIN_DESIGNS up), the kernel's significant set no further from
   the f64 one than its twin's;
   (b) `run` with the same flags on CUDA,
   served by the fused path with K-ASM: FASTA and pcs.evec byte-identical
   to (a)'s CUDA output, the .geno the same multiset of rows. Then K-GRAM
   again on the blocks (a)'s CUDA PCA gave it, one a row-sum group of the
   geno matrix: their shapes logged, each held against the twin, the
   sequence timed as in phase 2 (whole calls, device time over 20 queued
   sequences, device operations a call).
6. The wide sums, on a cohort whose k-mer mass passes 2^31 (wide_cohort:
   a run directory in count's layout made on the host from numpy, seed
   WIDE_SEED: 10 controls + 10 cases, 4 partitions, ~2^22 k-mers a sample
   from a pool of ~6 M, ~84 M merge rows, 2,000 case-enriched k-mers and 8
   planted ones with counts from 1.5e9 to 3.1e9, so that raw counts pass
   2^31 and group sums 2^32): (a) `diff -s 0.001 --cutoff 1 -c disabled`
   on CUDA, which must launch K-RUN in its full form, K-LRT on int64 sums
   and K-CMP (launch counts reset before, > 0 after; the merge's calls
   counted by form, FormSpy) and never the packed merge, then on the CPU:
   FASTA byte-identical, and record for record (p-value and means as
   printed) the host f64 rescore of the input's exact numpy int64 group
   sums; (b) the same with `--pop-correction --save-sk` on CUDA (K-ROWS and
   K-GENO too) and on the CPU: artifacts and matrices byte-identical, the
   planted k-mers that pass held in the matrices with their raw counts
   exactly; (c) the fused `run` on phase 3's cohort with the loose cut and
   LrtParams.wide_sums forced true in this process only, served by the
   fused path with K-ASM and the full-form K-RUN, its FASTA byte-identical
   to phase 3's loose `diff`.
7. k > 32 on phase 3's cohort at its full size. k = 63 (two words, 31
   bases in the second): `count` and `diff` (defaults, and the loose cut,
   which must keep k-mers) on CUDA, then both diffs on the CPU and sample
   0 recounted on the CPU, byte-identical; the fused `run` (a), served by
   the fused path, its FASTA, count files and histograms byte-identical to
   count + diff's; popstrat `diff --save-sk` on CUDA and the CPU under
   phase 5's rules. k = 128 (four words): `count` and `diff` as at k = 63.
   Launch counts reset before each part; each must launch the multi-word
   forms of its kernels and no one-word K-EXT, K-RUN, K-ASM or K-GENO.
8. Custom model plugins, `call` and `infos` on phase 3's run directory
   (run_plugins): `diff --model` with the port's device twin
   (examples/plugins/device_fold_change_model.py, process_block_torch; on
   CUDA through a spy, `--model __main__:spy_device_model`, whose tiles
   must all be CUDA tensors of at most BLOCK_ROWS rows, every row scored
   once) and again with device="cpu": FASTA byte-identical; with the numpy
   twin on CUDA: the same k-mer sets and tallies; no run launches K-LRT.
   `run --model` with the device twin into a fresh run directory: the
   standard flow (K-EXT and K-RUN launched, K-ASM and K-LRT not), its
   FASTA byte-identical to the CUDA `diff --model`'s. `call` of phase 3's
   loose case k-mers against popsim's truth.fasta must map some; `infos`
   on CUDA must name the card. Each step's wall is printed, with the host
   union merge's and the scoring's seconds summed over the partitions.
9. The multi-process runtime (run_distributed): two ranks of one gloo
   group (`python -m kmdiff_tpu_torch ... --distributed 127.0.0.1:<free
   port> --num-processes 2 --process-id R`), both on the first card, over
   phase 3's cohort at its full size: `count` (its count files, histograms,
   fof and kmdiff-count.opt byte-identical to phase 3's), the loose `diff`
   (FASTA byte-identical to phase 3's loose diff), popstrat `diff
   --save-sk` (FASTA, pcs.evec and matrices byte-identical to phase 5's
   CUDA diff) and the loose `run` (the standard flow; FASTA byte-identical
   to phase 3's loose diff). Each rank writes its wall and its launches
   (KMDIFF_RUN_REPORT); both must exit 0, and each must launch K-EXT,
   K-RUN, K-CMP and K-LRT over the four commands. Each rank's process wall
   and command seconds are printed beside the single process's wall. Then
   the mesh under the runtime: the four commands as two ranks of two
   shards each (--devices 2: on one card a virtual mesh of the card in each
   rank, through tools/dist_walls.py's spawn; with four cards or more rank
   0 on cuda:0-1 and rank 1 on cuda:2-3), every output byte-identical to
   phase 3's or 5's, each rank launching DIST_MESH_KERNELS on each of its
   cards; and that pair's loose diff again under --profile DIR: both rank
   traces, each with a kmd:<kernel> range and the CUDA activity of every
   kernel its rank launched and aten ops on a mesh shard's thread
   (check_trace), its wall beside the unprofiled one's.
10. The mesh runtime (run_mesh) on phase 3's cohort at its full size:
   `count` (k = 31), the loose `diff`, popstrat `diff --save-sk`, the fused
   loose `run` (through cmd.run.main_run, which must take the fused path;
   on two shards, two chunks a dispatch), and at k = 63 `count`, the loose
   `diff`, popstrat `diff --save-sk` and the fused loose `run` (K-RUN's,
   K-ASM's and K-GENO's multi-word forms on every shard), first with
   --devices 1 (each output byte-identical to phase 3's, 5's or 7's), then
   with --devices 2 on a virtual mesh of two shards on the first card
   (parallel.runtime.set_virtual), each output byte-identical to the
   one-shard run's, and, on a machine with two cards or more, with
   --devices min(4, cards) on real cards, which must launch K-EXT (both
   forms), K-PART, K-GRAM and the multi-word K-RUN, K-ASM and K-GENO on
   every card. Each command must launch its
   kernels (MESH_KERNELS; K-PART only on a mesh); each wall is printed
   beside the one-shard wall. Two shards on one card measure the overhead
   of sharding, not a speedup. Phases 3-8 give their count, diff and run
   commands --devices 1 (ONE_SHARD; the CLI's default, 0, takes every
   card), and phase 9 gives --devices 1 or 2 explicitly, so a mesh runs
   only where phases 9 and 10 ask for one, on any machine.
11. `warmup -1 10 -2 10 --pop` (run_warmup) on the built libraries: it
   must launch every kernel of the main path and of popstrat
   (WARMUP_KERNELS); each group's seconds are printed.

Then it prints every kernel's launches on each path, and fails if any
module of JAX or of the JAX package (kmdiff_tpu) was loaded.

Exits non-zero, printing no result, without CUDA or without the rest of the
checkout. The line before the last is {"kernels": [...]}, one row a kernel
with its launches on the main path it belongs to, its times, max_abs_err,
bound_ms, bound_by and library_ms (null where no one PyTorch call computes
its function); canonical_kmers', run_bounds', assemble_chunk's,
lrt_filter's and abundance_hist's rows also carry device_ms; lrt_filter's
row is its merge form (keep alone), with profiler_ms (its kernel's time in
torch.profiler), and carries its full form as full_ms, full_device_ms,
full_profiler_ms, full_bound_ms and full_bound_by, and the matrix tile's
forms as matrix_* (keep and the sums) and matrix_full_*, and the int64
form (keep alone) as wide_ms, wide_plain_ms, wide_device_ms, wide_bound_ms
and wide_bound_by, with wide_launches (its launches on phase 6's wide
diff); abundance_hist's
row is its int32 form and carries the int64 form as wide_ms,
wide_plain_ms, wide_device_ms, wide_bound_ms and wide_bound_by;
run_bounds' row is its count form ("form") and
carries the merge form as merge_ms, merge_plain_ms, merge_device_ms,
merge_bound_ms, merge_bound_by and merge_library_ms, and the full form
(int64 sums, without starts) as wide_ms, wide_plain_ms, wide_device_ms,
wide_bound_ms, wide_bound_by and wide_launches; compact's row is its
payload form ("form") and carries the index form as index_ms,
index_plain_ms, index_bound_ms, index_bound_by and index_library_ms
(torch.nonzero); run_rows' and irls' rows carry device_ms (run_rows' also
device_ops) and their other shapes' rows under "shapes" (run_rows: the
sampled presence rows; irls: n = 20 at 1,024 items, n = 200 at 2^14 and
1,024); the multi-word forms have rows of their own (canonical_kmers_mw,
run_bounds_mw, assemble_chunk_mw, geno_sample_mw: source the one-word
form's, launches on phase 7's k = 63 paths, device_ms; canonical_kmers_mw
carries k = 128 as k128_*, assemble_chunk_mw the full merge's raw counts
with sample ids as full_*; run_bounds_mw is the count form, beside
torch.unique_consecutive(dim=0)); int_gram's row is [2^20, 20] with
device_ms and device_ops, carries [2^18, 200] as s200_* and phase 5's
row-sum groups as groups_* (ms, plain_ms, bound_ms, bound_by, device_ms,
device_ops a call, shapes); its library_ms is torch._int_mm; every row
carries dist_launches, its launches on phase 9 (both ranks, four commands,
one shard a rank), mesh_launches, its launches on phase 10's two virtual
shards (eight commands), and warmup_launches, phase 11's; partition_ids' row (K-PART) is its one-word D = 2 form, with
device_ms and its other shapes under "shapes", and its launches are phase
10's (it runs on the mesh path only);
the last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")

GENOME = 1 << 23
N_CONTROLS = N_CASES = 10
#: codes of one bench sample: 2^23 bases of 150 bp reads, one INVALID
#: separator a read
SAMPLE_CODES = GENOME // 150 * 151

#: the H100 SXM's peaks for the kernels' bounds (NVIDIA's data sheet; the
#: Hopper white paper's 64 INT32 lanes an SM against 128 f32 lanes at the
#: clock of the 67 TFLOP/s f32 figure; the CUDA programming guide's 16
#: population counts a clock an SM against 64 int32 adds for compute
#: capability 9.0): device memory bytes/s, f32 CUDA-core flop/s (an FMA is
#: two), int32 CUDA-core op/s, popc op/s. No kernel of the port uses tensor
#: cores.
BOUND_RATES = {"bytes": 3.35e12, "f32": 67e12, "int32": 16.7e12, "popc": 16.7e12 / 4}


def bound(nbytes: float, ops=0.0, kind: str = "int32") -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take to
    move nbytes (each input read once, each output written once) and do ops
    operations of the given type, or ops = {type: count} on pipes that
    overlap (the slowest pipe sets the time)."""
    t_bytes = nbytes / BOUND_RATES["bytes"]
    ops = ops if isinstance(ops, dict) else {kind: ops}
    t_ops = max(count / BOUND_RATES[k] for k, count in ops.items())
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def row(ms, plain, err, nbytes, ops=0.0, kind="int32", library=None, **extra):
    """A kernel's phase-2 result: its times, error, bound and library time."""
    b_ms, b_by = bound(nbytes, ops, kind)
    return {"ms": ms, "plain_ms": plain, "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library, **extra}


def share(r) -> str:
    return (f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms']:.1%} of it")


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


def events_ms(fn, n: int = 20) -> float:
    """Device time of one call: CUDA events around n calls queued back to
    back, over n. A sleep kernel ahead of the first event holds the card
    until the host has queued all n calls, so that calls whose host work
    outlasts their kernels are timed by the card, not by the host; the
    sleep grows until it outlasts the queueing (fn must not wait for the
    card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(4):
        lead, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        lead.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if lead.elapsed_time(start) > host_ms:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise AssertionError(f"events_ms: queueing {n} calls outlasted every sleep")


def check_equal(name: str, a, b) -> int:
    import torch

    if a.shape != b.shape or not torch.equal(a, b):
        diff = "shape" if a.shape != b.shape else int((a != b).sum())
        raise AssertionError(f"{name}: kernel and plain twin differ ({diff})")
    return 0


def lrt_inputs(dev, rng):
    """K-LRT's phase-2 inputs: the merge's [2^22, 2] group sums below 400,
    as a view 8 bytes past a 16-byte boundary (K-RUN hands them out at an
    int64 word offset of its buffer: the pairs form's lead row), and a
    matrix-path [2^17, 20] tile below 64, fresh (run_filter's copy), with
    the bench cohort's LrtParams. -> (params, merge, matrix)."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops.lrt import LrtParams

    params = LrtParams(N_CONTROLS, N_CASES, 80_000_000, 84_000_000, 0.05 / 1e5)
    merge = rng.integers(0, 400, size=(1 << 22, 2), dtype=np.int32)
    matrix = rng.integers(0, 64, size=(1 << 17, N_CONTROLS + N_CASES), dtype=np.int32)
    view = torch.empty(merge.size + 2, dtype=torch.int32, device=dev)[2:].view(merge.shape)
    view.copy_(torch.from_numpy(merge))
    return params, view, torch.from_numpy(matrix).to(dev)


def compare_lrt(dev, rng):
    """K-LRT in its callers' forms: the merge's [2^22, 2] sums, keep alone
    (merge_dev._merge_runs), and a matrix-path [2^17, 20] tile, keep and
    the sums (lrt.run_filter); each also in the full form, as earlier
    slices called it (the thread-a-row kernel serves it at any S). Every
    form against the plain twin: keep, s_c and s_k equal, lr within rtol
    1e-6 and atol 1e-6. Whole calls and device time
    (CUDA events over 20 queued launches). Returns the merge form's row
    with its full form in full_* fields and the matrix forms in matrix_*
    and matrix_full_* fields."""
    import torch

    from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter, lrt_filter_plain

    params, merge, matrix = lrt_inputs(dev, rng)
    res = {"wide": compare_lrt_wide(dev, rng, params)}
    for label, counts, nbc, want_sums in (("merge", merge, 1, False),
                                          ("matrix", matrix, N_CONTROLS, True)):
        B, S = counts.shape
        args = (nbc, params.ratio_c, params.ratio_k, params.lr_min)
        keep_p, lr_p, s_c_p, s_k_p = lrt_filter_plain(counts, *args)
        keep, lr, s_c, s_k = lrt_filter(counts, *args)
        torch.cuda.synchronize()
        for name, g, w in (("keep", keep, keep_p), ("s_c", s_c, s_c_p), ("s_k", s_k, s_k_p)):
            check_equal(f"lrt_filter {label} {name}", g, w)
        if not torch.allclose(lr, lr_p, rtol=1e-6, atol=1e-6):
            raise AssertionError(f"lrt_filter {label}: lr outside rtol/atol 1e-6")
        narrow = lrt_filter(counts, *args, want_lr=False, want_sums=want_sums)
        check_equal(f"lrt_filter {label} narrow keep", narrow[0], keep_p)
        if narrow[1] is not None or (narrow[2] is not None) != want_sums:
            raise AssertionError(f"lrt_filter {label}: an output not asked for")
        if want_sums:
            check_equal(f"lrt_filter {label} narrow s_c", narrow[2], s_c_p)
            check_equal(f"lrt_filter {label} narrow s_k", narrow[3], s_k_p)
        err = float((lr - lr_p).abs().max())
        call = lambda: lrt_filter(counts, *args, want_lr=False, want_sums=want_sums)  # noqa: E731
        full_call = lambda: lrt_filter(counts, *args)  # noqa: E731
        plain = median_ms(lambda: lrt_filter_plain(counts, *args))
        # counts in; keep (and the int32 sums) out, or all four; ~50 f32
        # operations a row (two logs, the margin and the compare)
        ops = B * (S + 50)
        for key, fn, nbytes, form in (
                (label, call, B * (4 * S + 1 + 8 * want_sums),
                 "keep and the sums" if want_sums else "keep alone"),
                (f"{label}_full", full_call, B * (4 * S + 13), "full form")):
            r = res[key] = row(median_ms(fn), plain, err, nbytes, ops, "f32",
                               device_ms=events_ms(fn), profiler_ms=device_work(fn)[0])
            print(f"[K-LRT] lrt_filter [{B}, {S}] nb_controls={nbc}, {form}: kernel "
                  f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms over 20 queued "
                  f"launches, {r['profiler_ms']:.4f} ms a kernel in torch.profiler), "
                  f"plain {plain:.4f} ms, max|dlr| {err:.3g}, kept {int(keep.sum())}; "
                  f"{share(r)}, {r['bound_ms'] / r['device_ms']:.1%} of it over the "
                  f"device time; library: none (no one call)")
    out = res["merge"]
    for key, prefix in (("merge_full", "full"), ("matrix", "matrix"),
                        ("matrix_full", "matrix_full")):
        out.update({f"{prefix}_{f}": res[key][f]
                    for f in ("ms", "device_ms", "profiler_ms", "bound_ms", "bound_by")})
    out.update({f"wide_{f}": res["wide"][f]
                for f in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by")})
    return out


def compare_lrt_wide(dev, rng, params):
    """K-LRT's int64 form, keep alone, on the wide merge's [2^22, 2] group
    sums (K-RUN's full form hands them out 16-byte aligned: the wide pairs
    kernel), below 400 but every 16th row from 2^31 to 2^34: keep equal to
    the twin's; whole call and device time (CUDA events over 20 queued
    launches)."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter, lrt_filter_plain

    sums = rng.integers(0, 400, size=(1 << 22, 2), dtype=np.int64)
    sums[::16] = rng.integers(2**31, 2**34, size=(len(sums[::16]), 2))
    sums = torch.from_numpy(sums).to(dev)
    if sums.data_ptr() % 16:
        raise AssertionError("the wide sums are not 16-byte aligned")
    args = (1, params.ratio_c, params.ratio_k, params.lr_min)
    call = lambda: lrt_filter(sums, *args, want_lr=False, want_sums=False)  # noqa: E731
    keep = call()[0]
    check_equal("lrt_filter wide keep", keep, lrt_filter_plain(sums, *args)[0])
    B = sums.shape[0]
    plain = median_ms(lambda: lrt_filter_plain(sums, *args))
    # two int64 sums in, keep out; ~50 f32 operations a row
    r = row(median_ms(call), plain, 0.0, 17 * B, 50 * B, "f32", device_ms=events_ms(call))
    print(f"[K-LRT] lrt_filter [{B}, 2] int64 sums (wide pairs form, {int((sums >= 2**31).sum())} "
          f"sums at or above 2^31), keep alone: kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f} ms over 20 queued launches), plain {plain:.4f} ms, kept "
          f"{int(keep.sum())}; {share(r)}, {r['bound_ms'] / r['device_ms']:.1%} of it over "
          f"the device time; library: none (no one call)")
    return r


def compare_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain twin at main-path shapes."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    rng = np.random.default_rng(7)
    out = {}

    out["lrt_filter"] = compare_lrt(dev, rng)
    out["canonical_kmers"] = compare_ext(dev, rng)

    out["run_bounds"], keys_s = compare_runs(dev, rng)
    out["run_bounds"].update(compare_full_runs(dev, rng))
    n = keys_s.numel()
    # K-CMP's dense shape: the run starts of K-RUN's count-form input, with
    # their keys (the compaction the run starts once went through; K-CMP's
    # row keeps that shape)
    flags, _ = codec.run_flags_plain(keys_s)
    starts, run_keys = codec.compact(flags, keys_s)
    starts_p, run_keys_p = codec.compact_plain(flags, keys_s)
    check_equal("compact indices", starts, starts_p)
    check_equal("compact payload", run_keys, run_keys_p)

    # K-CMP, dense: the run starts above with their keys; times are whole
    # calls, host read included
    ms = median_ms(lambda: codec.compact(flags, keys_s))
    plain = median_ms(lambda: codec.compact_plain(flags, keys_s))
    costs, dev_ms = compact_costs(flags, keys_s)
    floor = n + 24 * len(starts)  # mask read; index write; payload read + write
    print(f"[K-CMP] compact 2^23 rows -> {len(starts)} with payload: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms; {costs}; byte floor {floor} B "
          f"= {floor / 3.35e9:.4f} ms at 3.35 TB/s; achieved "
          f"{floor / dev_ms / 1e6:.1f} GB/s over its device time, "
          f"{floor / ms / 1e6:.1f} GB/s over the call")
    # the row stays the payload form, as in earlier PRs: no one call returns
    # the indices with the gathered keys
    out["compact"] = row(ms, plain, 0.0, floor, n, form="payload")
    print(f"[K-CMP] payload form: {share(out['compact'])}; library: none "
          f"(torch.nonzero, then a gather)")
    # the index form (merge_dev's survivors and geno sample) is the one
    # function a library call computes: torch.nonzero; kept in the row as
    # index_* fields
    ms = median_ms(lambda: codec.compact(flags))
    plain = median_ms(lambda: codec.compact_plain(flags))
    lib = median_ms(lambda: torch.nonzero(flags))
    idx = row(ms, plain, 0.0, n + 8 * len(starts), n, library=lib)
    out["compact"].update({f"index_{key}": idx[key] for key in
                           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"[K-CMP] compact 2^23 rows -> {len(starts)} indices: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, library torch.nonzero "
          f"{lib:.4f} ms; {share(idx)}")

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
    sparse_row = row(ms, plain, 0.0, (1 << 22) + 24 * len(hit), 1 << 22)
    print(f"[K-CMP] compact 2^22 rows -> {len(hit)} (sparse) with payload: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms; {share(sparse_row)}; "
          f"{compact_costs(sparse, values)[0]}")

    out["assemble_chunk"] = compare_assemble(dev)
    time_plan_key_chunks(dev)
    out["weighted_runs"] = compare_weighted_runs(dev)
    out["abundance_hist"] = compare_stats(dev, rng)
    out["geno_sample"] = compare_geno(dev, rng)
    out["run_rows"] = compare_rows(dev, rng)
    out["int_gram"] = compare_gram(dev, rng)
    out["irls"] = compare_irls(dev, rng)
    out["canonical_kmers_mw"] = compare_ext_mw(dev, rng)
    out["run_bounds_mw"] = compare_runs_mw(dev, rng)
    out["assemble_chunk_mw"] = compare_assemble_mw(dev)
    out["geno_sample_mw"] = compare_geno_mw(dev, rng)
    out["partition_ids"] = compare_partition(dev, rng)
    out["fasta_codes"] = compare_fasta(dev, rng)
    return out


def compare_fasta(dev, rng):
    """K-FASTA on the bytes of a kbench sample file (123,777 reads of 150
    bp under 8-byte names) and of a bench sample file (GENOME bases at
    coverage 1 in 150 bp reads): whole calls (the count read included),
    device time and operations from torch.profiler, the bound (bytes in and
    codes out). Returns the kbench sample's row."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    res = {}
    for label, n_reads in (("kbench sample", 123_777),
                           ("bench sample", GENOME // 150)):
        rec = np.empty((n_reads, 160), dtype=np.uint8)
        rec[:, :9] = np.frombuffer(b">r000000\n", dtype=np.uint8)
        rec[:, 9:159] = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, (n_reads, 150))]
        rec[:, 159] = ord("\n")
        raw = torch.from_numpy(rec.reshape(-1)).to(dev)
        codes, strict = codec.fasta_codes(raw, False)
        want, want_strict = codec.fasta_codes_plain(raw, False)
        assert strict and want_strict
        check_equal(f"fasta_codes {label}", codes, want)
        ms = median_ms(lambda: codec.fasta_codes(raw, False))
        dev_ms, n_ops = device_work(lambda: codec.fasta_codes(raw, False))
        plain = median_ms(lambda: codec.fasta_codes_plain(raw, False), reps=5,
                          warmup=1)
        n = raw.numel()
        r = row(ms, plain, 0.0, n + codes.numel(), 30 * n, device_ms=dev_ms)
        print(f"[K-FASTA] fasta_codes {label}, {n} bytes -> {codes.numel()} "
              f"codes: kernel {ms:.4f} ms (device {dev_ms:.4f} ms in {n_ops} "
              f"device ops, torch.profiler), plain (torch on the card) "
              f"{plain:.4f} ms; {share(r)}, {r['bound_ms'] / dev_ms:.1%} of it "
              f"over the device time; library: none (no one call)")
        res[label] = r
    return res["kbench sample"]


def compare_ext_mw(dev, rng):
    """K-EXT's multi-word form at 2^24 codes (INVALID every 151 bytes) for k
    = 63 (two words, 31 bases in the second) and 128 (four full words):
    whole calls and device time (20 launches behind a sleep kernel) against
    the bound. Returns the k = 63 row with the k = 128 one in k128_*."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    res = {}
    n = 1 << 24
    for k in (63, 128):
        codes_np = rng.integers(0, 4, n).astype(np.uint8)
        codes_np[150::151] = codec.INVALID
        codes = torch.from_numpy(codes_np).to(dev)
        keys = codec.canonical_kmers(codes, k)
        check_equal(f"canonical_kmers multi-word {n} codes k={k}", keys,
                    codec.canonical_kmers_mw_plain(codes, k))
        ms = median_ms(lambda: codec.canonical_kmers(codes, k))
        dev_ms = events_ms(lambda: codec.canonical_kmers(codes, k))
        plain = median_ms(lambda: codec.canonical_kmers_mw_plain(codes, k),
                          reps=3, warmup=1)
        nw, w = keys.shape
        # a code in, nw key words out; what a window needs at least: a
        # rolling update of 2 nw words (a shift, an or and the carry into
        # the next word, ~4 operations a word), the lexicographic min (~2 a
        # word) and the validity test: ~12 nw + 8 integer operations
        r = row(ms, plain, 0.0, n + 8 * nw * w, (12 * nw + 8) * w, device_ms=dev_ms)
        print(f"[K-EXT mw] canonical_kmers {n} codes k={k} ({nw} words): kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms over 20 queued launches), "
              f"plain {plain:.4f} ms; {share(r)}, {r['bound_ms'] / dev_ms:.1%} of "
              f"it over the device time; library: none (no one call)")
        res[k] = r
    out = res[63]
    out.update({f"k128_{key}": res[128][key] for key in
                ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by")})
    return out


def mw_run_inputs(dev, rng, nw: int = 2):
    """K-RUN multi-word form's phase-2 input: 2^23 sorted two-word keys
    (random k-mers, the first 2^20 rows sharing 512 leading words, eight
    runs of 2*10^4 copies, a 5,000-row sentinel tail), sorted on the card
    with codec.sort_rows."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    n = 1 << 23
    raw = rng.integers(-(2**62), 2**62, (nw, n), dtype=np.int64)
    raw[0, : 1 << 20] = raw[0, np.arange(1 << 20) % 512]
    raw[:, : 8 * 20_000] = np.repeat(raw[:, :8], 20_000, axis=1)
    raw[:, -5000:] = codec.SENTINEL
    return codec.sort_rows(torch.from_numpy(raw).to(dev))[0]


def compare_runs_mw(dev, rng):
    """K-RUN's multi-word form: the count form on 2^23 two-word keys
    (mw_run_inputs), without starts as sort_rle calls it, against its twin
    and torch.unique_consecutive(dim=0, return_counts=True) on the [N, 2]
    rows; every form checked on the same keys. Whole call, device time
    (torch.profiler: the call waits for its count), bound and the library
    call."""
    import torch

    from kmdiff_tpu_torch.ops import codec

    keys_s = mw_run_inputs(dev, rng)
    nw, n = keys_s.shape
    args = dict(lengths=True, starts=False)
    got = codec.run_encode(keys_s, **args)
    want = codec.run_encode_plain(keys_s, **args)
    for name, g, w in zip(("run keys", "n_valid", "lengths"), got[1:], want[1:]):
        check_equal(f"run_encode multi-word count form {name}", g, w)
    for label, kw in (("dedup", {}), ("count with starts", {"lengths": True})):
        for name, g, w in zip(("starts", "run keys", "n_valid", "third"),
                              codec.run_encode(keys_s, **kw),
                              codec.run_encode_plain(keys_s, **kw)):
            if (g is None) != (w is None):
                raise AssertionError(f"run_encode multi-word {label}: {name}")
            if w is not None:
                check_equal(f"run_encode multi-word {label} {name}", g, w)
    _s, run_keys, n_valid, lengths = got
    rows = keys_s[:, : int(n_valid)].t().contiguous()
    lib_keys, lib_counts = torch.unique_consecutive(rows, dim=0, return_counts=True)
    check_equal("unique_consecutive(dim=0) keys", lib_keys.t(), run_keys)
    check_equal("unique_consecutive(dim=0) counts", lib_counts, lengths.long())
    call = lambda: codec.run_encode(keys_s, **args)  # noqa: E731
    ms, dev_ms = median_ms(call), device_work(call)[0]
    plain = median_ms(lambda: codec.run_encode_plain(keys_s, **args))
    lib_call = lambda: torch.unique_consecutive(rows, dim=0, return_counts=True)  # noqa: E731
    lib, lib_dev = median_ms(lib_call, reps=5, warmup=1), device_work(lib_call, reps=3)[0]
    U = run_keys.shape[1]
    # the keys in; nw words and a length a run and n_valid out; nw
    # compares a row
    r = row(ms, plain, 0.0, 8 * nw * n + (8 * nw + 4) * U + 8, nw * n,
            library=lib, device_ms=dev_ms, form="count")
    print(f"[K-RUN mw] run_encode count form without starts, 2^23 two-word keys -> "
          f"{U} runs (longest {int(lengths.max())}): kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), plain {plain:.4f} ms, library "
          f"torch.unique_consecutive(dim=0) {lib:.4f} ms (device {lib_dev:.4f} ms); "
          f"{share(r)}, {r['bound_ms'] / dev_ms:.1%} of it over the device time")
    return r


def _random_streams_mw(dev, S, U, seed, top, nw=2):
    """S sorted distinct [nw, U] key streams from one pool (rows sorted
    lexicographically), with u32 counts (int32) below top."""
    import torch

    from kmdiff_tpu_torch.ops import codec

    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.randint(-(2**62), 2**62, (nw, 3 * U), generator=gen, device=dev)
    keys, counts = [], []
    for _ in range(S):
        pick = torch.randperm(pool.shape[1], generator=gen, device=dev)[:U]
        keys.append(codec.sort_rows(pool[:, pick])[0].contiguous())
        counts.append(torch.randint(1, top, (U,), generator=gen, device=dev,
                                    dtype=torch.int64).to(torch.int32))
    return keys, counts


def compare_assemble_mw(dev):
    """K-ASM's multi-word form at the merge's shape (assemble_plan) on 20
    two-word streams, p16 (the run's narrow merge) and raw counts with
    sample ids (the full merge): a chunk's whole call and device time (20
    queued launches) against the bound. Returns the p16 row with the full
    form's in full_*."""
    from kmdiff_tpu_torch.pipeline.fused import ChunkTable, assemble_chunk_plain

    S, U, starts, lens = assemble_plan()
    res = {}
    for name, pack16, top, ids in (("p16", True, 1 << 15, False),
                                   ("raw + sample ids", False, 1 << 32, True)):
        keys, counts = _random_streams_mw(dev, S, U, 3, top)
        table = ChunkTable(keys, counts, starts, lens, N_CONTROLS)
        got = table.assemble(0, pack16, ids)
        want = assemble_chunk_plain(keys, counts, starts, lens, N_CONTROLS, pack16, ids)
        for part, g, w in zip(("keys", "counts", "sample ids"), got, want):
            check_equal(f"assemble_chunk multi-word {name} {part}", g, w)
        ms = median_ms(lambda: table.assemble(0, pack16, ids))
        dev_ms = events_ms(lambda: table.assemble(0, pack16, ids))
        plain = median_ms(lambda: assemble_chunk_plain(keys, counts, starts, lens,
                                                       N_CONTROLS, pack16, ids))
        rows = int(lens.sum())
        # each row's two key words and u32 count in; its two words, packed
        # count and (full mode) sample id out
        res[name] = row(ms, plain, 0.0,
                        rows * (20 + 16 + (2 if pack16 else 4) + (2 if ids else 0)),
                        rows, device_ms=dev_ms)
        print(f"[K-ASM mw] assemble_chunk {S} two-word streams -> {rows} rows "
              f"({name}): kernel {ms:.4f} ms (device {dev_ms:.4f} ms over 20 "
              f"queued launches), plain {plain:.4f} ms; {share(res[name])}, "
              f"{res[name]['bound_ms'] / dev_ms:.1%} of it over the device time; "
              f"library: none (no one call)")
    out = res["p16"]
    out.update({f"full_{key}": res["raw + sample ids"][key] for key in
                ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by")})
    return out


def compare_geno_mw(dev, rng):
    """K-GENO's multi-word form on 2^23 two-word run keys at the default
    kmer_pca, as a [:, :U] view of a wider buffer (K-RUN's run keys):
    whole call, device time (20 queued launches), bound."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import merge_dev

    n = 1 << 23
    buf = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, (2, n + 4096),
                                        dtype=np.int64)).to(dev)
    keys = buf[:, :n]
    thr = merge_dev.pca_threshold_u32(0.001)
    mask = merge_dev.geno_sample(keys, thr, 0)
    check_equal("geno_sample multi-word", mask, merge_dev.geno_sample_plain(keys, thr, 0))
    ms = median_ms(lambda: merge_dev.geno_sample(keys, thr, 0))
    dev_ms = events_ms(lambda: merge_dev.geno_sample(keys, thr, 0))
    plain = median_ms(lambda: merge_dev.geno_sample_plain(keys, thr, 0))
    # two key words in, a flag out; ~40 int32 operations a key (four
    # avalanche rounds, the splits and the compare)
    r = row(ms, plain, 0.0, 17 * n, 40 * n, device_ms=dev_ms)
    print(f"[K-GENO mw] geno_sample 2^23 two-word keys at 0.001 "
          f"({int(mask.sum())} sampled): kernel {ms:.4f} ms (device {dev_ms:.4f} "
          f"ms over 20 queued launches), plain {plain:.4f} ms; {share(r)}, "
          f"{r['bound_ms'] / dev_ms:.1%} of it over the device time; library: "
          f"none (no one call)")
    return r


def run_inputs(dev, rng):
    """K-RUN's phase-2 inputs, sorted on the card: the count form's 2^23
    keys (random k-mers, eight runs of 2*10^4 copies, a 5,000-row sentinel
    tail), and the merge form's 2^23 keys of ~1.4 rows a distinct k-mer with
    the sort's permutation and int16 packed counts (control flag in bit
    15). -> (keys_s, mkeys_s, perm, mcount)."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    n = 1 << 23
    raw = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    raw[: 8 * 20_000] = np.repeat(raw[:8], 20_000)
    raw[-5000:] = codec.SENTINEL
    keys_s = torch.sort(torch.from_numpy(raw).to(dev)).values
    half = rng.integers(-(2**62), 2**62, n // 2, dtype=np.int64)
    mkeys = np.concatenate([half, np.where(rng.random(n // 2) < 0.6, half,
                                           half ^ 0x5A5A)])
    mcount = rng.integers(1, 300, n).astype(np.int16)
    mcount[: n // 2] |= np.int16(-0x8000)
    mkeys_s, perm = torch.sort(torch.from_numpy(mkeys).to(dev))
    return keys_s, mkeys_s, perm, torch.from_numpy(mcount).to(dev)


def assemble_plan():
    """K-ASM's phase-2 chunk plan: 20 streams of 900,000 rows, slices of
    780,000-850,000 rows (stream 3 empty). -> (S, U, starts, lens)."""
    import numpy as np

    S, U = N_CONTROLS + N_CASES, 900_000
    rng = np.random.default_rng(11)
    lens = rng.integers(780_000, 850_000, S)
    lens[3] = 0  # a stream with nothing in this key range
    return S, U, rng.integers(0, U - lens + 1), lens


def compare_runs(dev, rng):
    """K-RUN (codec.run_encode) at phase 2's shapes: the count form on 2^23
    sorted keys (random k-mers, eight runs of 2*10^4 copies, a 5,000-row
    sentinel tail), the merge form on 2^23 rows of ~1.4 a run with int16
    packed counts read through the sort's permutation, and the dedup form on
    the merge's keys; every output, with and without the starts, held equal
    to run_encode_plain's. Whole calls, device time (torch.profiler: the
    call waits for its count) and the bound of the count and merge forms
    without starts, as sort_rle and merge_dev.merge_lrt call them, and for
    the count form torch.unique_consecutive, which computes the same run
    keys and lengths. Returns (the count form's row with the
    merge form's in merge_* fields, the count form's sorted keys)."""
    import torch

    from kmdiff_tpu_torch.ops import codec

    keys_s, mkeys_s, perm, mcount_d = run_inputs(dev, rng)
    n = keys_s.numel()
    names = ("starts", "run keys", "n_valid", "third")

    def check(label, got, want):
        for name, g, w in zip(names, got, want):
            if w is None:
                if g is not None:
                    raise AssertionError(f"run_encode {label} returned {name}")
            else:
                check_equal(f"run_encode {label} {name}", g, w)

    got = codec.run_encode(keys_s, lengths=True)
    check("count", got, codec.run_encode_plain(keys_s, lengths=True))
    # the form sort_rle calls: no starts
    count_args = dict(lengths=True, starts=False)
    check("count without starts", codec.run_encode(keys_s, **count_args),
          codec.run_encode_plain(keys_s, **count_args))
    _starts, run_keys, n_valid, lengths = got
    if int(lengths.max()) <= 10_000:
        raise AssertionError("the run test input lost its long runs")
    valid = keys_s[: int(n_valid)]
    lib_keys, lib_counts = torch.unique_consecutive(valid, return_counts=True)
    check_equal("unique_consecutive keys", lib_keys, run_keys)
    check_equal("unique_consecutive counts", lib_counts, lengths.long())

    mgot = codec.run_encode(mkeys_s, perm, mcount_d)
    mwant = codec.run_encode_plain(mkeys_s, perm, mcount_d)
    check("merge", mgot, mwant)
    # the form merge_dev.merge_lrt calls: no starts (the full merge's
    # run_rows reads them)
    check("merge without starts", codec.run_encode(mkeys_s, perm, mcount_d, starts=False),
          codec.run_encode_plain(mkeys_s, perm, mcount_d, starts=False))
    check("dedup", codec.run_encode(mkeys_s), (*mwant[:3], None))

    U, mU = got[0].numel(), mgot[0].numel()
    # timed in the forms the main path calls: sort_rle's and merge_lrt's
    count_call = lambda: codec.run_encode(keys_s, **count_args)  # noqa: E731
    merge_call = lambda: codec.run_encode(mkeys_s, perm, mcount_d, starts=False)  # noqa: E731
    ms, dev_ms = median_ms(count_call), device_work(count_call)[0]
    plain = median_ms(lambda: codec.run_encode_plain(keys_s, **count_args))
    lib_call = lambda: torch.unique_consecutive(valid, return_counts=True)  # noqa: E731
    lib, lib_dev = median_ms(lib_call), device_work(lib_call)[0]
    m_ms, m_dev = median_ms(merge_call), device_work(merge_call)[0]
    m_plain = median_ms(lambda: codec.run_encode_plain(mkeys_s, perm, mcount_d,
                                                       starts=False))
    d_ms = median_ms(lambda: codec.run_encode(mkeys_s))
    # count: the keys in; run keys, lengths and n_valid out; a compare a
    # row. merge: the keys, the permutation and the int16 counts it reads
    # in; run keys, [U, 2] int32 sums and n_valid out; a compare and an add
    # a row
    r = row(ms, plain, 0.0, 8 * n + 12 * U + 8, n, library=lib,
            device_ms=dev_ms, form="count")
    m = row(m_ms, m_plain, 0.0, 18 * n + 16 * mU + 8, 2 * n, device_ms=m_dev)
    r.update({f"merge_{key}": m[key] for key in
              ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"[K-RUN] run_encode count form without starts, 2^23 keys -> {U} runs (longest "
          f"{int(lengths.max())}): kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
          f"plain {plain:.4f} ms, library torch.unique_consecutive {lib:.4f} "
          f"ms (device {lib_dev:.4f} ms); {share(r)}, "
          f"{r['bound_ms'] / dev_ms:.1%} of it over the device time")
    print(f"[K-RUN] run_encode merge form without starts, 2^23 rows -> {mU} runs (int16 "
          f"counts): kernel {m_ms:.4f} ms (device {m_dev:.4f} ms), plain "
          f"{m_plain:.4f} ms; {share(m)}, {m['bound_ms'] / m_dev:.1%} of it over "
          f"the device time; library: none (no one call); dedup form (with "
          f"starts) on the same keys {d_ms:.4f} ms, equal to the merge form's runs")
    return r, keys_s


def full_run_inputs(dev, rng):
    """K-RUN full form's phase-2 inputs, the wide merge's shape: 2^23 rows
    from 20 streams of one key pool (runs of ~7 rows), sorted on the card
    with the sort's permutation; raw u32 counts (int32) below 300 but every
    eighth from 2^31 to 2^32, so that runs sum past 2^32; the rows' sample
    ids. -> (keys_s, perm, count, sample)."""
    import numpy as np
    import torch

    S = N_CONTROLS + N_CASES
    keys, counts = _random_streams(dev, S, (1 << 23) // S, 17, 300)
    count = torch.cat(counts)
    big = rng.integers(2**31, 2**32, len(count[::8]), dtype=np.int64)
    count[::8] = torch.from_numpy(big.astype(np.uint32).view(np.int32)).to(dev)
    sample = torch.cat([torch.full((k.numel(),), s, dtype=torch.int16, device=dev)
                        for s, k in enumerate(keys)])
    keys_s, perm = torch.sort(torch.cat(keys))
    return keys_s, perm, count, sample


def compare_full_runs(dev, rng) -> dict:
    """K-RUN's full form (codec.run_encode with sample ids: int64 sums of
    raw counts, the wide merge's) at full_run_inputs, with and without
    starts, held equal to run_encode_plain's; whole call and device time
    (torch.profiler: the call waits for its count) of the form the wide
    diff calls (no starts). Returns the row's wide_* fields."""
    from kmdiff_tpu_torch.ops import codec

    keys_s, perm, count, sample = full_run_inputs(dev, rng)
    args = dict(sample=sample, nb_controls=N_CONTROLS)
    for starts in (True, False):
        got = codec.run_encode(keys_s, perm, count, starts=starts, **args)
        want = codec.run_encode_plain(keys_s, perm, count, starts=starts, **args)
        for name, g, w in zip(("starts", "run keys", "n_valid", "sums"), got, want):
            if (g is None) != (w is None):
                raise AssertionError(f"run_encode full form: {name} returned or not")
            if w is not None:
                check_equal(f"run_encode full form {name}", g, w)
    sums = got[3]
    if int(sums.max()) < 2**32:
        raise AssertionError("the full-form input lost its sums past 2^32")
    call = lambda: codec.run_encode(keys_s, perm, count, starts=False, **args)  # noqa: E731
    ms, dev_ms = median_ms(call), device_work(call)[0]
    plain = median_ms(lambda: codec.run_encode_plain(keys_s, perm, count, starts=False,
                                                     **args))
    n, U = keys_s.numel(), sums.shape[0]
    # the keys and the permutation in, each row's raw count and sample id
    # gathered; run keys, [U, 2] int64 sums and n_valid out; a compare and
    # an add a row
    r = row(ms, plain, 0.0, 22 * n + 24 * U + 8, 2 * n, device_ms=dev_ms)
    print(f"[K-RUN] run_encode full form without starts, 2^23 rows from "
          f"{N_CONTROLS + N_CASES} streams -> {U} runs (raw u32 counts, "
          f"{int((sums >= 2**32).sum())} sums past 2^32): kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), plain {plain:.4f} ms; {share(r)}, "
          f"{r['bound_ms'] / dev_ms:.1%} of it over the device time; library: none "
          f"(no one call)")
    return {f"wide_{key}": r[key] for key in
            ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by")}


def compare_ext(dev, rng):
    """K-EXT at 2^24 codes (INVALID every 151 bytes: 150 bp reads) for k =
    31, 15, 21, 32, and at one bench sample's codes at k = 31: whole calls
    and device time against the bound. Returns the 2^24, k = 31 row."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    res = {}
    for n, k in ((1 << 24, 31), (1 << 24, 15), (1 << 24, 21), (1 << 24, 32),
                 (SAMPLE_CODES, 31)):
        codes_np = rng.integers(0, 4, n).astype(np.uint8)
        codes_np[150::151] = codec.INVALID
        codes = torch.from_numpy(codes_np).to(dev)
        keys = codec.canonical_kmers(codes, k)
        check_equal(f"canonical_kmers {n} codes k={k}", keys,
                    codec.canonical_kmers_plain(codes, k))
        ms = median_ms(lambda: codec.canonical_kmers(codes, k))
        dev_ms = events_ms(lambda: codec.canonical_kmers(codes, k))
        plain = median_ms(lambda: codec.canonical_kmers_plain(codes, k),
                          reps=5, warmup=1)
        w = n - k + 1
        # a code in, a key out; ~20 integer operations a window (rolling
        # both words, the unsigned min, the validity test)
        r = row(ms, plain, 0.0, n + 8 * w, 20 * w, device_ms=dev_ms)
        print(f"[K-EXT] canonical_kmers {n} codes k={k}: kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms over 20 queued launches), plain "
              f"{plain:.4f} ms; {share(r)}, {r['bound_ms'] / dev_ms:.1%} of "
              f"it over the device time; library: none (no one call)")
        res[n, k] = r
    return res[1 << 24, 31]


def compare_partition(dev, rng):
    """K-PART (codec.partition_targets) at the mesh count's shapes: 2^24
    one-word keys (k = 31) and 2^23 two-word keys (k = 63), and phase 10's
    own calls, a bench sample's SAMPLE_CODES - k + 1 windows over D shards
    (k = 31 and 63), every 151st a sentinel row (a read separator's
    window), 4 partitions, D = 2 and 4: targets and counts equal to the
    twin's, whole calls and device time against the bound. Returns the
    one-word 2^24-key D = 2 row, the others under "shapes" (phase 10's as
    "nw=..,D=..,phase10")."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    res = {}
    cases = [(1, 1 << 24, (2, 4), ""), (2, 1 << 23, (2, 4), "")]
    # phase 10: one round of a sample's windows, ceil(W / D) rows a shard
    cases += [(nw, -(-(SAMPLE_CODES - k + 1) // D), (D,), ",phase10")
              for nw, k in ((1, 31), (2, 63)) for D in (2, 4)]
    for nw, n, Ds, tag in cases:
        words = rng.integers(0, 2**63, (n, nw), dtype=np.uint64) * np.uint64(2)
        words[::151] = np.uint64(0xFFFFFFFFFFFFFFFF)
        keys = torch.from_numpy(codec.words_to_keys(words)).to(dev)
        del words
        for D in Ds:
            t, c = codec.partition_targets(keys, 4, D)
            tp, cp = codec.partition_targets_plain(keys, 4, D)
            check_equal(f"partition_targets nw={nw} D={D} targets", t, tp)
            check_equal(f"partition_targets nw={nw} D={D} counts", c, cp)
            ms = median_ms(lambda: codec.partition_targets(keys, 4, D))
            dev_ms = events_ms(lambda: codec.partition_targets(keys, 4, D))
            plain = median_ms(lambda: codec.partition_targets_plain(keys, 4, D),
                              reps=5, warmup=1)
            # 8 nw bytes in and 4 out a row, the D + 1 counts out; ~20
            # int32 operations a word (two fmix32 rounds and the split) and 4
            # a row (two remainders counted as one each, the sentinel test,
            # the count)
            r = row(ms, plain, 0.0, n * (8 * nw + 4) + 8 * (D + 1),
                    (20 * nw + 4) * n, device_ms=dev_ms)
            print(f"[K-PART] partition_targets {n} keys of {nw} word(s), 4 "
                  f"partitions, D={D}{' (phase 10: a shard of a sample)' if tag else ''} "
                  f"(counts {c.tolist()}): kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f} ms over 20 queued launches), plain "
                  f"{plain:.4f} ms; {share(r)}, {r['bound_ms'] / dev_ms:.1%} of "
                  "it over the device time; library: none (no one call)")
            res[f"nw={nw},D={D}{tag}"] = r
        del keys
    first = res.pop("nw=1,D=2")
    return {**first, "shapes": res}


def compare_geno(dev, rng):
    """K-GENO on 2^23 run keys at the default kmer_pca and a high one."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import merge_dev

    keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, 1 << 23,
                                         dtype=np.int64)).to(dev)
    res = {}
    for rate in (0.001, 0.05):
        thr = merge_dev.pca_threshold_u32(rate)
        mask = merge_dev.geno_sample(keys, thr, 0)
        check_equal(f"geno_sample {rate}", mask,
                    merge_dev.geno_sample_plain(keys, thr, 0))
        ms = median_ms(lambda: merge_dev.geno_sample(keys, thr, 0))
        dev_ms = events_ms(lambda: merge_dev.geno_sample(keys, thr, 0))
        plain = median_ms(lambda: merge_dev.geno_sample_plain(keys, thr, 0))
        # a key in, a flag out; ~21 int32 operations a key (two avalanche
        # rounds of the hash chain, the split and the compare)
        n = keys.numel()
        res[rate] = row(ms, plain, 0.0, 9 * n, 21 * n, device_ms=dev_ms)
        print(f"[K-GENO] geno_sample 2^23 keys at {rate} ({int(mask.sum())} "
              f"sampled): kernel {ms:.4f} ms (device {dev_ms:.4f} ms over 20 "
              f"queued launches), plain {plain:.4f} ms; {share(res[rate])}, "
              f"{res[rate]['bound_ms'] / dev_ms:.1%} of it over the device "
              f"time; library: none (no one call)")
    return res[0.001]


def rows_inputs(dev, rng):
    """K-ROWS's phase-2 inputs, the popstrat merge's shape: 2^23 sorted rows
    from 20 streams with raw u32 counts (the full merge's), every 16th from
    2^31 to 2^32, ~13,700 survivor runs (count rows) and ~12,000 sampled
    ones (presence rows). -> {label: run_rows arguments}, the rows in the
    selected runs of each, the merge's sorted row and run counts."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import codec

    S = N_CONTROLS + N_CASES
    keys, counts = _random_streams(dev, S, (1 << 23) // S, 13, 1 << 12)
    sample = torch.cat([torch.full((k.numel(),), s, dtype=torch.int16, device=dev)
                        for s, k in enumerate(keys)])
    count = torch.cat(counts)
    big = rng.integers(2**31, 2**32, len(count[::16]), dtype=np.int64)
    count[::16] = torch.from_numpy(big.astype(np.uint32).view(np.int32)).to(dev)
    keys_s, perm = torch.sort(torch.cat(keys))
    starts, _keys, n_valid, lengths = codec.run_encode(keys_s, lengths=True)
    U = starts.numel()
    calls, rows_in = {}, {}
    for label, n_sel, presence in (("survivors", 13_700, False),
                                   ("sampled", 12_000, True)):
        sel = torch.from_numpy(np.sort(rng.choice(U, n_sel, replace=False))).to(dev)
        calls[label] = (starts, n_valid, sel, perm, count, sample, S, presence)
        rows_in[label] = int(lengths[sel].sum())
    return calls, rows_in, keys_s.numel(), U


def compare_rows(dev, rng):
    """K-ROWS at the popstrat merge's shape (rows_inputs): each form
    against its twin, its whole call, its device time (CUDA events over 20
    launches queued behind a sleep kernel) and its device operations a
    call (torch.profiler: one, no memset). Returns the survivors' row with
    the sampled form's in shapes["sampled"]."""
    from kmdiff_tpu_torch.ops import merge_dev

    calls, rows_in, n_rows, U = rows_inputs(dev, rng)
    res = {}
    for label, args in calls.items():
        n_sel, S, presence = args[2].numel(), args[6], args[7]
        rows = merge_dev.run_rows(*args)
        check_equal(f"run_rows {label}", rows, merge_dev.run_rows_plain(*args))
        if not presence and not bool((rows < 0).any()):
            raise AssertionError("run_rows: no count at or above 2^31 in the rows")
        call = lambda: merge_dev.run_rows(*args)  # noqa: E731
        ms = median_ms(call)
        plain = median_ms(lambda: merge_dev.run_rows_plain(*args))
        dev_ms, n_ops = events_ms(call), device_work(call)[1]
        if n_ops != 1:
            raise AssertionError(f"run_rows {label}: {n_ops} device operations a call, not 1")
        # the selection, each run's two bounds, and per row of the selected
        # runs its permutation entry, count and sample id in; [H, S] out
        res[label] = row(ms, plain, 0.0,
                         24 * n_sel + 14 * rows_in[label] + n_sel * S * (1 if presence else 4),
                         rows_in[label], device_ms=dev_ms, device_ops=n_ops)
        print(f"[K-ROWS] run_rows {n_sel} {label} of {U} runs of {n_rows} rows "
              f"({rows_in[label]} in the selected runs), S={S}"
              f"{' (presence)' if presence else ''}: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms over 20 queued launches, {n_ops} device operation a "
              f"call), plain {plain:.4f} ms; {share(res[label])}, "
              f"{res[label]['bound_ms'] / dev_ms:.1%} of it over the device time; "
              f"library: none (no one call)")
    out = res["survivors"]
    out["shapes"] = {"sampled": res["sampled"]}
    return out


def gram_bound(shapes):
    """K-GRAM's bytes and operations for blocks of these [B, S] shapes:
    each 0/1 block in, its int64 Gram out; the bit packing (one operation a
    byte), then for each sample pair on or above the diagonal (the kernel
    mirrors the rest) and 32-row word an AND and an add on the int32 pipe
    and a popcount on its own."""
    nbytes, int32, popc = 0, 0, 0
    for B, S in shapes:
        pair_words = S * (S + 1) // 2 * (-(-B // 32))
        nbytes += B * S + 8 * S * S
        int32 += B * S + 2 * pair_words
        popc += pair_words
    return nbytes, {"int32": int32, "popc": popc}


def compare_gram(dev, rng):
    """K-GRAM on the geno blocks of a 20- and a 200-sample cohort: the
    whole call, its device time (20 launches behind a sleep kernel) and its
    device operations a call (torch.profiler). Returns the [2^20, 20] row
    with the [2^18, 200] one in s200_*."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch.ops import pca

    res = {}
    for B, S in ((1 << 20, 20), (1 << 18, 200)):
        X = torch.from_numpy((rng.random((B, S)) < 0.4).astype(np.uint8)).to(dev)
        check_equal(f"int_gram [{B}, {S}]", pca.int_gram(X), pca.int_gram_plain(X))
        ms = median_ms(lambda: pca.int_gram(X))
        dev_ms = events_ms(lambda: pca.int_gram(X))
        n_ops = device_work(lambda: pca.int_gram(X))[1]
        plain = median_ms(lambda: pca.int_gram_plain(X))
        lib = int_mm_ms(X, pca.int_gram(X))
        nbytes, ops = gram_bound([(B, S)])
        res[S] = row(ms, plain, 0.0, nbytes, ops, library=lib, device_ms=dev_ms,
                     device_ops=n_ops)
        print(f"[K-GRAM] int_gram [{B}, {S}]: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms over 20 queued launches, {n_ops} device "
              f"operation(s) a call), plain {plain:.4f} ms; {share(res[S])}, "
              f"{res[S]['bound_ms'] / dev_ms:.1%} of it over the device time; "
              f"library torch._int_mm (int8 0/1 on the tensor cores, S padded to "
              f"{-(-S // 8) * 8}; exact, checked) {lib:.4f} ms")
    out = res[20]
    out.update({f"s200_{key}": res[200][key] for key in
                ("ms", "plain_ms", "device_ms", "device_ops", "bound_ms", "bound_by",
                 "library_ms")})
    return out


def compare_gram_groups(groups) -> dict:
    """K-GRAM on the row-sum group blocks of phase 5's geno matrix, as the
    CUDA popstrat diff gave them to it: each held against the plain twin,
    then the whole sequence timed (a call each, as eigenstrat_pca makes
    them): whole calls, device time (20 sequences behind a sleep kernel)
    and device operations a call (torch.profiler)."""
    from kmdiff_tpu_torch.ops import pca

    shapes = [tuple(X.shape) for X in groups]
    for X in groups:
        check_equal(f"int_gram {list(X.shape)}", pca.int_gram(X), pca.int_gram_plain(X))

    def calls():
        for X in groups:
            pca.int_gram(X)

    def plain_calls():
        for X in groups:
            pca.int_gram_plain(X)

    ms = median_ms(calls)
    dev_ms = events_ms(calls)
    n_ops = device_work(calls)[1] / len(groups)
    plain = median_ms(plain_calls)
    nbytes, ops = gram_bound(shapes)
    r = row(ms, plain, 0.0, nbytes, ops)
    print(f"[K-GRAM] phase 5's {len(groups)} row-sum groups, [B, S]: {shapes}")
    print(f"[K-GRAM] int_gram over those groups, a call each: kernel {ms:.4f} ms "
          f"(device {dev_ms:.4f} ms over 20 queued sequences, {n_ops:.2f} device "
          f"operations a call), plain {plain:.4f} ms; {share(r)}, "
          f"{r['bound_ms'] / dev_ms:.1%} of it over the device time; library: "
          f"none (one call a group)")
    out = {f"groups_{key}": r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
    out.update(groups_device_ms=dev_ms, groups_device_ops=n_ops,
               groups_shapes=[list(sh) for sh in shapes])
    return out


def int_mm_ms(X, gram) -> float:
    """torch._int_mm on a 0/1 block as int8, its sample count padded with
    zero columns to a multiple of 8: the Gram in int32 on the tensor cores,
    exact while the rows stay below 2^31; held equal to K-GRAM's, then
    timed (the cast and the padding are made before the timed region)."""
    import torch

    B, S = X.shape
    Sp = -(-S // 8) * 8
    Xt = torch.zeros((Sp, B), dtype=torch.int8, device=X.device)
    Xt[:S] = X.t()
    rhs = Xt.t()  # [B, Sp], column-major
    try:
        got = torch._int_mm(Xt, rhs)
    except RuntimeError as e:  # a build that takes the right side row-major
        print(f"[K-GRAM] torch._int_mm refused a column-major right side ({e}); "
              "row-major")
        rhs = rhs.contiguous()
        got = torch._int_mm(Xt, rhs)
    check_equal(f"torch._int_mm [{B}, {S}]", got[:S, :S].to(torch.int64), gram)
    return median_ms(lambda: torch._int_mm(Xt, rhs))


def compare_irls(dev, rng):
    """K-IRLS on 2^14 popstrat alt fits (tools/irls_seeds.py irls_inputs):
    a conditioned shared design [1 | PCs | totals] and each item's centered,
    max-abs-scaled count-ratio column; item 0 constant (singular), item 1
    separating the labels. Judged with an f64 refit as witness (irls_seeds
    judge): fits at a maximum agree with the twin; separated or diverged
    fits, chaotic in any precision, are counted. Then the block's first
    1,024 fits, popstrat's launch size (a spill block's k-mers), launched
    alone: bit-identical to the same fits in the 2^14 launch (irls_seeds
    bit_faults). Whole calls and device time (CUDA events over 20 launches
    queued behind a sleep kernel) at both counts. Returns the n = 20, 2^14
    row with the other shapes' rows in shapes."""
    import torch

    from kmdiff_tpu_torch.ops import glm
    from kmdiff_tpu_torch.tools.irls_seeds import (bit_faults, irls_inputs, judge,
                                                   well_posed, witness)

    B = 1 << 14
    small = 1024
    res = {}
    for n, F in ((20, 5), (200, 12)):
        args = irls_inputs(rng, n, F, B, dev)
        w, _e, it, ll, stop = got = glm.irls(*args)
        want = glm.irls_plain(*args)
        it_p, ll_p = want[2], want[3]
        wit = witness(args)
        faults = judge(got, want, wit, args[2])
        if faults:
            raise AssertionError(f"irls n={n}: " + "; ".join(faults))
        if int(stop[0]) != 1 or not bool(torch.isfinite(w).all()):
            raise AssertionError(f"irls n={n}: the singular item did not freeze")
        well = well_posed(args[2], wit)
        same_it = it == it_p
        compared = well & same_it
        ill_apart = int((~well & ~torch.isclose(ll, ll_p, rtol=1e-5, atol=1e-4)).sum())
        err = float((ll - ll_p)[compared].abs().max())
        sargs = (args[0], args[1][:small].contiguous(), args[2])
        sgot = glm.irls(*sargs)
        faults = bit_faults(sgot, tuple(t[:small] for t in got))
        if faults:
            raise AssertionError(f"irls n={n}: {small} fits alone differ from the same "
                                 "fits among 2^14: " + "; ".join(faults))
        for items, a, its in ((B, args, it), (small, sargs, sgot[2])):
            call = lambda a=a: glm.irls(*a)  # noqa: E731
            ms = median_ms(call, reps=7, warmup=1)
            dev_ms = events_ms(call)
            plain = median_ms(lambda a=a: glm.irls_plain(*a), reps=5, warmup=1)
            # f32 flops over the measured iterations: per iteration the
            # Hessian's F(F+1)/2 distinct entries (nF(F+1); the kernel
            # mirrors the rest), the right-hand side and the new linear
            # predictor (4nF), the weights and error (~20n) and the solve
            # (2F^3/3 + 2F^2); then the log-likelihood (2nF + 20n). Bytes:
            # the shared design, the ratio columns and the labels in; w,
            # err, iters, ll and stop out.
            per_it = n * F * (F + 1) + 4 * n * F + 20 * n + 2 * F ** 3 / 3 + 2 * F * F
            flops = float(its.sum()) * per_it + items * (2 * n * F + 20 * n)
            r = res[n, items] = row(ms, plain, err,
                                    4 * n * F + 4 * items * n + 4 * n + items * (4 * F + 13),
                                    flops, "f32", device_ms=dev_ms)
            print(f"[K-IRLS] irls {items} items n={n} F={F}: kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f} ms over 20 queued launches), plain "
                  f"{plain:.4f} ms; iters {int(its.min())}-{int(its.max())}; "
                  f"{share(r)}, {r['bound_ms'] / dev_ms:.1%} of it over the device "
                  f"time; library: none (no one call)")
        print(f"[K-IRLS] irls {B} items n={n} F={F}: iters equal to the twin's on "
              f"{float(same_it.float().mean()):.4%}, stops "
              f"{torch.bincount(stop.long(), minlength=3).tolist()}; {int(well.sum())} "
              f"fits at a maximum in f64, max|dll| {err:.3g} over those at equal "
              f"iteration counts; {int((~well).sum())} separated or diverged, "
              f"{ill_apart} of them beyond rtol 1e-5 / atol 1e-4; the first {small} "
              f"alone bit-identical to the same fits among {B}")
    out = res[20, B]
    out["shapes"] = {f"n={n},B={items}": r for (n, items), r in res.items()
                     if (n, items) != (20, B)}
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
    """K-ASM at the merge's shape: a ~2^24-row chunk from 20 streams, in
    both packings and with sample ids. The whole call is a chunk's
    (ChunkTable.assemble: outputs allocated, one launch); the table, built
    once a merge, is timed apart."""
    from kmdiff_tpu_torch.pipeline.fused import ChunkTable, assemble_chunk_plain

    S, U, starts, lens = assemble_plan()
    res = {}
    # the full merge's chunks (popstrat, --save-sk, wide sums) carry raw
    # counts and sample ids: K-ASM is given no control streams
    for name, pack16, top, ids in (("p16", True, 1 << 15, False),
                                   ("p32", False, 1 << 32, False),
                                   ("raw + sample ids", False, 1 << 32, True)):
        keys, counts = _random_streams(dev, S, U, 3, top)
        table = ChunkTable(keys, counts, starts, lens, N_CONTROLS)
        got = table.assemble(0, pack16, ids)
        want = assemble_chunk_plain(keys, counts, starts, lens, N_CONTROLS, pack16, ids)
        for part, g, w in zip(("keys", "counts", "sample ids"), got, want):
            check_equal(f"assemble_chunk {name} {part}", g, w)
        ms = median_ms(lambda: table.assemble(0, pack16, ids))
        dev_ms = events_ms(lambda: table.assemble(0, pack16, ids))
        build = median_ms(lambda: ChunkTable(keys, counts, starts, lens, N_CONTROLS))
        plain = median_ms(lambda: assemble_chunk_plain(keys, counts, starts, lens,
                                                       N_CONTROLS, pack16, ids))
        # each row's key and u32 count in; its key, packed count and (full
        # mode) sample id out
        rows = int(lens.sum())
        res[name] = row(ms, plain, 0.0,
                        rows * (12 + 8 + (2 if pack16 else 4) + (2 if ids else 0)),
                        rows, device_ms=dev_ms)
        print(f"[K-ASM] assemble_chunk {S} streams -> {rows} rows "
              f"({name}): kernel {ms:.4f} ms (device {dev_ms:.4f} ms over 20 "
              f"queued launches; the table, once a merge, {build:.4f} ms), "
              f"plain {plain:.4f} ms; {share(res[name])}, "
              f"{res[name]['bound_ms'] / dev_ms:.1%} of it over the device "
              f"time; library: none (no one call)")
    return res["p16"]


def time_plan_key_chunks(dev) -> None:
    """plan_key_chunks (pipeline/fused.py: the port of _bounds_pos_impl and
    _subsample_split_impl, plain torch: a strided subsample of every
    stream's keys read to the host, quantile bounds, torch.searchsorted) on
    phase 4's plan: 20 resident streams of 4,700,000 keys (~94 M rows) cut
    into chunks of at most FUSED_CHUNK_ROWS. Whole calls (the plan is read
    on the host). Bound: the subsample's keys read, each bound's binary
    search (ceil(log2(U + 1)) keys a stream), the bounds in, the plan out."""
    import math

    import numpy as np

    from kmdiff_tpu_torch.pipeline import fused

    S, U = N_CONTROLS + N_CASES, 4_700_000
    keys, counts = _random_streams(dev, S, U, 5, 1 << 15)
    streams = [fused.ResidentStream(k, c, U, 0, np.zeros(fused.HIST_BINS, np.int64),
                                    U, U) for k, c in zip(keys, counts)]
    starts, lens = fused.plan_key_chunks(streams)
    C = len(lens)
    ends = starts + lens
    if (int(lens.sum(1).max()) > fused.FUSED_CHUNK_ROWS or starts[0].any()
            or (ends[:-1] != starts[1:]).any() or (ends[-1] != U).any()):
        raise AssertionError(f"plan_key_chunks: a plan of {C} chunks does not "
                             f"tile the {S} streams within the budget")
    ms = median_ms(lambda: fused.plan_key_chunks(streams))
    stride = min(1024, max(1, fused.FUSED_CHUNK_ROWS // 32))
    pooled = S * -(-U // stride)
    probes = (C - 1) * S * math.ceil(math.log2(U + 1))
    b_ms, b_by = bound(8 * (pooled + probes + C - 1) + 16 * C * S)
    print(f"[plan_key_chunks] {S} streams x {U} keys -> {C} chunks (at most "
          f"{int(lens.sum(1).max())} rows): {ms:.4f} ms a whole call "
          f"(median of 15); bound {b_ms:.6f} ms ({b_by}: {pooled} subsampled "
          f"keys, {probes} search probes), {b_ms / ms:.2%} of it; plain: "
          f"itself (plain torch); library: none")


def compare_weighted_runs(dev):
    """K-WRUN at a multi-chunk sample's shape: three overlapping distinct
    streams of 2^22 keys, their counts summed per k-mer, hard-min 2."""
    import torch

    from kmdiff_tpu_torch.ops import codec

    keys, counts = _random_streams(dev, 3, 1 << 22, 5, 40)
    keys, weights = torch.cat(keys), torch.cat(counts)
    keys_s, perm = torch.sort(keys)
    starts, _keys, n_valid, run_rows = codec.run_encode(keys_s, lengths=True)
    args = (starts, n_valid, perm, weights)
    sums = codec.weighted_run_sums(*args)
    check_equal("weighted_run_sums", sums, codec.weighted_run_sums_plain(*args))
    kept, kept_counts, _stats = codec.dedup_sum(keys, weights, hard_min=2)
    if kept.numel() != int((sums >= 2).sum()) or int(kept_counts.min()) < 2:
        raise AssertionError("dedup_sum: hard-min 2 kept the wrong runs")
    ms = median_ms(lambda: codec.weighted_run_sums(*args))
    plain = median_ms(lambda: codec.weighted_run_sums_plain(*args))
    # starts, n_valid, the permutation and the u32 weights it reads in;
    # int64 sums out
    U, n = starts.numel(), keys.numel()
    r = row(ms, plain, 0.0, 16 * U + 8 + 12 * n, n)
    print(f"[K-WRUN] weighted_run_sums {U} runs of {n} "
          f"rows (1 to {int(run_rows.max())} rows a run), {kept.numel()} kept at "
          f"hard-min 2: kernel {ms:.4f} ms, plain {plain:.4f} ms; {share(r)}; "
          f"library: none (no one call: a gather, then a segment sum)")
    return r


def stats_inputs(dev, rng):
    """K-HIST's phase-2 inputs at a sample's shape: 2^23 counts, mostly 1
    (geometric, p = 0.6), every 4096th from 256 to 2^31, as sort_rle's
    int32 run lengths (a view 8 bytes past a 16-byte boundary, as K-RUN's
    buffer may hand them out) and as dedup_sum's int64 sums, and a device
    n_valid. -> (n_valid, counts, sums)."""
    import numpy as np
    import torch

    n = 1 << 23
    c = np.minimum(rng.geometric(0.6, n), 255).astype(np.int32)
    c[:: 1 << 12] = rng.integers(256, 2**31, len(c[:: 1 << 12]))
    counts = torch.empty(n + 2, dtype=torch.int32, device=dev)[2:]
    counts.copy_(torch.from_numpy(c))
    n_valid = torch.tensor([3 * n], dtype=torch.int64, device=dev)
    return n_valid, counts, torch.from_numpy(c.astype(np.int64)).to(dev)


def compare_stats(dev, rng):
    """K-HIST (codec.rle_stats) in its callers' forms, sort_rle's int32
    counts and dedup_sum's int64 sums, held equal to rle_stats_plain, with
    one device operation a call; whole calls, device time (torch.profiler:
    the call waits for its kernel), and torch.bincount on the int32 counts
    clamped to 256 (the histogram alone) as the library call. Returns the
    int32 form's row with the int64 form's in wide_* fields."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec

    n_valid, counts, sums = stats_inputs(dev, rng)
    res = {}
    for label, c in (("int32", counts), ("int64", sums)):
        got = codec.rle_stats(n_valid, c, True)
        want = codec.rle_stats_plain(n_valid, c, True)
        if ((got.n_valid, got.max_count) != (want.n_valid, want.max_count)
                or not np.array_equal(got.hist, want.hist)):
            raise AssertionError(f"rle_stats {label}: kernel and plain twin differ")
        if got.hist[256] < 2048:
            raise AssertionError("the histogram test input lost its tail")
        call = lambda: codec.rle_stats(n_valid, c, True)  # noqa: E731
        before = kernels.launch_counts()["abundance_hist"]
        call()
        launched = kernels.launch_counts()["abundance_hist"] - before
        dev_ms, n_ops = device_work(call)
        if launched != 1 or n_ops != 1:
            raise AssertionError(f"rle_stats {label}: {launched} launches, "
                                 f"{n_ops} device operations a call")
        ms = median_ms(call)
        plain = median_ms(lambda: codec.rle_stats_plain(n_valid, c, True))
        # the counts and n_valid in; n_valid, the max and 257 bins out; a
        # compare a count
        n = c.numel()
        res[label] = row(ms, plain, 0.0, c.element_size() * n + 8 + 8 * (2 + codec.HIST_BINS),
                         n, device_ms=dev_ms)
        print(f"[K-HIST] rle_stats 2^23 {label} counts ({got.hist[1]} at 1, "
              f"{got.hist[256]} above 255, max {got.max_count}): kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms, 1 launch, 1 device operation, 1 host sync), "
              f"plain {plain:.4f} ms; {share(res[label])}, "
              f"{res[label]['bound_ms'] / dev_ms:.1%} of it over the device time")
    # the library call on counts clamped to 256 before the timed region
    clamped = codec._u32(counts).clamp_max(codec.HIST_BINS - 1)
    hist = torch.bincount(clamped, minlength=codec.HIST_BINS)
    if not np.array_equal(hist.cpu().numpy(), got.hist):
        raise AssertionError("bincount and rle_stats differ")
    out = res["int32"]
    out["library_ms"] = median_ms(lambda: torch.bincount(clamped, minlength=codec.HIST_BINS))
    print(f"[K-HIST] library torch.bincount on the clamped int32 counts: "
          f"{out['library_ms']:.4f} ms")
    out.update({f"wide_{key}": res["int64"][key] for key in
                ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by")})
    return out


def device_work(fn, reps: int = 10) -> tuple[float, int]:
    """Device ms and device operations (kernels, memsets, copies) per call
    of fn, from torch.profiler. A profiler session now and then returns no
    device records at all (once in seven runs of this script on an H100);
    such a session is repeated, up to three sessions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            return sum(spans) / reps / 1e3, round(len(spans) / reps)
        print(f"torch.profiler recorded no device time (session {attempt + 1} of 3)")
    raise AssertionError("torch.profiler recorded no device time in three sessions")


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


#: phases 3-8 drive the single-device main path: the CLI's --devices
#: defaults to every card of the machine, so their count, diff and run
#: commands take --devices 1; phases 9 and 10 set their own
ONE_SHARD = ("--devices", "1")


def cli_main(argv: list, device) -> int:
    """The port's CLI, one shard for count, diff and run (ONE_SHARD)."""
    from kmdiff_tpu_torch.cli import main

    return main(_one_shard(argv), device=device)


def cli_args(argv: list):
    """The port's CLI arguments, one shard for count, diff and run."""
    from kmdiff_tpu_torch.cli import parse_args

    return parse_args(_one_shard(argv))


def _one_shard(argv: list) -> list:
    return [*argv, *ONE_SHARD] if argv[0] in ("count", "diff", "run") else argv


def _diff_cpu_vs_gpu(dev, args, label, alpha, k=31):
    """Run `diff` with args on the CPU (and on `dev` unless out_gpu of this
    label exists); require byte-identical FASTA of k-mers with p < alpha.
    Returns (k-mers tested, {group: significant k-mers})."""
    outs = {}
    for name, where in (("gpu", dev), ("cpu", "cpu")):
        out = os.path.join(WORK, f"{label}_{name}")
        if not os.path.exists(out):
            cli_main([*args, "--output-dir", out], device=where)
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
            if len(seq) != k or not 0.0 <= p < alpha:
                raise AssertionError(f"{label} {g}: bad record {name} {seq}")
        n_sig[g] = len(recs)
    return tested[0], n_sig


def simulate_cohort(dev) -> str:
    """popsim of the bench cohort into WORK/sim; returns its fof."""

    sim = os.path.join(WORK, "sim")
    t0 = time.perf_counter()
    cli_main(["popsim", "-o", sim, "--genome-len", str(GENOME), "-1",
          str(N_CONTROLS), "-2", str(N_CASES), "--read-size", "150",
          "--coverage", "1", "--error-rate", "0.001", "--random-seed", "7"],
         device=dev)
    print(f"[cohort] {N_CONTROLS}+{N_CASES} samples x {GENOME} bp, 150 bp "
          f"reads, coverage 1 (simulated in {time.perf_counter() - t0:.1f} s)")
    return os.path.join(sim, "fof.txt")


def run_main_path(dev) -> dict:
    """Phase 3: popsim -> count -> diff on CUDA, then the CPU reruns."""
    from kmdiff_tpu_torch import kernels

    fof = simulate_cohort(dev)
    run = os.path.join(WORK, "run")
    count_args = ["count", "--file", fof, "--kmer-size", "31", "--hard-min",
                  "1", "--nb-partitions", "4", "--threads", "4"]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main([*count_args, "--run-dir", run], device=dev)
    t_count = time.perf_counter() - t0
    t0 = time.perf_counter()
    diff_args = ["diff", "--km-run-dir", run, "-1", str(N_CONTROLS), "-2",
                 str(N_CASES), "--threads", "4"]
    cli_main([*diff_args, "--output-dir", os.path.join(WORK, "defaults_gpu")],
         device=dev)
    t_diff = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[main path] count {t_count:.3f} s, diff {t_diff:.3f} s "
          f"(wall, CUDA); launches {launches}")
    require_launches("count + diff", launches, COUNT_DIFF_KERNELS)

    t0 = time.perf_counter()
    tested, n_sig = _diff_cpu_vs_gpu(dev, diff_args, "defaults", 0.05)
    print(f"[main path] {tested} k-mers tested, significant {n_sig}; "
          f"CPU+CUDA rerun {time.perf_counter() - t0:.3f} s, FASTA "
          f"byte-identical")
    # the defaults (alpha 0.05 over ~10^7 tests, Bonferroni) may keep no
    # k-mer of a coverage-1 cohort; a looser cut exercises non-empty
    # survivor sets on the same run dir
    loose = [*diff_args, "-s", "0.001", "--cutoff", "1", "-c", "disabled"]
    t0 = time.perf_counter()
    _tested, n_loose = _diff_cpu_vs_gpu(dev, loose, "loose", 0.001)
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
    cli_main([*count_args[:2], fof0, *count_args[3:], "--run-dir", run0],
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
RUN_KERNELS = (*COUNT_DIFF_KERNELS, "assemble_chunk", "abundance_hist",
               "fasta_codes")


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
    from kmdiff_tpu_torch.cli import count_options, diff_options
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
        args = cli_args([*base, *extra, "--run-dir", run_dir,
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


#: the kernels a popstrat path launches
POP_KERNELS = ("run_bounds", "compact", "run_rows", "geno_sample", "int_gram",
               "irls", "lrt_filter")
POP_ARTIFACTS = ("gwas_eigenstratX.geno", "gwas_eigenstratX.snp",
                 "gwas_eigenstratX.ind", "gwas_eigenstratX.total", "control.ind",
                 "case.ind", "parfile.txt", "pcs.evec")


#: the popstrat `diff`s on CUDA and on the CPU: at most this many corrected
#: k-mers (bar those within 1% of alpha) in one FASTA only, as measured on
#: the bench cohort (NVIDIA H100 80GB HBM3, 700 W); each one a quasi-separated
#: alt fit that f32 IRLS drove to p = 1 on one side only
KNIFE_EDGES_MAX = 50
#: check_popstrat_fasta judges how the k-mers in one FASTA only split
#: between the sides, and how the f64 refit sides, in distinct alt designs,
#: and only from this many up: a variant's k-mers often share their count
#: ratios, so one design (one fit) can be dozens of k-mers, and a split of
#: fewer designs is a few tosses of a coin (tools/knife_edges.py: 12 k-mers
#: of 2 designs at k = 63 on the bench cohort, NVIDIA H100 80GB HBM3, 700 W)
SPLIT_MIN_DESIGNS = 4


def check_popstrat_fasta(dev, opt, run_dir, gpu, cpu, alpha) -> str:
    """Phases 5(a) and 7(b)'s FASTA check, CUDA against CPU
    (tools.knife_edges.compare refits every alt fit): the refits must give
    each run's FASTA; the k-mers in both FASTA agree within 1% relative; the
    ones in one only, bar those within 1% of alpha, are at most
    KNIFE_EDGES_MAX, each p = 1 on one side; counted in distinct alt designs
    (k-mers with equal count ratios share one fit), and from
    SPLIT_MIN_DESIGNS of them up, neither side holds under a quarter of
    them, and the f64 refit, which shares no f32 rounding with either side,
    sides with each on at least a quarter; and the kernel's significant set
    lies no further from the f64 one than its twin's. The report (and a
    failure) ends with knife_edges.describe."""
    import numpy as np

    from kmdiff_tpu_torch.tools import knife_edges

    cmp = knife_edges.compare(dev, opt, run_dir, gpu, cpu, alpha,
                              N_CONTROLS + N_CASES)
    sig, ps, only, design = cmp["sig"], cmp["ps"], cmp["only"], cmp["design"]
    gpu_only, cpu_only = cmp["gpu_only"], cmp["cpu_only"]
    if sig["gpu"] != set(cmp["got"]) or sig["cpu"] != set(cmp["want"]):
        raise AssertionError("popstrat diff: the refitted alt models do not "
                             "give the FASTA's k-mers")
    if cmp["rel"] > 0.01:
        raise AssertionError(f"popstrat diff: p-values {cmp['rel']:.3g} apart (relative)")
    why = knife_edges.describe(dev, opt, run_dir, gpu, cpu, cmp, alpha)
    n_designs = len(set(design.values()))
    held = {s: {design[k] for k in ks} for s, ks in (("gpu", gpu_only), ("cpu", cpu_only))}
    right = {s: {design[k] for k in only if (k in sig[s]) == (k in sig["f64"])}
             for s in ("gpu", "cpu")}
    split = n_designs >= SPLIT_MIN_DESIGNS
    if len(only) > KNIFE_EDGES_MAX or (
            split and 4 * min(len(d) for d in held.values()) < n_designs):
        raise AssertionError(f"popstrat diff: {len(gpu_only)} k-mers on CUDA only "
                             f"({len(held['gpu'])} designs), {len(cpu_only)} on the "
                             f"CPU only ({len(held['cpu'])}) (at most "
                             f"{KNIFE_EDGES_MAX} k-mers; of {n_designs} designs, "
                             f"neither side under a quarter); {why}")
    at = np.isin(cmp["kmers"], sorted(only))
    if not (np.maximum(ps["gpu"][at], ps["cpu"][at]) == 1.0).all():
        raise AssertionError("popstrat diff: a k-mer in one FASTA only is no "
                             f"knife edge of f32 IRLS (p = 1 on one side); {why}")
    miss = {s: len(sig[s] ^ sig["f64"]) for s in ("gpu", "cpu")}
    if (split and 4 * min(len(d) for d in right.values()) < n_designs) or \
            miss["gpu"] > miss["cpu"]:
        raise AssertionError(f"popstrat diff: against the f64 refit, CUDA is "
                             f"right on {len(right['gpu'])} of the {n_designs} "
                             f"designs in one FASTA only and the CPU on "
                             f"{len(right['cpu'])}; CUDA's set is {miss['gpu']} "
                             f"k-mers off f64's, the CPU's {miss['cpu']}; {why}")
    return (f"{len(cmp['both'])} k-mers in both FASTA, p-values within "
            f"{cmp['rel']:.3g} relative; {len(gpu_only)} on CUDA only and "
            f"{len(cpu_only)} on the CPU only, each p = 1 on one side "
            f"(quasi-separated), {n_designs} distinct alt designs, "
            f"{len(held['gpu'])} on CUDA's side and {len(held['cpu'])} on the "
            f"CPU's; the f64 refit sides with CUDA on {len(right['gpu'])} designs, "
            f"with the CPU on {len(right['cpu'])}"
            f"{'' if split else f' (under {SPLIT_MIN_DESIGNS} designs: no split judged)'}"
            f"; f64's significant set ({len(sig['f64'])}) differs from CUDA's by "
            f"{miss['gpu']} k-mers, from the CPU's by {miss['cpu']}; "
            f"{len((set(cmp['got']) ^ set(cmp['want'])) & cmp['near'])} within 1% "
            f"of alpha in one only; {why}")


def run_popstrat(dev, phase3) -> tuple:
    """Phase 5: diff (CUDA, then CPU) and run (CUDA) with popstrat and
    --save-sk; returns the launch counts of the CUDA diff and of the run,
    the blocks K-GRAM took in the CUDA diff (one a row-sum group), and the
    walls of the loose diff without popstrat and of the popstrat diffs."""
    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.cli import count_options, diff_options
    from kmdiff_tpu_torch.cmd.diff import main_diff
    from kmdiff_tpu_torch.cmd.run import main_run
    from kmdiff_tpu_torch.ops import pca

    loose = ["-1", str(N_CONTROLS), "-2", str(N_CASES), "--threads", "4", "-s",
             "0.001", "--cutoff", "1", "-c", "disabled"]
    flags = [*loose, "--pop-correction", "--save-sk", "--keep-tmp"]
    # the same diff without popstrat, in this call, as the reference wall
    t0 = time.perf_counter()
    main_diff(diff_options(cli_args(
        ["diff", "--km-run-dir", phase3["run"], *loose, "--output-dir",
         os.path.join(WORK, "pop_base")])), dev)
    walls = {"loose diff": time.perf_counter() - t0}
    print(f"[popstrat base] loose diff without popstrat: "
          f"{walls['loose diff']:.3f} s wall (CUDA)")
    outs, launches = {}, {}
    # K-GRAM's inputs on CUDA, one block a row-sum group (compare_gram_groups)
    groups = []
    real_gram = pca.int_gram

    def gram_spy(X):
        if X.is_cuda:
            groups.append(X.clone())
        return real_gram(X)

    for label, where in (("gpu", dev), ("cpu", torch.device("cpu"))):
        out = os.path.join(WORK, f"pop_{label}")
        args = cli_args(["diff", "--km-run-dir", phase3["run"], *flags,
                           "--output-dir", out])
        timings = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pca.int_gram = gram_spy
        try:
            res = main_diff(diff_options(args), where, timings)
        finally:
            pca.int_gram = real_gram
        wall = time.perf_counter() - t0
        walls[f"popstrat diff {label}"] = wall
        launches[label] = kernels.launch_counts()
        print(f"[popstrat diff {label}] {wall:.3f} s wall (PCA "
              f"{timings['pca']:.3f} s, null fit {timings['null_fit']:.3f} s, "
              f"alt fits {timings['alt_fits']:.3f} s); {res['total_kmers']} "
              f"k-mers tested, significant {res['control']} control / "
              f"{res['case']} case; launches {launches[label]}")
        outs[label] = out
    require_launches("popstrat diff", launches["gpu"], POP_KERNELS)
    gpu, cpu = outs["gpu"], outs["cpu"]
    for name in POP_ARTIFACTS:
        if not _same_bytes(os.path.join(gpu, "popstrat", name),
                           os.path.join(cpu, "popstrat", name)):
            raise AssertionError(f"popstrat diff {name}: CUDA and CPU differ")
    mdir = os.path.join("positive_kmer_matrix", "matrices")
    mats = sorted(os.listdir(os.path.join(gpu, mdir)))
    if not mats or mats != sorted(os.listdir(os.path.join(cpu, mdir))):
        raise AssertionError(f"popstrat diff: --save-sk matrices {mats}")
    for name in mats:
        if not _same_bytes(os.path.join(gpu, mdir, name),
                           os.path.join(cpu, mdir, name)):
            raise AssertionError(f"popstrat diff {name}: CUDA and CPU differ")
    # the alt fits are f32 with other summation orders on the two sides: a
    # k-mer whose p-value lies within 1% of alpha may fall on either side,
    # and so may one whose fit is quasi-separated (check_popstrat_fasta)
    report = check_popstrat_fasta(dev, diff_options(args), phase3["run"], gpu,
                                  cpu, 0.001)
    print(f"[check] popstrat diff: artifacts and {len(mats)} --save-sk matrices "
          f"byte-identical CUDA vs CPU; {report}")

    run_dir = os.path.join(WORK, "pop_run")
    out = os.path.join(WORK, "pop_run_out")
    args = cli_args(["run", "--file", phase3["fof"], "--kmer-size", "31",
                       "--hard-min", "1", "--nb-partitions", "4", *flags,
                       "--run-dir", run_dir, "--output-dir", out])
    timings = {}
    kernels.reset_launch_counts()
    res = main_run(count_options(args), diff_options(args), dev,
                   recurrence_min=args.recurrence_min,
                   count_files=not args.no_count_files, timings=timings)
    run_launches = kernels.launch_counts()
    if "merge" not in timings:
        raise AssertionError("popstrat run was not served by the fused path")
    require_launches("popstrat run", run_launches,
                     (*POP_KERNELS, "assemble_chunk"))
    for name in ("control_kmers.fasta", "case_kmers.fasta",
                 os.path.join("popstrat", "pcs.evec")):
        if not _same_bytes(os.path.join(out, name), os.path.join(gpu, name)):
            raise AssertionError(f"popstrat run {name} differs from diff's")
    geno = [sorted(open(os.path.join(d, "popstrat", "gwas_eigenstratX.geno"))
                   .read().splitlines()) for d in (out, gpu)]
    if geno[0] != geno[1]:
        raise AssertionError("popstrat run: .geno rows differ from diff's")
    print(f"[popstrat run] count {timings['count']:.3f} s, merge "
          f"{timings['merge']:.3f} s, PCA {timings['pca']:.3f} s, null fit "
          f"{timings['null_fit']:.3f} s, alt fits {timings['alt_fits']:.3f} s, "
          f"total {timings['total']:.3f} s (wall, CUDA); significant "
          f"{res['control']} control / {res['case']} case; FASTA and pcs.evec "
          f"byte-identical to diff's, {len(geno[0])} .geno rows, the same "
          f"multiset; launches {run_launches}")
    if len(groups) != launches["gpu"]["int_gram"]:
        raise AssertionError(f"popstrat diff: {len(groups)} K-GRAM blocks recorded, "
                             f"{launches['gpu']['int_gram']} launches")
    return launches["gpu"], run_launches, groups, walls


#: phase 6's wide cohort: a shared pool of ~6 M k-mers, ~2^22 of them a
#: sample: WIDE_CORE in every sample (the genome's, Poisson counts, mean
#: 30), the rest of the sample's from the pool's others at count 1
#: (sequencing errors); 2,000 core k-mers case-enriched 4x, and 8 k-mers
#: with counts from 1.5e9 to 3.1e9 in several samples
WIDE_POOL = 6_000_000
WIDE_CORE = 3_800_000
WIDE_PER_SAMPLE = 1 << 22
WIDE_ENRICHED = 2000
WIDE_HUGE = 8
WIDE_SEED = 10
#: the kernels a wide diff launches (popstrat adds its own)
WIDE_KERNELS = ("run_bounds", "lrt_filter", "compact")


def wide_cohort(run_dir: str):
    """Phase 6's cohort, made on the host from numpy (seed WIDE_SEED): a run
    directory in the layout `count` writes (4 partitions of count files at
    count_bytes 4, each sample's histogram, kmtricks.fof, kmdiff-count.opt;
    k = 31, hard-min 1) for N_CONTROLS + N_CASES samples. Each sample holds
    ~WIDE_PER_SAMPLE of the pool's ~WIDE_POOL k-mers with Poisson(30)
    counts; WIDE_ENRICHED k-mers count 4x in the cases; WIDE_HUGE k-mers
    count 1.5e9 to 3.1e9 in six controls and six cases, in mirrored pairs
    (one pair's control counts are the other's case counts), so that raw
    counts pass 2^31 and group sums 2^32 while the groups' masses stay
    equal. The k-mers every sample holds keep the Poisson null, so that the
    loose cut keeps the enriched k-mers and ~0.1% of the others (a k-mer
    present in a random subset of the samples at count 30 would be
    overdispersed, and most such k-mers would pass). -> (pool words [P]
    u64, exact int64 group sums [P, 2], the cohort's k-mer mass, the huge
    k-mers' pool indices)."""
    import numpy as np

    from kmdiff_tpu_torch.io.kmtricks import hist_from_counts, write_hist, write_kmer_file
    from kmdiff_tpu_torch.pipeline.count import host_partition_ids

    rng = np.random.default_rng(WIDE_SEED)
    S = N_CONTROLS + N_CASES
    pool = np.unique(rng.integers(0, 2**62, WIDE_POOL, dtype=np.uint64))
    P = len(pool)
    parts = host_partition_ids(pool.reshape(-1, 1), 4)
    core = np.zeros(P, bool)
    core[rng.choice(P, WIDE_CORE, replace=False)] = True
    pick = rng.choice(np.flatnonzero(core), WIDE_ENRICHED + WIDE_HUGE, replace=False)
    enriched = np.zeros(P, bool)
    enriched[pick[:WIDE_ENRICHED]] = True
    huge = pick[WIDE_ENRICHED:]
    errors = np.flatnonzero(~core)
    hi = rng.integers(2_500_000_000, 3_100_000_000, (WIDE_HUGE // 2, 6))
    lo = rng.integers(1_500_000_000, 2_000_000_000, (WIDE_HUGE // 2, 6))
    # [huge k-mer, group, one of six carrying samples]: pair j's controls
    # carry hi[j] and its cases lo[j]; its mirror the other way round
    huge_counts = np.concatenate([np.stack([hi, lo], 1), np.stack([lo, hi], 1)])
    carriers = np.stack([rng.choice(N_CONTROLS, 6, replace=False) for _ in huge])
    sums = np.zeros((P, 2), np.int64)
    for d in ("histograms", *(os.path.join("counts", f"partition_{p}") for p in range(4))):
        os.makedirs(os.path.join(run_dir, d), exist_ok=True)
    fof = []
    for s in range(S):
        group = int(s >= N_CONTROLS)
        present = core.copy()
        present[huge] = False
        present[rng.choice(errors, WIDE_PER_SAMPLE - WIDE_CORE, replace=False)] = True
        idx = np.flatnonzero(present)
        c = np.where(core[idx], np.maximum(rng.poisson(30, len(idx)), 1), 1).astype(np.int64)
        if group:
            c[enriched[idx]] *= 4
        at = np.flatnonzero(carriers == s % N_CONTROLS)
        if len(at):  # the huge k-mers this sample carries
            h, j = np.divmod(at, 6)
            idx = np.concatenate([idx, huge[h]])
            c = np.concatenate([c, huge_counts[h, group, j]])
            order = np.argsort(idx, kind="stable")
            idx, c = idx[order], c[order]
        sums[idx, group] += c  # idx holds each k-mer once
        sid = f"{'CASE' if group else 'CONTROL'}{s}"
        fof.append(f"{sid} : {sid}.fasta")
        write_hist(os.path.join(run_dir, "histograms", f"{sid}.hist"),
                   hist_from_counts(c, s, 31))
        for p in range(4):
            sel = parts[idx] == p
            write_kmer_file(
                os.path.join(run_dir, "counts", f"partition_{p}", f"{sid}.kmer.lz4"),
                pool[idx[sel]].reshape(-1, 1), c[sel].astype(np.uint32), 31,
                sample_idx=s, partition=p, count_bytes=4)
    with open(os.path.join(run_dir, "kmtricks.fof"), "w") as f:
        f.write("\n".join(fof) + "\n")
    with open(os.path.join(run_dir, "kmdiff-count.opt"), "w") as f:
        f.write("kmer_size=31, abundance_min=1\n")
    return pool, sums, int(sums.sum()), huge


class FormSpy:
    """Counts, while active, the merge's K-RUN calls in the full form (with
    sample ids) and its K-LRT calls on int64 sums, by wrapping the names
    ops.merge_dev calls them by; each wrapped call still launches its
    kernel (the launch counts say so)."""

    def __init__(self):
        self.calls = {"run_encode full": 0, "lrt_filter int64": 0, "merge_lrt": 0}

    def __enter__(self):
        import torch

        from kmdiff_tpu_torch.ops import merge_dev

        self._mod = merge_dev
        self._saved = (merge_dev.run_encode, merge_dev.lrt_filter, merge_dev.merge_lrt)
        run_encode, lrt_filter, merge_lrt = self._saved

        def run_spy(*a, sample=None, **k):
            self.calls["run_encode full"] += sample is not None
            return run_encode(*a, sample=sample, **k)

        def lrt_spy(counts, *a, **k):
            self.calls["lrt_filter int64"] += counts.dtype == torch.int64
            return lrt_filter(counts, *a, **k)

        def merge_spy(*a, **k):
            self.calls["merge_lrt"] += 1
            return merge_lrt(*a, **k)

        merge_dev.run_encode, merge_dev.lrt_filter, merge_dev.merge_lrt = (
            run_spy, lrt_spy, merge_spy)
        return self

    def __exit__(self, *exc):
        m = self._mod
        m.run_encode, m.lrt_filter, m.merge_lrt = self._saved

    def require_wide(self, path: str) -> None:
        c = self.calls
        if not c["run_encode full"] or not c["lrt_filter int64"] or c["merge_lrt"]:
            raise AssertionError(f"{path} did not take the wide merge: {c}")


def _wide_expected(pool, sums, mass, alpha):
    """{k-mer: (p-value, mean control, mean case) as the FASTA prints them}
    for every pool k-mer whose host f64 rescore of its exact int64 group
    sums has p <= alpha, with the totals diff reads from the histograms."""
    from kmdiff_tpu_torch.cmd.options import DiffOptions
    from kmdiff_tpu_torch.core.kmer import packed_to_strings
    from kmdiff_tpu_torch.core.model import PoissonLikelihood
    from kmdiff_tpu_torch.io.fasta import format_double

    tot = sums.sum(0)
    seen = sums.sum(1) > 0
    # the per-sample totals only enter through their group sums
    model = PoissonLikelihood(1, 1, [int(tot[0])], [int(tot[1])], DiffOptions().log_size)
    if int(tot.sum()) != mass:
        raise AssertionError("wide cohort: the group sums lost mass")
    p, _sg, mc, mk = model.process_sums(sums[seen, 0], sums[seen, 1])
    keep = p <= alpha
    words = pool[seen][keep].reshape(-1, 1)
    return {seq: (f"{pv:g}", str(int(c)), format_double(k)) for seq, pv, c, k in
            zip(packed_to_strings(words, 31), p[keep], mc[keep], mk[keep])}


def _fasta_records(out) -> dict:
    """{k-mer: (p-value, mean control, mean case)} of a diff's two FASTA."""
    recs = {}
    for g in ("control", "case"):
        for name, seq in _read_fasta(os.path.join(out, f"{g}_kmers.fasta")):
            fields = dict(f.split("=", 1) for f in name.split("_")[1:])
            recs[seq] = (fields["pval"], fields["control"], fields["case"])
    return recs


def run_wide(dev, phase3) -> dict:
    """Phase 6: the wide cohort (wide_cohort) through `diff` on CUDA and the
    CPU, (a) the loose cut and (b) with popstrat and --save-sk, and (c) the
    fused `run` on phase 3's cohort with LrtParams.wide_sums forced true in
    this process. Returns each CUDA path's launch counts."""
    import numpy as np
    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.cli import count_options, diff_options
    from kmdiff_tpu_torch.cmd.diff import main_diff
    from kmdiff_tpu_torch.cmd.run import main_run
    from kmdiff_tpu_torch.io.kmtricks import open_matrix_stream
    from kmdiff_tpu_torch.pipeline import merge as merge_mod

    run_dir = os.path.join(WORK, "wide_run")
    t0 = time.perf_counter()
    pool, sums, mass, huge = wide_cohort(run_dir)
    base_mass = mass - int(sums[huge].sum())
    print(f"[wide cohort] {N_CONTROLS}+{N_CASES} samples, {len(pool)} pooled k-mers, "
          f"{int((sums.sum(1) > 0).sum())} carried, k-mer mass {mass} ({base_mass} without "
          f"the {WIDE_HUGE} planted k-mers; 2^31 = {2**31}), largest group sum "
          f"{int(sums.max())}; run directory written in {time.perf_counter() - t0:.1f} s")
    if base_mass < 2**31 or int(sums.max()) < 2**32:
        raise AssertionError("the wide cohort is not wide")
    loose = ["-1", str(N_CONTROLS), "-2", str(N_CASES), "--threads", "4", "-s",
             "0.001", "--cutoff", "1", "-c", "disabled"]
    out, launches = {}, {}

    # (a) the loose diff, CUDA then CPU; the FASTA against the host rescore
    for where in (dev, "cpu"):
        label = "gpu" if where is dev else "cpu"
        out[label] = os.path.join(WORK, f"wide_{label}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with FormSpy() as spy:
            cli_main(["diff", "--km-run-dir", run_dir, *loose, "--output-dir", out[label]],
                 device=where)
        wall = time.perf_counter() - t0
        if where is dev:
            launches["a"] = kernels.launch_counts()
            require_launches("wide diff", launches["a"], WIDE_KERNELS)
            spy.require_wide("wide diff")
            print(f"[wide diff] CUDA {wall:.3f} s wall; launches {launches['a']}; "
                  f"merge calls {spy.calls}")
        else:
            print(f"[wide diff] CPU {wall:.3f} s wall")
    for g in ("control", "case"):
        if not _same_bytes(*(os.path.join(out[k], f"{g}_kmers.fasta") for k in out)):
            raise AssertionError(f"wide diff {g}_kmers.fasta: CUDA and CPU differ")
    got = _fasta_records(out["gpu"])
    want = _wide_expected(pool, sums, mass, 0.001)
    if got != want:
        raise AssertionError(f"wide diff: {len(got)} FASTA records, {len(want)} from the "
                             f"host int64 rescore, {len(set(got) ^ set(want))} k-mers in "
                             "one only")
    print(f"[check] wide diff -s 0.001 --cutoff 1 -c disabled: {len(got)} k-mers, FASTA "
          f"byte-identical CUDA vs CPU and equal, record for record, to the host f64 "
          f"rescore of the input's exact int64 group sums")

    # (b) popstrat and --save-sk, CUDA then CPU
    flags = [*loose, "--pop-correction", "--save-sk"]
    for where in (dev, "cpu"):
        label = "pop_gpu" if where is dev else "pop_cpu"
        out[label] = os.path.join(WORK, f"wide_{label}")
        args = cli_args(["diff", "--km-run-dir", run_dir, *flags, "--output-dir",
                           out[label]])
        timings = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with FormSpy() as spy:
            res = main_diff(diff_options(args), torch.device(where), timings)
        wall = time.perf_counter() - t0
        if where is dev:
            launches["b"] = kernels.launch_counts()
            require_launches("wide popstrat diff", launches["b"],
                             (*WIDE_KERNELS, "run_rows", "geno_sample"))
            spy.require_wide("wide popstrat diff")
        print(f"[wide popstrat diff] {label[4:].upper()} {wall:.3f} s wall (PCA "
              f"{timings['pca']:.3f} s, null fit {timings['null_fit']:.3f} s, alt fits "
              f"{timings['alt_fits']:.3f} s); significant {res['control']} control / "
              f"{res['case']} case" + (f"; launches {launches['b']}" if where is dev else ""))
    for name in POP_ARTIFACTS:
        if not _same_bytes(*(os.path.join(out[k], "popstrat", name)
                             for k in ("pop_gpu", "pop_cpu"))):
            raise AssertionError(f"wide popstrat diff {name}: CUDA and CPU differ")
    mdir = os.path.join("positive_kmer_matrix", "matrices")
    mats = sorted(os.listdir(os.path.join(out["pop_gpu"], mdir)))
    if mats != sorted(os.listdir(os.path.join(out["pop_cpu"], mdir))) or not mats:
        raise AssertionError(f"wide popstrat diff: --save-sk matrices {mats}")
    planted = {}
    for name in mats:
        a, b = (os.path.join(out[k], mdir, name) for k in ("pop_gpu", "pop_cpu"))
        if not _same_bytes(a, b):
            raise AssertionError(f"wide popstrat diff {name}: CUDA and CPU differ")
        for kmers, counts in open_matrix_stream(a)[1]:
            planted.update(zip(kmers[:, 0].tolist(), counts))
    held = []
    for h in huge:
        r = planted.get(int(pool[h]))
        if r is not None:
            r = r.astype(np.int64)
            ctrl, case = r[:N_CONTROLS].sum(), r[N_CONTROLS:].sum()
            if (ctrl, case) != tuple(sums[h]) or r.max() < 2**31:
                raise AssertionError(f"wide --save-sk: k-mer {int(pool[h])}'s row {r} "
                                     f"lost its planted counts (group sums {sums[h]})")
            held.append(int(r.max()))
    if not held:
        raise AssertionError("wide --save-sk: no planted count of 2^31 or more survived")
    print(f"[check] wide popstrat diff: artifacts and {len(mats)} --save-sk matrices "
          f"byte-identical CUDA vs CPU; {len(held)} of the {WIDE_HUGE} planted k-mers in "
          f"the matrices with their raw counts, up to {max(held)}")

    # (c) the fused run on phase 3's cohort, wide sums forced in this process
    base = merge_mod.LrtParams

    class ForcedWide(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.wide_sums = True

    run_out = os.path.join(WORK, "wide_forced_run_out")
    args = cli_args(["run", "--file", phase3["fof"], "--kmer-size", "31", "--hard-min",
                       "1", "--nb-partitions", "4", *loose, "--run-dir",
                       os.path.join(WORK, "wide_forced_run"), "--output-dir", run_out])
    timings = {}
    merge_mod.LrtParams = ForcedWide
    try:
        kernels.reset_launch_counts()
        with FormSpy() as spy:
            res = main_run(count_options(args), diff_options(args), dev,
                           recurrence_min=args.recurrence_min,
                           count_files=not args.no_count_files, timings=timings)
        launches["c"] = kernels.launch_counts()
    finally:
        merge_mod.LrtParams = base
    if "merge" not in timings:
        raise AssertionError("forced-wide run was not served by the fused path")
    require_launches("forced-wide run", launches["c"], (*WIDE_KERNELS, "assemble_chunk"))
    spy.require_wide("forced-wide run")
    for g in ("control", "case"):
        name = f"{g}_kmers.fasta"
        if not _same_bytes(os.path.join(run_out, name), os.path.join(WORK, "loose_gpu", name)):
            raise AssertionError(f"forced-wide run {name} differs from phase 3's loose diff")
    print(f"[wide run] forced wide sums on the bench cohort: count {timings['count']:.3f} s, "
          f"merge {timings['merge']:.3f} s, total {timings['total']:.3f} s (wall, CUDA); "
          f"significant {res['control']} control / {res['case']} case, FASTA "
          f"byte-identical to phase 3's loose diff; launches {launches['c']}; merge "
          f"calls {spy.calls}")
    return launches


#: the kernels phase 7's paths launch at k > 32: the multi-word forms of
#: K-EXT, K-RUN, K-ASM and K-GENO, never their one-word forms
MW_COUNT_DIFF_KERNELS = ("canonical_kmers_mw", "run_bounds_mw", "compact", "lrt_filter")
MW_RUN_KERNELS = (*MW_COUNT_DIFF_KERNELS, "assemble_chunk_mw", "abundance_hist")
MW_POP_KERNELS = ("run_bounds_mw", "compact", "run_rows", "geno_sample_mw",
                  "int_gram", "irls", "lrt_filter")
ONE_WORD_FORMS = ("canonical_kmers", "run_bounds", "assemble_chunk", "geno_sample")


def require_multiword(path: str, launches: dict, names) -> None:
    require_launches(path, launches, names)
    one = {n: launches[n] for n in ONE_WORD_FORMS if launches[n]}
    if one:
        raise AssertionError(f"{path} launched one-word forms {one}")


def _count_diff_at(dev, fof, k: int) -> dict:
    """Phase 7's count + diff at k on CUDA (defaults, and the loose cut,
    which must keep k-mers of both groups), then the CPU reruns of both
    diffs and the recount of sample 0: byte-identical."""
    from kmdiff_tpu_torch import kernels

    run = os.path.join(WORK, f"run_k{k}")
    count_args = ["count", "--file", fof, "--kmer-size", str(k), "--hard-min",
                  "1", "--nb-partitions", "4", "--threads", "4"]
    diff_args = ["diff", "--km-run-dir", run, "-1", str(N_CONTROLS), "-2",
                 str(N_CASES), "--threads", "4"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main([*count_args, "--run-dir", run], device=dev)
    t_count = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli_main([*diff_args, "--output-dir", os.path.join(WORK, f"k{k}_defaults_gpu")],
         device=dev)
    t_diff = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require_multiword(f"count + diff at k={k}", launches, MW_COUNT_DIFF_KERNELS)
    print(f"[k={k}] count {t_count:.3f} s, diff {t_diff:.3f} s (wall, CUDA); "
          f"launches {launches}")
    t0 = time.perf_counter()
    tested, n_sig = _diff_cpu_vs_gpu(dev, diff_args, f"k{k}_defaults", 0.05, k)
    loose = [*diff_args, "-s", "0.001", "--cutoff", "1", "-c", "disabled"]
    _tested, n_loose = _diff_cpu_vs_gpu(dev, loose, f"k{k}_loose", 0.001, k)
    if not n_loose["case"] or not n_loose["control"]:
        raise AssertionError(f"k={k}: no k-mer passed p < 0.001: {n_loose}")
    with open(fof) as f:
        first = f.readline()
    fof0 = os.path.join(WORK, "fof0.txt")
    with open(fof0, "w") as f:
        f.write(first)
    sid = first.split(":")[0].strip()
    run0 = os.path.join(WORK, f"run_k{k}_cpu0")
    cli_main([*count_args[:2], fof0, *count_args[3:], "--run-dir", run0], device="cpu")
    rels = [os.path.join("histograms", f"{sid}.hist")] + [
        os.path.join("counts", f"partition_{p}", f"{sid}.kmer.lz4") for p in range(4)]
    for rel in rels:
        if not _same_bytes(os.path.join(run, rel), os.path.join(run0, rel)):
            raise AssertionError(f"k={k} {rel}: CUDA and CPU counts differ")
    print(f"[k={k}] {tested} k-mers tested, significant {n_sig} (defaults), "
          f"{n_loose} (-s 0.001 --cutoff 1 -c disabled); both diffs' FASTA and "
          f"sample {sid}'s .kmer.lz4 and .hist byte-identical CUDA vs CPU "
          f"({time.perf_counter() - t0:.3f} s)")
    return {"launches": launches, "count": t_count, "diff": t_diff, "run": run}


def run_multiword(dev, phase3) -> dict:
    """Phase 7: k > 32 on the bench cohort (phase 3's reads) at its full
    size. k = 63 (two words, 31 bases in the second): count + diff on CUDA
    against the CPU, the fused `run` (a), whose FASTA, count files and
    histograms must equal count + diff's, and popstrat `diff --save-sk` on
    CUDA and the CPU under phase 5's rules; k = 128 (four words): count +
    diff. Launch counts reset before each part and required > 0 after it
    for the multi-word forms (and 0 for the one-word forms). Returns each
    part's launch counts."""
    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.cli import count_options, diff_options
    from kmdiff_tpu_torch.cmd.diff import main_diff
    from kmdiff_tpu_torch.cmd.run import main_run

    fof = phase3["fof"]
    out = {}
    k63 = _count_diff_at(dev, fof, 63)
    out["count+diff k=63"] = k63["launches"]

    # (a) the fused run at k = 63, the defaults
    run_dir, out_dir = os.path.join(WORK, "fused_k63"), os.path.join(WORK, "fused_k63_out")
    args = cli_args(["run", "--file", fof, "--kmer-size", "63", "--hard-min", "1",
                       "--nb-partitions", "4", "--threads", "4", "-1",
                       str(N_CONTROLS), "-2", str(N_CASES), "--run-dir", run_dir,
                       "--output-dir", out_dir])
    timings = {}
    kernels.reset_launch_counts()
    res = main_run(count_options(args), diff_options(args), dev,
                   recurrence_min=args.recurrence_min,
                   count_files=not args.no_count_files, timings=timings)
    launches = kernels.launch_counts()
    if "merge" not in timings:
        raise AssertionError("run (a) at k=63 was not served by the fused path")
    require_multiword("run (a) at k=63", launches, MW_RUN_KERNELS)
    for g in ("control", "case"):
        name = f"{g}_kmers.fasta"
        if not _same_bytes(os.path.join(out_dir, name),
                           os.path.join(WORK, "k63_defaults_gpu", name)):
            raise AssertionError(f"run (a) at k=63 {name} differs from diff's")
    for sub in [os.path.join("counts", f"partition_{p}") for p in range(4)] + ["histograms"]:
        names = sorted(os.listdir(os.path.join(k63["run"], sub)))
        if sorted(os.listdir(os.path.join(run_dir, sub))) != names:
            raise AssertionError(f"run (a) at k=63 {sub}: other files")
        for n in names:
            if not _same_bytes(os.path.join(run_dir, sub, n),
                               os.path.join(k63["run"], sub, n)):
                raise AssertionError(f"run (a) at k=63 {sub}/{n} differs")
    print(f"[run a, k=63] count {timings['count']:.3f} s, merge "
          f"{timings['merge']:.3f} s, total {timings['total']:.3f} s (wall, CUDA; "
          f"count {k63['count']:.3f} s + diff {k63['diff']:.3f} s at k=63); "
          f"{res['total_kmers']} k-mers tested; FASTA, count files and histograms "
          f"byte-identical to count + diff's; launches {launches}")
    out["run (a) k=63"] = launches

    # (b) popstrat diff --save-sk at k = 63, CUDA then CPU
    loose = ["-1", str(N_CONTROLS), "-2", str(N_CASES), "--threads", "4", "-s",
             "0.001", "--cutoff", "1", "-c", "disabled"]
    flags = [*loose, "--pop-correction", "--save-sk", "--keep-tmp"]
    outs, pop = {}, {}
    for label, where in (("gpu", dev), ("cpu", torch.device("cpu"))):
        o = os.path.join(WORK, f"pop_k63_{label}")
        args = cli_args(["diff", "--km-run-dir", k63["run"], *flags, "--output-dir", o])
        timings = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = main_diff(diff_options(args), where, timings)
        wall = time.perf_counter() - t0
        pop[label] = kernels.launch_counts()
        print(f"[popstrat diff k=63 {label}] {wall:.3f} s wall (PCA "
              f"{timings['pca']:.3f} s, null fit {timings['null_fit']:.3f} s, alt "
              f"fits {timings['alt_fits']:.3f} s); significant {res['control']} "
              f"control / {res['case']} case; launches {pop[label]}")
        outs[label] = o
    require_multiword("popstrat diff at k=63", pop["gpu"], MW_POP_KERNELS)
    gpu, cpu = outs["gpu"], outs["cpu"]
    for name in POP_ARTIFACTS:
        if not _same_bytes(os.path.join(gpu, "popstrat", name),
                           os.path.join(cpu, "popstrat", name)):
            raise AssertionError(f"popstrat diff k=63 {name}: CUDA and CPU differ")
    mdir = os.path.join("positive_kmer_matrix", "matrices")
    mats = sorted(os.listdir(os.path.join(gpu, mdir)))
    if not mats or mats != sorted(os.listdir(os.path.join(cpu, mdir))):
        raise AssertionError(f"popstrat diff k=63: --save-sk matrices {mats}")
    for name in mats:
        if not _same_bytes(os.path.join(gpu, mdir, name), os.path.join(cpu, mdir, name)):
            raise AssertionError(f"popstrat diff k=63 {name}: CUDA and CPU differ")
    report = check_popstrat_fasta(dev, diff_options(args), k63["run"], gpu, cpu,
                                  0.001)
    print(f"[check] popstrat diff at k=63: artifacts and {len(mats)} --save-sk "
          f"matrices byte-identical CUDA vs CPU; {report}")
    out["popstrat diff k=63"] = pop["gpu"]

    k128 = _count_diff_at(dev, fof, 128)
    out["count+diff k=128"] = k128["launches"]
    return out


#: phase 8's plugins: the port's twins of the JAX package's examples
PLUGINS = os.path.join(HERE, "kmdiff_tpu_torch", "examples", "plugins")
#: (device type, rows) of every tile phase 8's spy plugin was given
SPY_TILES: list = []


def spy_device_model(config: str):
    """`--model __main__:spy_device_model` in phase 8: the port's device
    twin, recording the device and rows of each tile it scores."""
    from kmdiff_tpu_torch.examples.plugins.device_fold_change_model import (
        DeviceFoldChangeModel,
    )

    class SpyDeviceModel(DeviceFoldChangeModel):
        def process_block_torch(self, counts, nb_controls):
            SPY_TILES.append((counts.device.type, counts.shape[0]))
            return super().process_block_torch(counts, nb_controls)

    return SpyDeviceModel(float(config) if config else 2.0)


class PluginWalls:
    """Sums, in this process, the seconds of the host union merge
    (merge_sorted_streams) and of a custom model's scoring
    (PartitionProcessor._plugin_scores) over the partitions of one command;
    they run on its worker threads, so the sums may exceed its wall."""

    def __enter__(self):
        import threading

        from kmdiff_tpu_torch.pipeline import merge

        self.merge = merge
        self.saved = (merge.merge_sorted_streams,
                      merge.PartitionProcessor._plugin_scores)
        self.t = {"union": 0.0, "score": 0.0}
        lock = threading.Lock()

        def timed(key, fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    with lock:
                        self.t[key] += time.perf_counter() - t0
            return call

        merge.merge_sorted_streams = timed("union", self.saved[0])
        merge.PartitionProcessor._plugin_scores = timed("score", self.saved[1])
        return self

    def __exit__(self, *exc):
        (self.merge.merge_sorted_streams,
         self.merge.PartitionProcessor._plugin_scores) = self.saved
        return False


def _kmer_sets(out) -> tuple[dict, dict]:
    """({group: k-mer set}, {group: record count}) of a diff's FASTA."""
    sets, tallies = {}, {}
    for g in ("control", "case"):
        recs = _read_fasta(os.path.join(out, f"{g}_kmers.fasta"))
        sets[g] = {seq for _name, seq in recs}
        tallies[g] = len(recs)
    return sets, tallies


def run_plugins(dev, phase3) -> dict:
    """Phase 8: custom model plugins, `call` and `infos` on phase 3's cohort
    (10 + 10 samples, k = 31, 4 partitions). `diff --model` with the port's
    device twin on CUDA (a spy around it records each tile's device) and on
    the CPU, byte-identical; with the numpy twin on CUDA, the same k-mer sets
    and tallies; none launches K-LRT. `run --model` with the device twin into
    a fresh run directory: the standard flow, count's kernels launched and
    K-ASM not, the FASTA byte-identical to the CUDA `diff --model`'s. `call`
    maps phase 3's loose case k-mers onto popsim's truth.fasta; `infos` on
    CUDA names the card. Each step's wall is printed. Returns the launch
    counts of the CUDA `diff --model` and of `run --model`."""
    import contextlib
    import io

    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.pipeline.merge import BLOCK_ROWS

    device_twin = os.path.join(PLUGINS, "device_fold_change_model.py")
    base = ["diff", "--km-run-dir", phase3["run"], "-1", str(N_CONTROLS),
            "-2", str(N_CASES), "--threads", "4"]
    launches, outs = {}, {}
    for label, model, where in (
        ("device twin, CUDA", "__main__:spy_device_model", dev),
        ("device twin, CPU", device_twin, "cpu"),
        ("numpy twin", os.path.join(PLUGINS, "fold_change_model.py"), dev),
    ):
        out = outs[label] = os.path.join(WORK, f"plugin_{len(outs)}")
        SPY_TILES.clear()
        kernels.reset_launch_counts()
        with PluginWalls() as walls:
            t0 = time.perf_counter()
            cli_main([*base, "--model", model, "--output-dir", out], device=where)
            wall = time.perf_counter() - t0
        launches[label] = kernels.launch_counts()
        if launches[label]["lrt_filter"]:
            raise AssertionError(f"diff --model ({label}) launched K-LRT")
        with open(os.path.join(out, "options.json")) as f:
            tested = json.load(f)["total_kmers"]
        sets, tallies = _kmer_sets(out)
        print(f"[plugins] diff --model, {label}: {wall:.3f} s (wall; host "
              f"union merge {walls.t['union']:.3f} s and scoring "
              f"{walls.t['score']:.3f} s summed over 4 partitions on 4 "
              f"threads); {tested} k-mers tested, significant {tallies}; "
              f"launches {sum(launches[label].values())}")
        if label == "device twin, CUDA":
            kinds = {kind for kind, _n in SPY_TILES}
            rows = sum(n for _kind, n in SPY_TILES)
            if kinds != {dev.type} or rows != tested or max(
                    n for _kind, n in SPY_TILES) > BLOCK_ROWS:
                raise AssertionError(
                    f"the device twin's tiles: devices {kinds}, {rows} rows "
                    f"of {tested}, {len(SPY_TILES)} tiles")
            print(f"[plugins] the device twin scored {len(SPY_TILES)} tiles "
                  f"on {kinds}, at most {BLOCK_ROWS} rows each, {rows} rows "
                  f"in all")
            want_sets, want_tallies = sets, tallies
            if not tallies["control"] or not tallies["case"]:
                raise AssertionError(f"diff --model kept no k-mer: {tallies}")
        elif label == "device twin, CPU":
            for g in ("control", "case"):
                if not _same_bytes(
                        os.path.join(outs["device twin, CUDA"], f"{g}_kmers.fasta"),
                        os.path.join(out, f"{g}_kmers.fasta")):
                    raise AssertionError(f"device twin {g}_kmers.fasta: CUDA "
                                         "and CPU differ")
            print("[plugins] device twin: CUDA and CPU FASTA byte-identical")
        elif (sets, tallies) != (want_sets, want_tallies):
            raise AssertionError(f"numpy twin {tallies} and device twin "
                                 f"{want_tallies}: k-mer sets or tallies differ")
        else:
            print("[plugins] numpy twin: the device twin's k-mer sets and "
                  "tallies")

    run_dir = os.path.join(WORK, "plugin_run_dir")
    out = os.path.join(WORK, "plugin_run")
    kernels.reset_launch_counts()
    with PluginWalls() as walls:
        t0 = time.perf_counter()
        cli_main(["run", "--file", phase3["fof"], "--kmer-size", "31",
              "--hard-min", "1", "--nb-partitions", "4", "--threads", "4",
              "-d", run_dir, "-1", str(N_CONTROLS), "-2", str(N_CASES),
              "--model", device_twin, "-o", out], device=dev)
        wall = time.perf_counter() - t0
    launches["run --model"] = run_l = kernels.launch_counts()
    require_launches("run --model", run_l, ("canonical_kmers", "run_bounds"))
    if run_l["assemble_chunk"] or run_l["lrt_filter"]:
        raise AssertionError(f"run --model left the standard flow: {run_l}")
    for g in ("control", "case"):
        if not _same_bytes(os.path.join(out, f"{g}_kmers.fasta"), os.path.join(
                outs["device twin, CUDA"], f"{g}_kmers.fasta")):
            raise AssertionError(f"run --model {g}_kmers.fasta differs from "
                                 "diff --model's")
    print(f"[plugins] run --model (device twin, CUDA): {wall:.3f} s (wall; "
          f"host union merge {walls.t['union']:.3f} s and scoring "
          f"{walls.t['score']:.3f} s summed); the standard flow, FASTA "
          f"byte-identical to diff --model's; launches {run_l}")

    calls = os.path.join(WORK, "calls.tsv")
    t0 = time.perf_counter()
    rc = cli_main(["call", "-i", os.path.join(WORK, "loose_gpu", "case_kmers.fasta"),
               "-r", os.path.join(WORK, "sim", "truth.fasta"), "-o", calls],
              device=dev)
    wall = time.perf_counter() - t0
    with open(calls) as f:
        rows = [line.split("\t") for line in f.read().splitlines()[1:]]
    mapped = len({r[0] for r in rows})
    queries = len(_read_fasta(os.path.join(WORK, "loose_gpu", "case_kmers.fasta")))
    if rc != 0 or not mapped:
        raise AssertionError(f"call returned {rc}, mapped {mapped} queries")
    print(f"[call] phase 3's loose case k-mers on truth.fasta: {mapped} of "
          f"{queries} mapped, {len(rows)} loci ({wall:.3f} s wall)")

    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = cli_main(["infos"], device=dev)
    wall = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    if rc != 0 or name not in text.getvalue():
        raise AssertionError(f"infos returned {rc} without {name!r}")
    print(f"[infos] ({wall:.3f} s wall)\n" + text.getvalue().rstrip())
    return {"diff --model": launches["device twin, CUDA"],
            "run --model": run_l}


#: the kernels each rank of phase 9 must launch over its commands (the
#: count's histograms are host work in count + diff, as in the JAX
#: package's count: K-HIST runs in the fused `run` only)
DIST_KERNELS = ("canonical_kmers", "run_bounds", "compact", "lrt_filter")


def _same_tree(a: str, b: str, subs) -> int:
    """Require every file under a/sub equal to b/sub, names and bytes;
    returns the number of files."""
    n = 0
    for sub in subs:
        names = sorted(os.listdir(os.path.join(b, sub)))
        if sorted(os.listdir(os.path.join(a, sub))) != names:
            raise AssertionError(f"phase 9 {sub}: other files than {b}'s")
        for name in names:
            if not _same_bytes(os.path.join(a, sub, name),
                               os.path.join(b, sub, name)):
                raise AssertionError(f"phase 9 {sub}/{name} differs from {b}'s")
        n += len(names)
    return n


def _dist_commands(fof: str, tag: str, devices: int = 1,
                   run_dir: str | None = None) -> tuple[dict, str, dict]:
    """Phase 9's four command lines with --devices `devices`, their run
    directory (by default WORK/dist<tag>_run) and their output directories
    (WORK/dist<tag>_<command>)."""
    loose = ["-1", str(N_CONTROLS), "-2", str(N_CASES), "--threads", "4", "-s",
             "0.001", "--cutoff", "1", "-c", "disabled"]
    count = ["--file", fof, "--kmer-size", "31", "--hard-min", "1",
             "--nb-partitions", "4"]
    run_dir = run_dir or os.path.join(WORK, f"dist{tag}_run")
    outs = {name: os.path.join(WORK, f"dist{tag}_{name}")
            for name in ("diff", "popstrat", "run")}
    commands = {
        "count": ["count", *count, "--threads", "4", "--run-dir", run_dir],
        "diff": ["diff", "--km-run-dir", run_dir, *loose, "--output-dir",
                 outs["diff"]],
        "popstrat": ["diff", "--km-run-dir", run_dir, *loose,
                     "--pop-correction", "--save-sk", "--keep-tmp",
                     "--output-dir", outs["popstrat"]],
        "run": ["run", *count, *loose, "--run-dir", f"{run_dir}_of_run",
                "--output-dir", outs["run"]],
    }
    return ({name: [*argv, "--devices", str(devices)]
             for name, argv in commands.items()}, run_dir, outs)


def _check_dist_output(label: str, phase3, run_dir: str, outs: dict) -> str:
    """Hold a phase-9 command's output against phase 3's or phase 5's."""
    fasta = ("control_kmers.fasta", "case_kmers.fasta")
    if label == "count":
        n = _same_tree(run_dir, phase3["run"],
                       [*(os.path.join("counts", f"partition_{p}")
                          for p in range(4)), "histograms"])
        for name in ("kmtricks.fof", "kmdiff-count.opt"):
            if not _same_bytes(os.path.join(run_dir, name),
                               os.path.join(phase3["run"], name)):
                raise AssertionError(f"phase 9 count: {name} differs")
        return f"{n} count files and histograms byte-identical to phase 3's"
    if label == "popstrat":
        pop = os.path.join(WORK, "pop_gpu")
        for name in (*fasta, os.path.join("popstrat", "pcs.evec")):
            if not _same_bytes(os.path.join(outs[label], name),
                               os.path.join(pop, name)):
                raise AssertionError(f"phase 9 popstrat diff {name} differs "
                                     "from phase 5's CUDA diff")
        n = _same_tree(outs[label], pop, [os.path.join(
            "positive_kmer_matrix", "matrices")])
        return (f"FASTA, pcs.evec and {n} --save-sk matrices byte-identical to "
                "phase 5's CUDA diff")
    for name in fasta:
        if not _same_bytes(os.path.join(outs[label], name),
                           os.path.join(WORK, "loose_gpu", name)):
            raise AssertionError(f"phase 9 {label} {name} differs from phase "
                                 "3's loose diff")
    return "FASTA byte-identical to phase 3's loose diff"


#: the kernels each rank of phase 9's two-shard meshes must launch on each
#: of its cards, a command at a time (`run --distributed` takes count +
#: diff; the primary alone fits the PCA, so K-GRAM is required of it alone)
DIST_MESH_KERNELS = {
    "count": ("canonical_kmers", "partition_ids", "run_bounds"),
    "diff": ("run_bounds", "compact", "lrt_filter"),
    "popstrat": ("run_bounds", "compact", "run_rows", "geno_sample", "irls",
                 "lrt_filter"),
    "run": ("canonical_kmers", "partition_ids", "run_bounds", "compact",
            "lrt_filter"),
}


def kernel_symbols() -> dict:
    """Each kernel source's __global__ function names, {source: [name]}:
    what a trace's CUDA activity calls its kernels."""
    from kmdiff_tpu_torch import kernels

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                         r"\([^)]*\)\s*)?(\w+)\s*\(")
    out = {}
    for path in kernels.sources():
        if path.endswith(".cu"):
            with open(path) as f:
                out[os.path.basename(path)[:-3]] = pattern.findall(f.read())
    return out


def check_trace(path: str, launches: dict) -> str:
    """Hold a --profile Chrome trace of one process to what it launched:
    for every kernel launched, a kmd:<kernel> range and CUDA activity of
    one of its source's kernels; aten ops on a mesh shard's thread, inside
    a kmd:shard1 range. Returns a summary."""
    from kmdiff_tpu_torch import kernels

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in events}
    gpu = [e for e in events if e.get("cat") == "kernel"]
    symbols = kernel_symbols()
    for name, n in launches.items():
        if not n:
            continue
        if f"kmd:{name}" not in names:
            raise AssertionError(f"{path}: no kmd:{name} range ({n} launches)")
        syms = symbols[kernels.MULTIWORD.get(name, name)]
        if not any(sym in e["name"] for e in gpu for sym in syms):
            raise AssertionError(f"{path}: no CUDA activity of {name} {syms}")
    shard = [e for e in events if e["name"] == "kmd:shard1"]
    inside = [e for s in shard for e in events if e["tid"] == s["tid"]
              and e["name"].startswith("aten::")
              and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
    if not inside:
        raise AssertionError(f"{path}: no aten op of a mesh shard's thread")
    busy = sum(e["dur"] for e in gpu) / 1e3
    return (f"{len(events)} events, {len(gpu)} CUDA kernels ({busy:.1f} ms "
            f"summed), {len(inside)} aten ops in {len(shard)} kmd:shard1 ranges")


def run_distributed(phase3, pop_walls) -> dict:
    """Phase 9: the multi-process runtime, two ranks on one card. Runs
    `count`, the loose `diff`, popstrat `diff --save-sk` and `run` (loose)
    over phase 3's cohort, each as one spawned process and then as two
    --distributed ranks, and holds every output against phases 3 and 5;
    prints each process's wall, command seconds and log breakdown beside
    the in-process walls of phases 3 and 5 and its launches, and requires
    both ranks to launch DIST_KERNELS. Then the mesh under the runtime: the
    four commands as two ranks of two shards each (--devices 2; a virtual
    mesh of each rank's card, or with four cards or more rank 0 on cuda:0-1
    and rank 1 on cuda:2-3), each output held against phases 3 and 5, each
    rank's launches on each of its cards against DIST_MESH_KERNELS; and the
    loose diff of two such ranks again under --profile, whose two traces
    check_trace holds to each rank's launches, and whose wall is printed
    beside the unprofiled one's. Returns the two ranks' launches (one
    shard a rank) summed over their commands."""
    import torch

    from kmdiff_tpu_torch.tools.dist_walls import log_breakdown, spawn

    def describe(rep: dict) -> str:
        return (f"{rep['wall']:.3f} s wall, {rep['seconds']:.3f} s in the "
                f"command {log_breakdown(rep)}")

    in_process = {
        "count": (phase3["count"], "phase 3's count"),
        "diff": (pop_walls["loose diff"], "phase 5's loose diff"),
        "popstrat": (pop_walls["popstrat diff gpu"],
                     "phase 5's CUDA popstrat diff"),
        "run": (phase3["count"] + pop_walls["loose diff"],
                "phase 3's count + phase 5's loose diff"),
    }
    plans = {w: _dist_commands(phase3["fof"], str(w)) for w in (1, 2)}
    per_rank = [dict.fromkeys(phase3["launches"], 0) for _ in range(2)]
    real = torch.cuda.device_count() >= 4
    cards, visible = ([[0, 1], [2, 3]], "0,1,2,3") if real else ([[0], [0]], None)
    where = ("rank 0 on cuda:0-1, rank 1 on cuda:2-3" if real else
             "a virtual mesh of two shards on the card in each rank")
    mesh_plan = _dist_commands(phase3["fof"], "2x2", devices=2)
    mesh_walls = {}
    for label in plans[1][0]:
        reports = {}
        for world, (commands, run_dir, outs) in plans.items():
            reports[world] = spawn(commands[label], world,
                                   os.path.join(WORK, f"dist_{label}_{world}"))
            what = _check_dist_output(label, phase3, run_dir, outs)
        for r, rep in enumerate(reports[2]):
            for name, n in rep["launches"].items():
                per_rank[r][name] += n
        print(f"[distributed {label}] one process"
              f"{' (the fused run)' if label == 'run' else ''}: "
              f"{describe(reports[1][0])}; "
              "two ranks on one card: " + ", ".join(
                  f"rank {r} {describe(rep)}" for r, rep in enumerate(reports[2]))
              + f"; in-process ({in_process[label][1]}): "
              f"{in_process[label][0]:.3f} s; {what} (both); launches (above 0) "
              + "; ".join(f"rank {r} " + str({k: n for k, n in rep["launches"].items()
                                              if n})
                          for r, rep in enumerate(reports[2])))
        commands, run_dir, outs = mesh_plan
        reports = spawn(commands[label], 2, os.path.join(WORK, f"dist_{label}_2x2"),
                        virtual=not real, cards=visible)
        what = _check_dist_output(label, phase3, run_dir, outs)
        for r, rep in enumerate(reports):
            need = DIST_MESH_KERNELS[label] + (
                ("int_gram",) if label == "popstrat" and r == 0 else ())
            for d in cards[r]:
                got = rep["launches_by_device"].get(str(d), {})
                missing = [k for k in need if not got.get(k)]
                if missing:
                    raise AssertionError(f"phase 9 two ranks x two shards {label}: "
                                         f"rank {r} never launched {missing} on "
                                         f"cuda:{d}")
        mesh_walls[label] = max(rep["seconds"] for rep in reports)
        print(f"[distributed {label}] two ranks x two shards ({where}): "
              + ", ".join(f"rank {r} {describe(rep)}" for r, rep in enumerate(reports))
              + f"; {what} (both); launches by card (above 0) "
              + "; ".join(f"rank {r} " + str({
                  d: {k: n for k, n in by.items() if n}
                  for d, by in rep["launches_by_device"].items()})
                  for r, rep in enumerate(reports)))
    for r, launches in enumerate(per_rank):
        require_launches(f"distributed rank {r}", launches, DIST_KERNELS)

    # the loose diff of two ranks x two shards under --profile
    prof = os.path.join(WORK, "dist_profile")
    commands, run_dir, outs = _dist_commands(phase3["fof"], "2x2p", devices=2,
                                             run_dir=mesh_plan[1])
    reports = spawn([*commands["diff"], "--profile", prof], 2,
                    os.path.join(WORK, "dist_diff_2x2p"), virtual=not real,
                    cards=visible)
    what = _check_dist_output("diff", phase3, run_dir, outs)
    traces = sorted(os.listdir(prof))
    if sorted(t.split(".")[0] for t in traces) != ["rank0", "rank1"]:
        raise AssertionError(f"phase 9 --profile wrote {traces}")
    checked = [check_trace(os.path.join(prof, t), rep["launches"])
               for t, rep in zip(traces, reports)]
    wall = max(rep["seconds"] for rep in reports)
    print(f"[distributed diff --profile] two ranks x two shards ({where}): "
          f"{wall:.3f} s in the command (the slower rank) against "
          f"{mesh_walls['diff']:.3f} s unprofiled ({wall / mesh_walls['diff']:.2f}x); "
          f"{what}; " + "; ".join(f"{t}: {c}" for t, c in zip(traces, checked)))
    return {f"distributed rank {r}": launches for r, launches in enumerate(per_rank)}


#: the kernels each command of phase 10 must launch on a mesh
MESH_KERNELS = {
    "count": ("canonical_kmers", "partition_ids", "run_bounds"),
    "loose diff": ("run_bounds", "compact", "lrt_filter"),
    "popstrat diff": ("run_bounds", "compact", "run_rows", "geno_sample",
                      "int_gram", "irls", "lrt_filter"),
    "run": ("canonical_kmers", "run_bounds", "assemble_chunk", "lrt_filter"),
    "count k=63": ("canonical_kmers_mw", "partition_ids", "run_bounds_mw"),
    "loose diff k=63": ("run_bounds_mw", "compact", "lrt_filter"),
    "popstrat diff k=63": ("run_bounds_mw", "compact", "run_rows",
                           "geno_sample_mw", "int_gram", "irls", "lrt_filter"),
    "run k=63": ("canonical_kmers_mw", "run_bounds_mw", "assemble_chunk_mw",
                 "lrt_filter"),
}
#: the kernels the real-card section must launch on every card (the
#: multi-word merges' among them: a k > 32 merge on every card)
EVERY_CARD = ("canonical_kmers", "canonical_kmers_mw", "partition_ids",
              "int_gram", "run_bounds_mw", "assemble_chunk_mw", "geno_sample_mw")


def _mesh_commands(fof: str, tag: str) -> tuple[dict, dict]:
    """Phase 10's eight command lines for outputs tagged `tag`, and each
    command's output directory."""
    loose = ["-1", str(N_CONTROLS), "-2", str(N_CASES), "--threads", "4", "-s",
             "0.001", "--cutoff", "1", "-c", "disabled"]
    count = ["--file", fof, "--hard-min", "1", "--nb-partitions", "4",
             "--threads", "4"]
    outs = {name: os.path.join(WORK, f"mesh_{tag}_{name.replace(' ', '_')}")
            for name in MESH_KERNELS}
    run_dir = outs["count"]
    return {
        "count": ["count", *count, "--kmer-size", "31", "--run-dir", run_dir],
        "loose diff": ["diff", "--km-run-dir", run_dir, *loose, "--output-dir",
                       outs["loose diff"]],
        "popstrat diff": ["diff", "--km-run-dir", run_dir, *loose,
                          "--pop-correction", "--save-sk", "--output-dir",
                          outs["popstrat diff"]],
        "run": ["run", *count, "--kmer-size", "31", *loose, "--run-dir",
                f"{outs['run']}_rd", "--output-dir", outs["run"]],
        "count k=63": ["count", *count, "--kmer-size", "63", "--run-dir",
                       outs["count k=63"]],
        "loose diff k=63": ["diff", "--km-run-dir", outs["count k=63"], *loose,
                            "--output-dir", outs["loose diff k=63"]],
        "popstrat diff k=63": ["diff", "--km-run-dir", outs["count k=63"], *loose,
                               "--pop-correction", "--save-sk", "--output-dir",
                               outs["popstrat diff k=63"]],
        "run k=63": ["run", *count, "--kmer-size", "63", *loose, "--run-dir",
                     f"{outs['run k=63']}_rd", "--output-dir", outs["run k=63"]],
    }, outs


def _same_files(label: str, a: str, b: str, subs) -> int:
    """Require every file of a/sub equal to b/sub (names and bytes);
    returns the number of files."""
    n = 0
    for sub in subs:
        names = sorted(os.listdir(os.path.join(b, sub)))
        if sorted(os.listdir(os.path.join(a, sub))) != names:
            raise AssertionError(f"phase 10 {label} {sub}: other files than {b}'s")
        for name in names:
            if not _same_bytes(os.path.join(a, sub, name), os.path.join(b, sub, name)):
                raise AssertionError(f"phase 10 {label} {sub}/{name} differs from {b}'s")
        n += len(names)
    return n


def _check_mesh_output(label: str, out: str, ref: str) -> str:
    """Hold a phase-10 command's output against its reference: count files,
    histograms and the run directory's files; the FASTA; popstrat's FASTA,
    pcs.evec and --save-sk matrices."""
    fasta = ("control_kmers.fasta", "case_kmers.fasta")
    if label.startswith("count"):
        n = _same_files(label, out, ref, [
            *(os.path.join("counts", f"partition_{p}") for p in range(4)),
            "histograms"])
        if label == "count":
            for name in ("kmtricks.fof", "kmdiff-count.opt"):
                if not _same_bytes(os.path.join(out, name), os.path.join(ref, name)):
                    raise AssertionError(f"phase 10 count: {name} differs")
        return f"{n} files byte-identical"
    names = list(fasta)
    n_mat = 0
    if label.startswith("popstrat diff"):
        names.append(os.path.join("popstrat", "pcs.evec"))
        n_mat = _same_files(label, out, ref, [os.path.join(
            "positive_kmer_matrix", "matrices")])
    for name in names:
        if not _same_bytes(os.path.join(out, name), os.path.join(ref, name)):
            raise AssertionError(f"phase 10 {label} {name} differs from {ref}'s")
    return ("FASTA" + (f", pcs.evec and {n_mat} matrices" if n_mat else "")
            + " byte-identical")


def _drive(argv, dev) -> float:
    """One phase-10 command on `dev`; its wall seconds. `run` goes through
    cmd.run.main_run (the options the CLI builds), which must take the
    fused path."""
    from kmdiff_tpu_torch.cli import count_options, diff_options, main, parse_args
    from kmdiff_tpu_torch.cmd.run import main_run
    from kmdiff_tpu_torch.parallel import runtime

    t0 = time.perf_counter()
    if argv[0] != "run":
        if main(argv, device=dev) != 0:
            raise AssertionError(f"phase 10: {argv[0]} failed")
        return time.perf_counter() - t0
    args = parse_args(argv)
    timings = {}
    try:
        main_run(count_options(args), diff_options(args), dev,
                 recurrence_min=args.recurrence_min,
                 count_files=not args.no_count_files, timings=timings)
    finally:
        runtime.configure(None)
    if "merge" not in timings:
        raise AssertionError("phase 10: run was not served by the fused path")
    return time.perf_counter() - t0


def run_mesh(dev, fof: str, refs: dict | None) -> dict:
    """Phase 10: the mesh runtime on phase 3's cohort at its full size. The
    eight commands (count, the loose diff, popstrat diff --save-sk, the
    fused loose run, and at k = 63 count, the loose diff, popstrat diff
    --save-sk and the fused loose run) run with --devices 1, then on a
    virtual mesh of two shards on the first card (parallel.runtime's
    switch), then, when the machine has two cards or more, on min(4,
    cards) real cards. Every mesh output must be byte-identical to the
    one-shard run's, which must be byte-identical to refs (phases 3, 5 and
    7's outputs) where given; each command must launch MESH_KERNELS, and
    the real-card section EVERY_CARD on every card. Prints each command's
    wall beside the one-shard wall. Returns the launches of the virtual
    two-shard run (all eight commands)."""
    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.parallel import runtime

    n_cards = torch.cuda.device_count()
    configs = [("one shard", 1, False), ("2 shards on cuda:0 (virtual)", 2, True)]
    if n_cards >= 2:
        configs.append((f"{min(4, n_cards)} cards", min(4, n_cards), False))
    walls, mesh_launches = {}, None
    one_outs = None
    try:
        for name, D, virtual in configs:
            runtime.set_virtual(virtual)
            commands, outs = _mesh_commands(fof, f"d{D}{'v' if virtual else ''}")
            launches = dict.fromkeys(kernels.launch_counts(), 0)
            cards: dict[int, dict] = {}
            for label, argv in commands.items():
                kernels.reset_launch_counts()
                wall = _drive([*argv, "--devices", str(D)], dev)
                got = kernels.launch_counts()
                require_launches(f"phase 10 {name} {label}", got,
                                 MESH_KERNELS[label] if D > 1 else
                                 [k for k in MESH_KERNELS[label] if k != "partition_ids"])
                if D == 1 and got["partition_ids"]:
                    raise AssertionError(f"phase 10 one shard {label} launched K-PART")
                for d, by in kernels.launch_counts_by_device().items():
                    for k, v in by.items():
                        cards.setdefault(d, dict.fromkeys(by, 0))[k] += v
                for k, v in got.items():
                    launches[k] += v
                if D == 1:
                    walls[label] = wall
                    line = f"{wall:.3f} s wall"
                    if refs:
                        line += "; " + _check_mesh_output(
                            label, outs[label], refs[label]) + f" to {refs[label]}'s"
                else:
                    what = _check_mesh_output(label, outs[label], one_outs[label])
                    line = (f"{wall:.3f} s wall against one shard's "
                            f"{walls[label]:.3f} s ({wall / walls[label]:.2f}x); "
                            f"{what} to one shard's")
                print(f"[mesh {name}] {label}: {line}; launches (above 0) "
                      + str({k: v for k, v in got.items() if v}))
            if D == 1:
                one_outs = outs
            elif virtual:
                mesh_launches = launches
            else:
                for d in range(D):
                    missing = [k for k in EVERY_CARD if not cards.get(d, {}).get(k)]
                    if missing:
                        raise AssertionError(f"phase 10 {name}: cuda:{d} never "
                                             f"launched {missing}")
                print(f"[mesh {name}] launches by card: " + "; ".join(
                    f"cuda:{d} " + str({k: v for k, v in by.items() if v})
                    for d, by in sorted(cards.items())))
    finally:
        runtime.set_virtual(False)
        runtime.configure(None)
    print(f"[mesh] two shards on one card measure the overhead of sharding, "
          f"not a speedup; real cards: "
          + (f"{min(4, n_cards)} of {n_cards}" if n_cards >= 2
             else "not run (one card on this machine)"))
    return mesh_launches


#: the kernels phase 11's warmup must launch: every kernel of the main path
#: (count + diff and the fused run, K-WRUN's two-chunk dedup among them) and
#: of popstrat
WARMUP_KERNELS = (*RUN_KERNELS, "weighted_runs", *POP_KERNELS)


def run_warmup(dev) -> dict:
    """Phase 11: `warmup -1 10 -2 10 --pop` (cmd.warmup.main_warmup, what
    the CLI runs) on the built libraries; it must launch WARMUP_KERNELS.
    Prints each group's seconds; returns its launches."""
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.cmd.warmup import main_warmup

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    seconds = main_warmup(N_CONTROLS, N_CASES, 31, dev, pop=True)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require_launches("warmup", launches, WARMUP_KERNELS)
    print(f"[warmup -1 {N_CONTROLS} -2 {N_CASES} --pop] {wall:.3f} s wall; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
          + " (builds 0 when built); launches (above 0) "
          + str({k: n for k, n in launches.items() if n}))
    return launches


def load_native() -> None:
    """Build and load the port's native host-IO library; it must come from
    the checkout's build/kmdiff_tpu_torch/native/."""
    from kmdiff_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host-IO library did not build")
    want = os.path.join(HERE, "build", "kmdiff_tpu_torch", "native") + os.sep
    loaded = native.lib()._name
    if not os.path.abspath(loaded).startswith(want):
        raise AssertionError(f"native library loaded from {loaded}, not {want}")
    print(f"native host-IO library loaded in {time.perf_counter() - t0:.1f} s: "
          f"{loaded}")


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
    for tag, source in (("K-EXT", "canonical_kmers"), ("K-GRAM", "int_gram"),
                        ("K-PART", "partition_ids")):
        ptxas = [line.strip() for line in
                 kernels.build_log.get(source, "").splitlines()
                 if "registers" in line or "spill" in line]
        print(f"[{tag}] nvcc -Xptxas -v: " + ("; ".join(ptxas) or
                                              "(library loaded from an earlier build)"))
    load_native()

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        timings = compare_kernels(dev)
        phase3 = run_main_path(dev)
        fused_launches = run_fused(dev, phase3)
        pop_launches, pop_run_launches, gram_groups, pop_walls = run_popstrat(
            dev, phase3)
        timings["int_gram"].update(compare_gram_groups(gram_groups))
        del gram_groups
        wide_launches = run_wide(dev, phase3)
        mw_launches = run_multiword(dev, phase3)
        plugin_launches = run_plugins(dev, phase3)
        dist_launches = run_distributed(phase3, pop_walls)
        mesh_launches = run_mesh(dev, phase3["fof"], {
            "count": phase3["run"],
            "loose diff": os.path.join(WORK, "loose_gpu"),
            "popstrat diff": os.path.join(WORK, "pop_gpu"),
            "run": os.path.join(WORK, "loose_gpu"),
            "count k=63": os.path.join(WORK, "run_k63"),
            "loose diff k=63": os.path.join(WORK, "k63_loose_gpu"),
            "popstrat diff k=63": os.path.join(WORK, "pop_k63_gpu"),
            "run k=63": os.path.join(WORK, "k63_loose_gpu"),
        })
        warmup_launches = run_warmup(dev)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    paths = {"count+diff": phase3["launches"], "run (a)": fused_launches["a"],
             "run (b)": fused_launches["b"], "popstrat diff": pop_launches,
             "popstrat run": pop_run_launches, "wide diff": wide_launches["a"],
             "wide popstrat diff": wide_launches["b"],
             "forced-wide run": wide_launches["c"], **mw_launches,
             **plugin_launches, **dist_launches,
             "mesh (2 virtual shards)": mesh_launches, "warmup": warmup_launches}
    for name in timings:
        print(f"[launches] {name}: " + ", ".join(
            f"{path} {launches[name]}" for path, launches in paths.items()))
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "kmdiff_tpu")]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")

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
        "run_rows": ("kmdiff_tpu/ops/merge_dev.py:302", pop_launches),
        "geno_sample": ("kmdiff_tpu/ops/merge_dev.py:39", pop_launches),
        "int_gram": ("kmdiff_tpu/ops/pca.py:47", pop_launches),
        "irls": ("kmdiff_tpu/ops/glm.py:45", pop_launches),
        # the multi-word forms, their launches on phase 7's k = 63 paths
        "canonical_kmers_mw": ("kmdiff_tpu/ops/codec.py:73",
                               mw_launches["count+diff k=63"]),
        "run_bounds_mw": ("kmdiff_tpu/ops/codec.py:341",
                          mw_launches["count+diff k=63"]),
        "assemble_chunk_mw": ("kmdiff_tpu/pipeline/fused.py:387",
                              mw_launches["run (a) k=63"]),
        "geno_sample_mw": ("kmdiff_tpu/ops/merge_dev.py:323",
                           mw_launches["popstrat diff k=63"]),
        # K-PART runs on the mesh path only: phase 10's two virtual shards
        "partition_ids": ("kmdiff_tpu/ops/codec.py:175", mesh_launches),
        # K-FASTA replaces none (the JAX package decodes on the host)
        "fasta_codes": ("none", fused_launches["a"]),
    }
    rows = []
    for name, (replaces, launches) in meta.items():
        rows.append({
            "name": name, "route": "cuda",
            "source": f"kmdiff_tpu_torch/csrc/{kernels.MULTIWORD.get(name, name)}.cu",
            "replaces": replaces, "launches": launches[name], **timings[name],
        })
        if "wide_ms" in timings[name] and name != "abundance_hist":
            # the wide forms' launches on phase 6's wide diff
            rows[-1]["wide_launches"] = wide_launches["a"][name]
        # phase 9: the launches of both ranks over their four commands
        rows[-1]["dist_launches"] = sum(d[name] for d in dist_launches.values())
        # phase 10: the launches of the two virtual shards' eight commands
        rows[-1]["mesh_launches"] = mesh_launches[name]
        # phase 11: warmup's
        rows[-1]["warmup_launches"] = warmup_launches[name]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
