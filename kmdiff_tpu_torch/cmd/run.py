"""`run`: FASTA -> significant k-mers in one process (port of
kmdiff_tpu/cmd/run.py; one device, or a mesh of shards: --devices).

A fresh run decodes every sample's FASTA/FASTQ files on the device
(io.fasta.device_codes: the host reads the bytes, K-FASTA makes the codes),
counts it to a stream that stays there (pipeline.fused) and merges the
streams there: the host decode of the reads, the count's device-to-host
copy of the keys, and the diff's file decode and host group pre-sum, leave
the critical path. The kmtricks-format run directory is still written:
histograms at once (the model's totals come from them), count files by
background threads that overlap the merge, or not at all with
--no-count-files. Outputs are byte-identical to count + diff.

With --pop-correction the merge keeps the survivors' count rows and
samples the geno rows (pipeline.fused's full merge), the resident streams
are let go, and popstrat corrects the hits (pipeline.popstrat) before the
output. A cohort whose k-mer mass reaches 2^31 takes the full merge too,
for its int64 group sums.

KMDIFF_GROUP_MERGE=1, the JAX package's opt-in group pre-aggregation, is
accepted and ignored: it changes no output, and the merge reads the
per-sample streams.

Custom models (--model), the multi-process runtime (--distributed: each
rank takes its share of count and diff) and resumes (an existing
options.json, or a run directory with every count file) take the standard
count + diff flow, and
so does a cohort the fused path cannot serve (FusedFallback) or a device
allocation that fails during the fused attempt, on the same device.
"""

from __future__ import annotations

import concurrent.futures as cf
import gc
import os
import shutil
import time

import torch

from kmdiff_tpu_torch import profiling
from kmdiff_tpu_torch.cmd.options import CountOptions, DiffOptions, dump_options
from kmdiff_tpu_torch.parallel.distributed import (
    from_primary,
    is_distributed,
    is_primary,
)
from kmdiff_tpu_torch.utils.logging import logger
from kmdiff_tpu_torch.utils.timer import Timer
from kmdiff_tpu_torch.pipeline.fused import FusedFallback


def _run_dir_complete(run_dir: str) -> bool:
    """True when every fof sample has its count file in every partition."""
    from kmdiff_tpu_torch.io.kmtricks import read_fof

    fof_path = os.path.join(run_dir, "kmtricks.fof")
    counts = os.path.join(run_dir, "counts")
    if not (os.path.exists(fof_path) and os.path.isdir(counts)):
        return False
    fof = read_fof(run_dir)
    for pdir in sorted(os.listdir(counts)):
        for e in fof.entries:
            if not os.path.exists(os.path.join(counts, pdir, f"{e.id}.kmer.lz4")):
                return False
    return True


def _standard_flow(copt: CountOptions, dopt: DiffOptions,
                   device: torch.device) -> dict:
    from kmdiff_tpu_torch.cmd.count import main_count
    from kmdiff_tpu_torch.cmd.diff import main_diff

    # the primary probes the run directory before any rank writes to it
    if not from_primary(_run_dir_complete(copt.directory) if is_primary()
                        else None):
        main_count(copt, device)
    return main_diff(dopt, device)


def main_run(copt: CountOptions, dopt: DiffOptions, device: torch.device,
             recurrence_min: int = 1, count_files: bool = True,
             timings: dict | None = None) -> dict:
    """The `run` command. recurrence_min is accepted and not applied, as in
    the count stage. timings, when given, receives the wall seconds of the
    fused path's phases ("count", "merge", "total", and with popstrat
    "pca", "null_fit", "alt_fits") and the thread-seconds of the spans
    opened (profiling.collect: "parse_thread_s", "h2d_thread_s",
    "count_thread_s" a sample, "merge_chunk_thread_s", "device_thread_s" a
    merge chunk) and the counts of files decoded, "parse_files", and of
    those the record parser took, "parse_fallback_files"
    (io.fasta.device_codes); the result dict is main_diff's. The shard budget
    (--devices) configures the mesh runtime (parallel.runtime)."""
    from kmdiff_tpu_torch.parallel import runtime

    runtime.configure(dopt.n_devices)
    manifest = os.path.join(dopt.output_directory, "options.json")
    with profiling.collect(timings):
        if (is_distributed() or dopt.model_lib_path or os.path.exists(manifest)
                or _run_dir_complete(copt.directory)):
            logger.info("run: using the standard count+diff flow.")
            return _standard_flow(copt, dopt, device)
        try:
            return _main_run_fused(copt, dopt, device, count_files, timings)
        except (FusedFallback, torch.cuda.OutOfMemoryError) as e:
            reason = f"{type(e).__name__}: {e}"
        # outside the handler: the exception is gone, and with it the
        # traceback whose frames held the resident streams
        logger.warning("fused pipeline unavailable (%s); running the standard "
                       "count+diff flow.", reason)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return _standard_flow(copt, dopt, device)


class _Spills:
    """The count files of the resident streams, written by two background
    threads: queued while the samples count, started once counting ends
    (they then overlap the merge and the correction), and drained on every
    way out of the fused attempt, so nothing writes into the run directory
    once it is left; the standard flow then resumes from complete files."""

    def __init__(self, enabled: bool):
        self._pool = (cf.ThreadPoolExecutor(2, thread_name_prefix="kmdiff-spill")
                      if enabled else None)
        self._queued: list[tuple] = []
        self._futures: list[cf.Future] = []

    def queue(self, *job) -> None:
        if self._pool is not None:
            self._queued.append(job)

    def start(self) -> None:
        from kmdiff_tpu_torch.pipeline.count import spill_resident_sample

        while self._queued:
            self._futures.append(
                self._pool.submit(spill_resident_sample, *self._queued.pop()))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._pool is None:
            return False
        self.start()
        t0 = time.perf_counter()
        errors = [e for e in (f.exception() for f in self._futures) if e]
        self._pool.shutdown(wait=True)
        self._pool = None
        logger.info("Count files written (%d samples; waited %.2fs for the "
                    "spills).", len(self._futures), time.perf_counter() - t0)
        if errors and exc_type is None:
            raise errors[0]
        for e in errors:
            logger.warning("count-file spill failed: %s", e)
        return False


def _main_run_fused(copt: CountOptions, dopt: DiffOptions,
                    device: torch.device, count_files: bool,
                    timings: dict | None) -> dict:
    from kmdiff_tpu_torch.core.model import PoissonLikelihood
    from kmdiff_tpu_torch.io.kmtricks import (
        Fof,
        KmtricksConfig,
        get_total_kmer,
        hist_from_device,
        write_hist,
    )
    from kmdiff_tpu_torch.utils.exceptions import InputError
    from kmdiff_tpu_torch.utils.rss import get_peak_rss_mb
    from kmdiff_tpu_torch.cmd.diff import (
        _make_accumulators,
        do_correction,
        save_sk_dir,
    )
    from kmdiff_tpu_torch.io.fasta import FileStaging, device_codes
    from kmdiff_tpu_torch.pipeline import fused
    from kmdiff_tpu_torch.pipeline.merge import PartitionProcessor

    whole = Timer()
    fof = Fof.parse(copt.fof)
    if not fof.entries:
        raise InputError(f"{copt.fof}: empty fof")
    if dopt.nb_controls + dopt.nb_cases != len(fof.entries):
        raise InputError(
            f"cohort size mismatch: -1 {dopt.nb_controls} + -2 "
            f"{dopt.nb_cases} != fof's {len(fof.entries)} samples"
        )
    fof_dir = os.path.dirname(os.path.abspath(copt.fof))
    nb_partitions = copt.nb_partitions or 4
    run_dir = copt.directory
    k = copt.kmer_size

    # the run directory's fof, config and histograms land at once (totals
    # and any later resume read them); count files are the only bulk
    os.makedirs(os.path.join(run_dir, "histograms"), exist_ok=True)
    for p in range(nb_partitions):
        os.makedirs(os.path.join(run_dir, "counts", f"partition_{p}"),
                    exist_ok=True)
    shutil.copyfile(copt.fof, os.path.join(run_dir, "kmtricks.fof"))
    with open(os.path.join(run_dir, "kmdiff-count.opt"), "w") as f:
        f.write(f"kmer_size={k}, abundance_min={copt.hard_min}\n")

    logger.info("Fused pipeline: counting %d samples (k=%d) to device-resident "
                "streams.", len(fof.entries), k)
    with _Spills(count_files) as spills:
        count_timer = Timer()
        streams: list = [None] * len(fof.entries)

        def one_sample(i: int) -> None:
            entry = fof.entries[i]
            paths = [p if os.path.isabs(p) else os.path.join(fof_dir, p)
                     for p in entry.paths]
            codes = [c for c in (device_codes(p, device, staging) for p in paths)
                     if len(c)]
            hard_min = entry.ab_min or copt.hard_min
            st = fused.count_sample_resident(codes, k, hard_min, device)
            streams[i] = st
            write_hist(
                os.path.join(run_dir, "histograms", f"{entry.id}.hist"),
                hist_from_device(st.hist_uvec, st.total_mass,
                                 st.n_distinct_pre, i, k),
            )
            logger.info("[%s] %d distinct k-mers (%d after hard-min=%d), "
                        "resident.", entry.id, st.n_distinct_pre, st.U, hard_min)
            spills.queue(run_dir, entry.id, i, k, nb_partitions, st)

        # samples on host threads: a sample's file reads overlap the
        # device work, which queues on one stream; each thread reads its
        # files into its own staging buffer, freed once the samples are in
        with (FileStaging(device) as staging,
              cf.ThreadPoolExecutor(max(1, copt.nb_threads)) as pool):
            list(pool.map(one_sample, range(len(fof.entries))))
        resident = sum(st.nbytes for st in streams)
        if timings is not None:
            timings["count"] = count_timer.elapsed()
        logger.info("Counted %d samples in %s (%.2f GB resident).",
                    len(fof.entries), count_timer.formatted(), resident / 1e9)
        if resident > fused.HBM_BUDGET:
            raise FusedFallback(
                f"resident streams {resident / 1e9:.1f} GB exceed "
                f"KMDIFF_FUSED_BYTES={fused.HBM_BUDGET / 1e9:.1f} GB"
            )
        spills.start()

        # ---- diff over the resident streams ---------------------------------
        config = KmtricksConfig(kmer_size=k, nb_partitions=nb_partitions,
                                abundance_min=copt.hard_min)
        part_dir = os.path.join(dopt.output_directory, "partitions")
        os.makedirs(part_dir, exist_ok=True)
        total_controls, total_cases = get_total_kmer(
            run_dir, dopt.nb_controls, dopt.nb_cases, config.abundance_min
        )
        model = PoissonLikelihood(dopt.nb_controls, dopt.nb_cases,
                                  total_controls, total_cases, dopt.log_size)
        sampler = None
        pop_dir = os.path.join(dopt.output_directory, "popstrat")
        if dopt.pop_correction:
            from kmdiff_tpu_torch.pipeline.popstrat import GenoSampler

            os.makedirs(pop_dir, exist_ok=True)
            sampler = GenoSampler(pop_dir, dopt.kmer_pca, dopt.seed,
                                  dopt.nb_controls + dopt.nb_cases)
        processor = PartitionProcessor(
            model, dopt.nb_controls, dopt.nb_cases,
            threshold=dopt.threshold / dopt.cutoff, device=device,
            keep_counts=dopt.pop_correction, sampler=sampler,
            save_matrix_path=save_sk_dir(dopt),
        )
        accumulators = _make_accumulators(dopt, nb_partitions, k, part_dir,
                                          read=False)
        merge_timer = Timer()
        logger.info("Process resident streams")
        total_kmers, nb_sign, sign_controls, sign_cases = fused.fused_merge(
            processor, accumulators, streams, nb_partitions, k
        )
        # the queued spills hold what they still need; the rest of the
        # resident streams' memory goes before the popstrat kernels run
        streams.clear()
        if sampler is not None:
            sampler.close()
        dopt.total_kmers = total_kmers
        if timings is not None:
            timings["merge"] = merge_timer.elapsed()
        logger.info("Partitions processed (%s)", merge_timer.formatted())
        logger.info("%d/%d significant k-mers.", nb_sign, total_kmers)
        logger.info("Before correction: %d (control), %d (case).",
                    sign_controls, sign_cases)
        dump_options(dopt, os.path.join(dopt.output_directory, "options.json"))
        if dopt.pop_correction:
            from kmdiff_tpu_torch.pipeline.popstrat import do_pop

            accumulators = do_pop(dopt, config, accumulators, pop_dir,
                                  part_dir, device, timings)
        counts = do_correction(dopt, config, accumulators, total_kmers)
        for acc in accumulators:
            acc.destroy()
    if timings is not None:
        timings["total"] = whole.elapsed()
    logger.info("Done in %s, Peak RSS -> %d MB.", whole.formatted(),
                get_peak_rss_mb())
    return {"total_kmers": total_kmers, "control": counts[0], "case": counts[1]}
