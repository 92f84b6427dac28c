"""`diff`: the differential analysis (port of kmdiff_tpu/cmd/diff.py). Stages:

  1. load the run dir's config and per-sample totals (histograms)
  2. resume detection against the options manifest and spilled partitions
  3. per-partition merge + Poisson LR filter on the device (pipeline.merge),
     with --pop-correction the geno sample and the survivors' count rows;
     a custom model (--model) scores the host union merge instead
  4. optional population-stratification correction (pipeline.popstrat)
  5. multiple-testing correction + control/case FASTA|KFF
     (pipeline.aggregate)

Under the multi-process runtime (parallel.distributed) each rank merges and
corrects its share of the partitions, and the primary fits the null model
and writes the output.
"""

from __future__ import annotations

import os

import torch

from kmdiff_tpu_torch import profiling
from kmdiff_tpu_torch.cmd.options import (
    REDO_MERGE,
    REDO_POP,
    DiffOptions,
    compare_options,
    dump_options,
    load_options,
)
from kmdiff_tpu_torch.core.corrector import make_corrector
from kmdiff_tpu_torch.core.model import PoissonLikelihood
from kmdiff_tpu_torch.io.accumulator import FileAccumulator, partitions_exist
from kmdiff_tpu_torch.io.kmtricks import (
    get_matrix_paths,
    get_partition_paths,
    get_total_kmer,
    read_config,
    read_fof,
)
from kmdiff_tpu_torch.parallel.distributed import (
    barrier,
    from_primary,
    global_sum,
    is_distributed,
    is_primary,
    owned_partitions,
    rank,
)
from kmdiff_tpu_torch.pipeline.aggregate import Aggregator
from kmdiff_tpu_torch.utils.exceptions import InputError
from kmdiff_tpu_torch.utils.logging import logger
from kmdiff_tpu_torch.utils.progress import get_progress_bar
from kmdiff_tpu_torch.utils.rss import get_peak_rss_mb
from kmdiff_tpu_torch.utils.timer import Timer
from kmdiff_tpu_torch.pipeline.merge import GlobalMerge, PartitionProcessor


def load_custom_model(opt: DiffOptions):
    """--model's plugin (plugins.load_model_plugin), or None without the
    flag. A custom model drops --pop-correction, with the JAX package's
    warning (kmdiff_tpu/cmd/diff.py:78-86)."""
    if not opt.model_lib_path:
        return None
    from kmdiff_tpu_torch.plugins import load_model_plugin

    if opt.pop_correction:
        logger.warning(
            "population stratification correction disabled with custom models."
        )
        opt.pop_correction = False
    return load_model_plugin(opt.model_lib_path, opt.model_config)


def save_sk_dir(opt: DiffOptions) -> str | None:
    """--save-sk's matrix directory, made; None without the flag."""
    if not opt.save_sk:
        return None
    path = os.path.join(opt.output_directory, "positive_kmer_matrix", "matrices")
    os.makedirs(path, exist_ok=True)
    return path


def nb_samples_of(opt: DiffOptions) -> int:
    """The spills' count-row width: the cohort with popstrat, else 0."""
    return opt.nb_controls + opt.nb_cases if opt.pop_correction else 0


def _make_accumulators(opt: DiffOptions, nb_partitions: int, kmer_size: int,
                       part_dir: str, read: bool, spill: str = "uncorrected"):
    if opt.in_memory and not read:
        # -m/--in-memory: significant k-mers stay in RAM, no spill files
        # (and so nothing to resume from)
        from kmdiff_tpu_torch.io.accumulator import VectorAccumulator

        return [VectorAccumulator() for _ in range(nb_partitions)]
    return [
        FileAccumulator(
            os.path.join(part_dir, f"p{i}_{spill}"),
            kmer_size,
            read=read,
            delete_on_destroy=not opt.keep_tmp,
            nb_samples=nb_samples_of(opt),
        )
        for i in range(nb_partitions)
    ]


def do_diff(opt: DiffOptions, config, accumulators, device: torch.device,
            sampler=None, model=None, owned: list[int] | None = None) -> int:
    """Merge + test stage (reference: diff.hpp:66-164) with `model`, the
    Poisson likelihood when None; returns the number of distinct k-mers
    tested. `owned` restricts the merge to a rank's partitions under the
    multi-process runtime; the counters are then summed over the ranks."""
    timer = Timer()
    logger.info("Process partitions")

    total_controls, total_cases = get_total_kmer(
        opt.kmtricks_dir, opt.nb_controls, opt.nb_cases, config.abundance_min
    )
    logger.debug("Nb k-mers controls: %s", total_controls)
    logger.debug("Nb k-mers cases: %s", total_cases)
    if model is None:
        model = PoissonLikelihood(opt.nb_controls, opt.nb_cases,
                                  total_controls, total_cases, opt.log_size)
    processor = PartitionProcessor(
        model, opt.nb_controls, opt.nb_cases,
        threshold=opt.threshold / opt.cutoff, device=device,
        keep_counts=opt.pop_correction, sampler=sampler,
        save_matrix_path=save_sk_dir(opt),
    )
    n_jobs = config.nb_partitions if owned is None else len(owned)
    merger = GlobalMerge(
        processor, accumulators, nb_threads=opt.nb_threads,
        progress=get_progress_bar("progress", n_jobs),
    )
    matrix_paths = get_matrix_paths(opt.kmtricks_dir)
    if matrix_paths:
        total_kmers = merger.merge_matrices(matrix_paths, only=owned)
    else:
        total_kmers = merger.merge_partitions(
            get_partition_paths(opt.kmtricks_dir, config.nb_partitions),
            only=owned,
        )

    sign_controls, sign_cases = merger.signs()
    nb_sign = merger.nb_sign()
    if owned is not None:
        total_kmers, nb_sign, sign_controls, sign_cases = global_sum(
            [total_kmers, nb_sign, sign_controls, sign_cases])
    logger.info("Partitions processed (%s)", timer.formatted())
    logger.info("%d/%d significant k-mers.", nb_sign, total_kmers)
    logger.info(
        "Before correction: %d (control), %d (case).", sign_controls, sign_cases
    )
    return total_kmers


def do_correction(opt: DiffOptions, config, accumulators,
                  total_kmers: int) -> tuple[int, int]:
    """Correction + output stage (reference: diff.hpp:227-260); host only."""
    timer = Timer()
    if opt.correction.name == "NOTHING":
        logger.info("Aggregate partitions...")
    else:
        logger.info("Aggregate partitions and apply significance correction...")
    agg = Aggregator(
        accumulators,
        make_corrector(opt.correction, opt.threshold, total_kmers),
        config.kmer_size,
        opt.output_directory,
        kff=opt.kff,
        threshold=opt.threshold,
        total_kmers=total_kmers,
        progress=get_progress_bar("progress", config.nb_partitions),
    )
    agg.run()
    c_controls, c_cases = agg.counts()
    logger.info("Partitions aggregated (%s)", timer.formatted())
    logger.info("Significant k-mers: %d (control), %d (case).", c_controls, c_cases)
    return c_controls, c_cases


def _probe_resume(opt: DiffOptions, nb_partitions: int, part_dir: str,
                  manifest: str) -> tuple:
    """What a rerun can reuse, from the options manifest and the spills:
    (the compare_options action, the merge's spills all there, popstrat's
    spills all there, both output files there, the manifest's total_kmers);
    (0, False, False, False, None) without a manifest."""
    if not os.path.exists(manifest):
        return 0, False, False, False, None
    prev_opt = load_options(manifest)
    action = compare_options(opt, prev_opt)
    prev_merge = partitions_exist("{}/p{}_uncorrected", nb_partitions, part_dir)
    prev_pop = partitions_exist("{}/p{}_popstrat_uncorrected", nb_partitions,
                                part_dir)
    ext = "kff" if opt.kff else "fasta"
    prev_out = all(
        os.path.exists(os.path.join(opt.output_directory, f"{g}_kmers.{ext}"))
        for g in ("control", "case")
    )
    logger.debug("resume: merge=%s pop=%s output=%s action=%d",
                 prev_merge, prev_pop, prev_out, action)
    return action, prev_merge, prev_pop, prev_out, prev_opt.total_kmers


def main_diff(opt: DiffOptions, device: torch.device,
              timings: dict | None = None) -> dict:
    """Orchestrator with resume (reference: diff.hpp:262-377): an unchanged
    rerun reuses the spilled partitions; a new threshold or cutoff redoes
    the merge; a new popstrat setting redoes the correction from the
    merge's spills, and a rerun with intact popstrat spills aggregates the
    corrected ones; a new correction only redoes the output. timings, when
    given, receives popstrat's "pca", "null_fit" and "alt_fits" seconds and
    the thread-seconds of the spans opened (profiling.collect: the merge's
    "partition_thread_s" and, in its partitions, "decode_thread_s",
    "groupsum_thread_s", "build_thread_s", "h2d_thread_s" and
    "device_thread_s"; pipeline.merge.PartitionProcessor).
    With --model the plugin is loaded (and refused) before anything else,
    on every rank. Under the multi-process runtime the ranks share the
    partitions (_main_diff_distributed). The shard budget (--devices)
    configures the mesh runtime (parallel.runtime)."""
    with profiling.collect(timings):
        return _main_diff(opt, device, timings)


def _main_diff(opt: DiffOptions, device: torch.device,
               timings: dict | None) -> dict:
    from kmdiff_tpu_torch.parallel import runtime

    runtime.configure(opt.n_devices)
    model = load_custom_model(opt)
    whole = Timer()
    config = read_config(opt.kmtricks_dir)
    n_fof = len(read_fof(opt.kmtricks_dir))
    if opt.nb_controls + opt.nb_cases != n_fof:
        raise InputError(
            f"cohort size mismatch: -1 {opt.nb_controls} + -2 {opt.nb_cases} "
            f"= {opt.nb_controls + opt.nb_cases}, but the run dir's fof has "
            f"{n_fof} samples"
        )

    if is_distributed():
        return _main_diff_distributed(opt, config, device, model, whole,
                                      timings)

    part_dir = os.path.join(opt.output_directory, "partitions")
    os.makedirs(part_dir, exist_ok=True)
    manifest = os.path.join(opt.output_directory, "options.json")
    action, prev_merge, prev_pop, prev_out, prev_total = _probe_resume(
        opt, config.nb_partitions, part_dir, manifest)

    pop_dir = os.path.join(opt.output_directory, "popstrat")
    if opt.pop_correction:
        os.makedirs(pop_dir, exist_ok=True)

    redo_merge = not prev_merge or bool(action & REDO_MERGE)
    if redo_merge:
        sampler = None
        if opt.pop_correction:
            from kmdiff_tpu_torch.pipeline.popstrat import GenoSampler

            sampler = GenoSampler(pop_dir, opt.kmer_pca, opt.seed,
                                  opt.nb_controls + opt.nb_cases)
        accumulators = _make_accumulators(
            opt, config.nb_partitions, config.kmer_size, part_dir, read=False
        )
        opt.total_kmers = do_diff(opt, config, accumulators, device, sampler,
                                  model)
        if sampler is not None:
            sampler.close()
    else:
        opt.total_kmers = prev_total
        accumulators = _make_accumulators(
            opt, config.nb_partitions, config.kmer_size, part_dir, read=True
        )
    dump_options(opt, manifest)

    redo_pop = opt.pop_correction and (
        not prev_pop or bool(action & REDO_POP) or redo_merge)
    if redo_pop:
        from kmdiff_tpu_torch.pipeline.popstrat import do_pop

        accumulators = do_pop(opt, config, accumulators, pop_dir, part_dir,
                              device, timings)
    elif opt.pop_correction:
        # intact popstrat spills: aggregate the CORRECTED hits (the
        # reference keeps the uncorrected ones here, diff.hpp:355-364,
        # and drops the correction; the JAX package fixes that too)
        for acc in accumulators:
            acc.destroy()
        accumulators = _make_accumulators(
            opt, config.nb_partitions, config.kmer_size, part_dir, read=True,
            spill="popstrat_uncorrected",
        )

    counts = (0, 0)
    if not prev_out or action > 0 or redo_merge or redo_pop:
        counts = do_correction(opt, config, accumulators, opt.total_kmers)
    for acc in accumulators:
        acc.destroy()

    logger.info("Done in %s, Peak RSS -> %d MB.", whole.formatted(),
                get_peak_rss_mb())
    return {
        "total_kmers": opt.total_kmers,
        "control": counts[0],
        "case": counts[1],
    }


def _main_diff_distributed(opt: DiffOptions, config, device: torch.device,
                           model, whole: Timer, timings: dict | None) -> dict:
    """`diff` over the ranks of the multi-process runtime (port of
    kmdiff_tpu/cmd/diff.py::_main_diff_distributed): each rank merges and,
    with popstrat, corrects its round-robin share of the partitions; the
    primary writes options.json, assembles the geno matrix, fits PCA and the
    null model (the other ranks load it from null_fit.npz), and aggregates
    and writes the output. Spills are always files on the shared
    filesystem (--in-memory does not apply), kept until the primary's
    clean-up. The primary takes the resume decision from the manifest and
    the spills before any rank writes, and every rank follows it, so a rank
    that starts late never sees another's fresh files. Outputs are
    byte-identical to a single process's."""
    pid = rank()
    part_dir = os.path.join(opt.output_directory, "partitions")
    os.makedirs(part_dir, exist_ok=True)
    manifest = os.path.join(opt.output_directory, "options.json")
    owned = owned_partitions(config.nb_partitions)
    nb_samples = nb_samples_of(opt)
    logger.info("distributed diff: process %d owns partitions %s", pid, owned)
    action, prev_merge, prev_pop, prev_out, prev_total = from_primary(
        _probe_resume(opt, config.nb_partitions, part_dir, manifest)
        if is_primary() else None)

    def spill(p: int, name: str, read: bool) -> FileAccumulator:
        return FileAccumulator(os.path.join(part_dir, f"p{p}_{name}"),
                               config.kmer_size, read=read,
                               delete_on_destroy=False, nb_samples=nb_samples)

    pop_dir = os.path.join(opt.output_directory, "popstrat")
    if opt.pop_correction:
        os.makedirs(pop_dir, exist_ok=True)

    redo_merge = not prev_merge or bool(action & REDO_MERGE)
    if redo_merge:
        sampler = None
        if opt.pop_correction:
            from kmdiff_tpu_torch.pipeline.popstrat import GenoSampler

            sampler = GenoSampler(pop_dir, opt.kmer_pca, opt.seed,
                                  opt.nb_controls + opt.nb_cases)
        accumulators: list = [None] * config.nb_partitions
        for p in owned:
            accumulators[p] = spill(p, "uncorrected", read=False)
        opt.total_kmers = do_diff(opt, config, accumulators, device, sampler,
                                  model, owned=owned)
        if sampler is not None:
            sampler.close_parts()
        for p in owned:
            accumulators[p].destroy()  # closed; the spill stays
    else:
        opt.total_kmers = prev_total
        logger.info("process %d: merge stage resumed from spills.", pid)
    barrier("merge_done")
    if is_primary():
        dump_options(opt, manifest)

    redo_pop = opt.pop_correction and (
        not prev_pop or bool(action & REDO_POP) or redo_merge)
    if redo_pop:
        from kmdiff_tpu_torch.pipeline.popstrat import (
            GenoSampler,
            correct_partitions_pipelined,
            fit_corrector,
            load_corrector,
        )

        corr = None
        if is_primary():
            # assembled whenever the .geno is missing, not only after this
            # run's merge: a run that died between merge_done and the
            # assembly resumes without a merge
            geno = os.path.join(pop_dir, "gwas_eigenstratX.geno")
            if redo_merge or not os.path.exists(geno):
                GenoSampler.assemble_parts(pop_dir, config.nb_partitions,
                                           opt.nb_controls + opt.nb_cases)
            corr = fit_corrector(opt, config, pop_dir, device, timings)
        barrier("pop_null_ready")
        if corr is None:
            corr = load_corrector(opt, config, pop_dir, device)
        t0 = Timer()
        correct_partitions_pipelined(
            corr, [(spill(p, "uncorrected", read=True),
                    spill(p, "popstrat_uncorrected", read=False))
                   for p in owned])
        if timings is not None:
            timings["alt_fits"] = t0.elapsed()
        logger.info("process %d: popstrat corrected partitions %s.", pid, owned)
        barrier("popstrat_done")

    if not is_primary():
        logger.info("process %d done in %s.", pid, whole.formatted())
        return {"total_kmers": opt.total_kmers, "control": 0, "case": 0,
                "primary": False}

    name = "popstrat_uncorrected" if opt.pop_correction else "uncorrected"
    accumulators = [spill(p, name, read=True)
                    for p in range(config.nb_partitions)]
    counts = (0, 0)
    if not prev_out or action > 0 or redo_merge or redo_pop:
        counts = do_correction(opt, config, accumulators, opt.total_kmers)
    for acc in accumulators:
        acc.destroy()
    if not opt.keep_tmp:
        for p in range(config.nb_partitions):
            for name in ("uncorrected", "popstrat_uncorrected"):
                path = os.path.join(part_dir, f"p{p}_{name}")
                if os.path.exists(path):
                    os.remove(path)
    logger.info("Done in %s, Peak RSS -> %d MB.", whole.formatted(),
                get_peak_rss_mb())
    return {"total_kmers": opt.total_kmers, "control": counts[0],
            "case": counts[1], "primary": True}
