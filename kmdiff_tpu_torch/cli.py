"""CLI of the port: ``python -m kmdiff_tpu_torch {count,diff,run} ...``.

build_parser has every subcommand, flag, default and dest of the JAX
package's (kmdiff_tpu/cli.py, after the reference's src/cli.cpp:23-369), so
a command line runs unchanged on either package. ``count``, ``diff``, ``run``
(with ``--model`` plugins, over a mesh of shards with ``--devices``, over
several processes with ``--distributed``, and over a mesh in each of
several processes with both), ``popsim``, ``call``, ``infos`` and
``warmup`` run on the port, each under ``--profile DIR`` too (a
torch.profiler trace, kmdiff_tpu_torch.profiling). ``run`` accepts
KMDIFF_GROUP_MERGE=1 and ignores it: the JAX package's group
pre-aggregation changes no output, and the port merges the per-sample
streams.
"""

from __future__ import annotations

import argparse
import sys

import torch

from kmdiff_tpu_torch import __version__
from kmdiff_tpu_torch.core.corrector import correction_type_from_str
from kmdiff_tpu_torch.utils.logging import logger, set_verbosity_level
from kmdiff_tpu_torch.device import resolve_device


def _range_checker(lo, hi, kind=float):
    def check(v):
        x = kind(v)
        if not (lo <= x <= hi):
            raise argparse.ArgumentTypeError(f"Not in range [{lo}, {hi}]")
        return x

    return check


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("-t", "--threads", type=int, default=4, help="number of threads.")
    p.add_argument(
        "--devices", type=int, default=0,
        help="accelerator devices for the mesh runtime "
             "(0 = all available, 1 = single device).",
    )
    p.add_argument(
        "--distributed", metavar="HOST:PORT", default="",
        help="multi-process runtime: coordinator address (every process "
             "runs the same command over a shared filesystem; also "
             "settable via KMDIFF_COORDINATOR).",
    )
    p.add_argument("--num-processes", type=int, default=0,
                   help="process count for --distributed.")
    p.add_argument("--process-id", type=int, default=-1,
                   help="this process's rank for --distributed.")
    p.add_argument(
        "-v",
        "--verbose",
        default="info",
        choices=("debug", "info", "warning", "error"),
        help="verbosity level.",
    )
    p.add_argument(
        "--profile", default="", metavar="DIR",
        help="capture a profiler trace of the run into DIR (a torch.profiler "
        "Chrome trace; one file a rank under --distributed).",
    )


def _add_diff_analysis_flags(p: argparse.ArgumentParser):
    """Shared diff-analysis flags (correction, popstrat, dev) for
    the `diff` and `run` subcommands."""
    p.add_argument(
        "-u", "--cutoff", type=float, default=1e5,
        help="divide the significance threshold by N for the merge pre-filter.",
    )
    p.add_argument(
        "-c", "--correction", default="bonferroni",
        choices=("bonferroni", "benjamini", "sidak", "holm", "disabled"),
        help="significance correction.",
    )
    p.add_argument("-f", "--kff-output", action="store_true",
                    help="output significant k-mers in kff format.")
    p.add_argument("-m", "--in-memory", action="store_true",
                    help="in-memory correction.")
    p.add_argument("-r", "--cpr", action="store_true",
                    help="compress intermediate files (accepted for "
                         "reference-script compatibility; spills are always "
                         "LZ4-compressed here, as the reference's are — its "
                         "--cpr flag is parsed but never consumed, "
                         "diff_opt.hpp:16).")
    p.add_argument("--keep-tmp", action="store_true", help="keep tmp files.")
    p.add_argument("--save-sk", action="store_true",
                    help="build the matrix of significant k-mers.")
    # custom model
    p.add_argument("--model", "--cmodel", default="", dest="model_lib_path",
                    help="custom model plugin (py file or module[:factory]; "
                         "--cmodel is the reference's spelling, cli.cpp:261).")
    p.add_argument("--model-config", "--config", default="",
                    dest="model_config",
                    help="model configuration string (--config is the "
                         "reference's spelling, cli.cpp:267).")
    # population stratification
    p.add_argument("--pop-correction", action="store_true",
                    help="apply population stratification correction.")
    p.add_argument(
        "--kmer-pca", type=_range_checker(0.0, 0.05), default=0.001,
        help="proportion of k-mers used for PCA (in [0.0, 0.05]).",
    )
    p.add_argument("--ploidy", type=int, default=2, help="ploidy level.")
    p.add_argument(
        "--n-pc", type=_range_checker(2, 10, int), default=2,
        help="number of principal components (in [2, 10]).",
    )
    p.add_argument("--covariates", default="", help="covariates file.")
    p.add_argument("--gender", default="", help="gender file.")
    p.add_argument(
        "--compat-popstrat", action="store_true",
        help="replicate the reference pop_strat_corrector verbatim "
             "(forced standardize incl. its row-index-stddev bug, "
             "reference glm_irls, raw likelihood products with the "
             "0.001/1.0 underflow fallback) for A/B against reference "
             "kmdiff outputs; slower (host per-k-mer fits) and "
             "statistically worse than the default batched path.",
    )
    # dev flags (reference: hidden params, src/cli.cpp:300-357)
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--max-iteration", type=int, default=None)
    p.add_argument("--epsilon", type=float, default=None)
    p.add_argument("--stand", action="store_true")
    p.add_argument("--irls", action="store_true", default=True)
    p.add_argument("--random-seed", type=int, default=0)
    p.add_argument("--log-factorial", type=int, default=10000,
                    help="size of precomputed log-factorial table.")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kmdiff-tpu-torch",
        description="differential k-mer analysis (controls vs cases "
        "populations) on PyTorch and CUDA.",
    )
    ap.add_argument("--version", action="version",
                    version=f"kmdiff-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="command", required=True)

    # ---- count (reference: src/cli.cpp count_cli + src/cmd.cpp:27-48) ------
    cp = sub.add_parser("count", help="count k-mers on the device.")
    cp.add_argument("-f", "--file", required=True, help="fof that contains samples.")
    cp.add_argument("-d", "--run-dir", required=True, help="output directory.")
    cp.add_argument(
        "-k", "--kmer-size", type=_range_checker(8, 128, int), default=31,
        help="size of k-mers, in [8, 128].",
    )
    cp.add_argument(
        "-c", "--hard-min", type=int, default=1, help="min abundance to keep a k-mer."
    )
    cp.add_argument(
        "-r", "--recurrence-min", type=int, default=1,
        help="min number of samples to keep a k-mer.",
    )
    cp.add_argument(
        "-m", "--minimizer-type", type=int, default=0,
        help="minimizer type, 0=lexi, 1=freq.",
    )
    cp.add_argument(
        "-s", "--minimizer-size", type=int, default=10, help="minimizer size."
    )
    cp.add_argument(
        "--repartition-type", type=_range_checker(0, 1, int), default=0,
        help="minimizer repartition, 0=unordered, 1=ordered (accepted for "
             "reference-script compatibility; the hash repartition here is "
             "order-free either way).",
    )
    cp.add_argument(
        "-p", "--nb-partitions", type=int, default=0,
        help="number of partitions (0 = auto).",
    )
    _add_common(cp)

    # ---- diff (reference: src/cli.cpp diff_cli) ------------------------------
    dp = sub.add_parser("diff", help="differential k-mer analysis.")
    dp.add_argument(
        "-d", "--km-run-dir", "--km-run", required=True, dest="km_run_dir",
        help="kmtricks run directory (or kmdiff-tpu count output).",
    )
    dp.add_argument("-o", "--output-dir", default="./kmdiff_output")
    dp.add_argument("-1", "--nb-controls", type=int, required=True,
                    help="number of controls.")
    dp.add_argument("-2", "--nb-cases", type=int, required=True,
                    help="number of cases.")
    dp.add_argument(
        "-s", "--significance", type=_range_checker(0.0, 0.5), default=0.05,
        help="significance threshold.",
    )
    _add_diff_analysis_flags(dp)
    _add_common(dp)
    # ---- run (single-shot: count + diff fused in one process;
    # no reference equivalent — the reference flow is file-mediated by
    # construction, src/cmd.cpp:27-48 + diff.hpp:262-377) -------------------
    rp = sub.add_parser(
        "run",
        help="FASTA -> significant k-mers in one process (fused "
             "count+diff: count streams stay on device; falls back to "
             "the standard two-stage flow when ineligible).",
    )
    rp.add_argument("--file", required=True, help="fof that contains samples.")
    rp.add_argument("-d", "--run-dir", required=True,
                    help="count run directory (created).")
    rp.add_argument(
        "-k", "--kmer-size", type=_range_checker(8, 128, int), default=31,
        help="size of k-mers, in [8, 128].",
    )
    rp.add_argument("--hard-min", type=int, default=1,
                    help="min abundance to keep a k-mer.")
    rp.add_argument("--recurrence-min", type=int, default=1,
                    help="min number of samples to keep a k-mer.")
    rp.add_argument("--minimizer-type", type=int, default=0)
    rp.add_argument("--minimizer-size", type=int, default=10)
    rp.add_argument("--repartition-type", type=_range_checker(0, 1, int),
                    default=0)
    rp.add_argument("--nb-partitions", type=int, default=0,
                    help="number of partitions (0 = auto).")
    rp.add_argument(
        "--no-count-files", action="store_true",
        help="skip writing the per-partition count files (the run dir "
             "keeps fof/config/histograms; count-stage resume becomes "
             "unavailable, later stages still resume from spills).",
    )
    rp.add_argument("-o", "--output-dir", default="./kmdiff_output")
    rp.add_argument("-1", "--nb-controls", type=int, required=True,
                    help="number of controls.")
    rp.add_argument("-2", "--nb-cases", type=int, required=True,
                    help="number of cases.")
    rp.add_argument(
        "-s", "--significance", type=_range_checker(0.0, 0.5), default=0.05,
        help="significance threshold.",
    )
    _add_diff_analysis_flags(rp)
    _add_common(rp)

    # ---- popsim (working implementation of the reference's vestigial
    # cohort simulator, include/kmdiff/cmd/popsim.hpp) -----------------------
    sp = sub.add_parser("popsim", help="simulate a controls/cases cohort "
                        "with planted variants + ground truth.")
    sp.add_argument("-o", "--output-dir", default="./popsim_out")
    sp.add_argument("-r", "--reference", default="",
                    help="reference FASTA (synthesized when omitted).")
    sp.add_argument("--genome-len", type=int, default=100_000)
    sp.add_argument("-1", "--nb-controls", type=int, default=5)
    sp.add_argument("-2", "--nb-cases", type=int, default=5)
    sp.add_argument("--mean-sv-len", type=int, default=500)
    sp.add_argument("--sd-sv-len", type=int, default=50)
    sp.add_argument("--nb-sv-controls", type=int, default=5)
    sp.add_argument("--nb-sv-cases", type=int, default=5)
    sp.add_argument("--prob-case", type=float, default=0.1)
    sp.add_argument("--prob-control", type=float, default=0.1)
    sp.add_argument("--sv-per-indiv", type=float, default=0.8)
    sp.add_argument("--read-size", type=int, default=100)
    sp.add_argument("--coverage", type=int, default=10)
    sp.add_argument("--error-rate", type=float, default=0.001)
    sp.add_argument("--random-seed", type=int, default=42)
    _add_common(sp)

    # ---- call (working implementation of the reference's disabled
    # command, include/kmdiff/cmd/call.hpp) ----------------------------------
    lp = sub.add_parser("call", help="map significant k-mers back to a "
                        "reference genome (exact match, TSV out).")
    lp.add_argument("-i", "--kmer-file", required=True,
                    help="significant k-mers (fasta or kff).")
    lp.add_argument("-r", "--reference", required=True,
                    help="reference genome FASTA.")
    lp.add_argument("-o", "--output", default="calls.tsv")
    lp.add_argument("-k", "--kmer-size", type=int, default=0,
                    help="k (inferred from queries when 0).")
    _add_common(lp)

    # ---- warmup --------------------------------------------------------------
    wp = sub.add_parser("warmup", help="build the kernels and the native "
                        "library and launch every kernel once for a cohort "
                        "config.")
    wp.add_argument("-1", "--nb-controls", type=int, required=True)
    wp.add_argument("-2", "--nb-cases", type=int, required=True)
    wp.add_argument("-k", "--kmer-size", type=int, default=31)
    wp.add_argument("--pop", action="store_true",
                    help="also compile the popstrat IRLS kernels.")
    wp.add_argument("--n-pc", type=int, default=2)
    _add_common(wp)

    # ---- infos ---------------------------------------------------------------
    ip = sub.add_parser("infos", help="build/runtime infos.")
    _add_common(ip)

    return ap


def count_options(args):
    """The CountOptions of a parsed count or run command line."""
    from kmdiff_tpu_torch.cmd.options import CountOptions

    return CountOptions(
        fof=args.file,
        directory=args.run_dir,
        kmer_size=args.kmer_size,
        hard_min=args.hard_min,
        minimizer_type=args.minimizer_type,
        minimizer_size=args.minimizer_size,
        repartition_type=args.repartition_type,
        nb_partitions=args.nb_partitions,
        nb_threads=args.threads,
        n_devices=args.devices,
    )


def diff_options(args):
    """The DiffOptions of a parsed diff or run command line."""
    from kmdiff_tpu_torch.cmd.options import DiffOptions

    return DiffOptions(
        kmtricks_dir=args.km_run_dir if args.command == "diff" else args.run_dir,
        output_directory=args.output_dir,
        nb_controls=args.nb_controls,
        nb_cases=args.nb_cases,
        threshold=args.significance,
        cutoff=args.cutoff,
        correction=correction_type_from_str(args.correction),
        in_memory=args.in_memory,
        kff=args.kff_output,
        pop_correction=args.pop_correction,
        compat_popstrat=args.compat_popstrat,
        kmer_pca=args.kmer_pca,
        ploidy=args.ploidy,
        is_diploid=args.ploidy == 2,
        npc=args.n_pc,
        covariates=args.covariates,
        gender=args.gender,
        learning_rate=args.learning_rate,
        max_iteration=args.max_iteration,
        epsilon=args.epsilon,
        stand=args.stand,
        irls=args.irls,
        keep_tmp=args.keep_tmp,
        seed=args.random_seed,
        log_size=args.log_factorial,
        save_sk=args.save_sk,
        nb_threads=args.threads,
        model_lib_path=args.model_lib_path,
        model_config=args.model_config,
        n_devices=args.devices,
    )


def parse_args(argv: list[str] | None = None):
    """Parse a command line."""
    return build_parser().parse_args(argv)


def main(argv: list[str] | None = None,
         device: str | torch.device = "cuda") -> int:
    dev = resolve_device(device)
    args = parse_args(argv)
    set_verbosity_level(args.verbose)

    from kmdiff_tpu_torch.utils.signals import init_signal_handlers

    init_signal_handlers()
    from kmdiff_tpu_torch import profiling

    if args.command not in ("count", "diff", "run"):
        with profiling.trace(args.profile, dev):
            return _dispatch(args, dev)

    from kmdiff_tpu_torch.parallel import distributed, runtime

    # --distributed, or KMDIFF_COORDINATOR and friends: every rank runs
    # this command on its own cards (parallel.distributed), a mesh of them
    # with --devices N
    on = distributed.init_distributed(
        coordinator=args.distributed or None,
        num_processes=args.num_processes or None,
        process_id=args.process_id if args.process_id >= 0 else None,
    )
    try:
        rank_dev = distributed.rank_device(dev, args.devices)
        worker = f"rank{distributed.rank()}" if on else "process"
        with profiling.trace(args.profile, rank_dev, worker):
            rc = _dispatch(args, rank_dev)
        # every rank leaves the command together: no rank starts a next
        # command while the primary still writes this one's output
        distributed.barrier("command_done")
        return rc
    finally:
        distributed.shutdown()
        # the command's --devices lives for the command, as its group does
        runtime.configure(None)


def _dispatch(args, dev: torch.device) -> int:
    if args.command == "warmup":
        from kmdiff_tpu_torch.cmd.warmup import main_warmup

        main_warmup(args.nb_controls, args.nb_cases, args.kmer_size, dev,
                    pop=args.pop, npc=args.n_pc)
        return 0

    if args.command == "infos":
        from kmdiff_tpu_torch.cmd.infos import main_infos

        print(main_infos(dev))
        return 0

    if args.command == "call":
        # host-only: exact matches of the k-mers in a reference FASTA
        from kmdiff_tpu_torch.pipeline.call import CallOptions, main_call

        main_call(CallOptions(
            kmer_file=args.kmer_file,
            reference=args.reference,
            output=args.output,
            kmer_size=args.kmer_size,
        ))
        return 0

    if args.command == "popsim":
        # host-only cohort simulator, shared with the JAX package
        from kmdiff_tpu_torch.pipeline.simulate import SimOptions, simulate

        simulate(SimOptions(
            output_directory=args.output_dir,
            reference=args.reference,
            genome_len=args.genome_len,
            nb_controls=args.nb_controls,
            nb_cases=args.nb_cases,
            mean_sv_len=args.mean_sv_len,
            sd_sv_len=args.sd_sv_len,
            nb_sv_controls=args.nb_sv_controls,
            nb_sv_cases=args.nb_sv_cases,
            prob_case=args.prob_case,
            prob_control=args.prob_control,
            sv_per_indiv=args.sv_per_indiv,
            read_size=args.read_size,
            coverage=args.coverage,
            error_rate=args.error_rate,
            seed=args.random_seed,
        ))
        return 0

    if args.command == "count":
        from kmdiff_tpu_torch.cmd.count import main_count

        main_count(count_options(args), dev)
        return 0

    # reference parity warnings (src/cli.cpp:226-243)
    if args.correction in ("benjamini", "holm"):
        logger.warning(
            "-c/--correction %s: all significant k-mers will live in memory.",
            args.correction,
        )
    if args.in_memory:
        logger.warning(
            "-m/--in-memory: all significant k-mers will live in memory."
        )
    if args.command == "diff":
        from kmdiff_tpu_torch.cmd.diff import main_diff

        main_diff(diff_options(args), dev)
        return 0

    from kmdiff_tpu_torch.cmd.run import main_run

    main_run(count_options(args), diff_options(args), dev,
             recurrence_min=args.recurrence_min,
             count_files=not args.no_count_files)
    return 0


if __name__ == "__main__":
    sys.exit(main())
