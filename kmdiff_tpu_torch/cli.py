"""CLI of the port: ``python -m kmdiff_tpu_torch {count,diff,run} ...``.

The flags are the JAX package's (kmdiff_tpu.cli.build_parser), so a command
line runs unchanged on either package. ``count``, ``diff``, ``run`` and
``popsim`` run on the port; every other command, and every flag of a path
not ported yet, raises NotImplementedError naming its item in ROADMAP.md's
port queue.
"""

from __future__ import annotations

import sys

import torch

from kmdiff_tpu.cli import build_parser
from kmdiff_tpu.core.corrector import correction_type_from_str
from kmdiff_tpu.utils.logging import logger, set_verbosity_level
from kmdiff_tpu_torch.device import resolve_device

_LATER_COMMANDS = {
    "call": "item 8: infos and call",
    "infos": "item 8: infos and call",
}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to kmdiff_tpu_torch yet "
        f"(ROADMAP.md port queue {item})"
    )


def _reject_unported(args) -> None:
    if args.command == "warmup":
        raise NotImplementedError(
            "'warmup' only fills the XLA compile cache; the port compiles "
            "nothing ahead of time (ROADMAP.md: not to port)"
        )
    if args.command in _LATER_COMMANDS:
        raise _unported(f"the {args.command!r} command",
                        _LATER_COMMANDS[args.command])
    if args.devices > 1:
        raise _unported(f"--devices {args.devices}", "item 7: multi-GPU")
    if args.distributed or args.num_processes or args.process_id >= 0:
        raise _unported("--distributed", "item 7: multi-GPU")
    if args.profile:
        raise _unported("--profile", "item 9: the H100 bench and its traces")
    if args.command in ("count", "run") and args.kmer_size > 32:
        raise _unported(f"--kmer-size {args.kmer_size}", "item 2: k > 32")
    if args.command in ("diff", "run") and args.model_lib_path:
        raise _unported("--model", "item 6: plugins")


def count_options(args):
    """The CountOptions of a parsed count or run command line."""
    from kmdiff_tpu.cmd.options import CountOptions

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
    from kmdiff_tpu.cmd.options import DiffOptions

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
    """Parse a command line and refuse what the port has not ported."""
    parser = build_parser()
    parser.prog = "kmdiff-tpu-torch"
    args = parser.parse_args(argv)
    _reject_unported(args)
    return args


def main(argv: list[str] | None = None,
         device: str | torch.device = "cuda") -> int:
    dev = resolve_device(device)
    args = parse_args(argv)
    set_verbosity_level(args.verbose)

    from kmdiff_tpu.utils.signals import init_signal_handlers

    init_signal_handlers()

    if args.command == "popsim":
        # host-only cohort simulator, shared with the JAX package
        from kmdiff_tpu.pipeline.simulate import SimOptions, simulate

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
