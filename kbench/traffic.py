"""The general traffic generator: a mix (``traffic/<mix>.json``) and a
configuration (``configs/<config>.json``) make the jobs of a cell, each run
in this process, as ``python -m kmdiff_tpu_torch <command> ...`` would run
it.

A mix's keys:

  command  the port's command each job runs: ``run`` (count and diff fused,
           kmdiff_tpu_torch.cmd.run.main_run) or ``diff``
           (kmdiff_tpu_torch.cmd.diff.main_diff), both writing the
           significant k-mers that the comparison reads
  flags    further command-line flags of every job
  setup    (optional) the commands run once at set-up, before the warm-up
           job, each ``{"command": "count", "flags": [...]}`` on the cohort;
           their run directory is the one every ``diff`` job reads, and
           holds the histograms the comparison reads
  analysis (optional) popstrat's settings (``ANALYSIS_FLAGS``:
           ``pop_correction``, ``kmer_pca``, ``n_pc``), for example
           ``{"pop_correction": true, "kmer_pca": 0.001, "n_pc": 2}``.
           Each becomes its flag on every command that takes it, after the
           configuration's flags; the harness hands the reference the
           configuration with the same dict added (``overlay``). The
           configuration alone states the rest of the analysis (k,
           hard-min, the correction): a mix cannot restate it. With
           ``pop_correction`` the comparison holds popstrat's p-values
           (kbench.compare).
  about    what the mix is (free text)

Every job gets a fresh output directory, and a ``run`` job a fresh run
directory too. The analysis flags come from the configuration: k,
hard-min, partitions, threads, significance, cutoff and correction, then
the mix's ``analysis``. A job's ``phases`` are whatever seconds the
command hands its ``timings`` (``run``: count, merge, total and the
count's spans; ``diff``: the partitions' spans, ``decode_thread_s`` and
the others, and with popstrat pca, null_fit, alt_fits); the harness passes
them to the metric readers unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
import traceback

import torch

#: what main_run logs when it leaves the fused path for count + diff
FALLBACK_MARK = "fused pipeline unavailable"
#: commands a job may run (each writes the output the comparison reads)
JOB_COMMANDS = ("run", "diff")
SETUP_COMMANDS = ("count",)
#: an ``analysis`` key (popstrat's alone) -> its flag (a switch where the
#: value is a bool) and the commands that take it
ANALYSIS_FLAGS = {
    "pop_correction": ("--pop-correction", ("diff", "run")),
    "kmer_pca": ("--kmer-pca", ("diff", "run")),
    "n_pc": ("--n-pc", ("diff", "run")),
}


@dataclasses.dataclass
class Job:
    wall_s: float
    phases: dict
    result: dict | None
    run_dir: str
    out_dir: str
    fell_back: bool
    error: str = ""
    #: the directories that are this job's alone, deleted once compared
    own: tuple = ()

    def remove(self) -> None:
        for d in self.own:
            shutil.rmtree(d, ignore_errors=True)


class _Marks(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.seen = False

    def emit(self, record):
        if FALLBACK_MARK in record.getMessage():
            self.seen = True


def load(kbench_dir: str, mix: str) -> dict:
    with open(os.path.join(kbench_dir, "traffic", f"{mix}.json")) as f:
        traffic = json.load(f)
    if traffic["command"] not in JOB_COMMANDS:
        raise ValueError(f"traffic {mix}: command {traffic['command']!r}: a job "
                         f"runs one of {JOB_COMMANDS}")
    for step in traffic.get("setup", []):
        if step["command"] not in SETUP_COMMANDS:
            raise ValueError(f"traffic {mix}: set-up command {step['command']!r}")
    unknown = set(traffic.get("analysis", {})) - set(ANALYSIS_FLAGS)
    if unknown:
        raise ValueError(f"traffic {mix}: analysis keys {sorted(unknown)}")
    return traffic


def overlay(config: dict, traffic: dict) -> dict:
    """The configuration as the mix's jobs run it: with its ``analysis``."""
    return {**config, **traffic.get("analysis", {})}


def analysis_flags(analysis: dict, command: str) -> list[str]:
    """The flags of `analysis` (a mix's ``analysis``) that `command` takes."""
    out = []
    for key, value in analysis.items():
        flag, commands = ANALYSIS_FLAGS[key]
        if command not in commands:
            continue
        if isinstance(value, bool):
            out += [flag] if value else []
        else:
            out += [flag, str(value)]
    return out


def argv(config: dict, command: str, flags: list, fof: str, run_dir: str,
         out_dir: str, analysis: dict | None = None) -> list[str]:
    """The command line of one command on the cohort: the configuration's
    flags, then `analysis`'s (a mix's), then the mix's `flags`."""
    count = ["--kmer-size", str(config["kmer_size"]),
             "--hard-min", str(config["hard_min"]),
             "--nb-partitions", str(config["nb_partitions"])]
    diff = ["-1", str(config["nb_controls"]), "-2", str(config["nb_cases"]),
            "--significance", str(config["significance"]),
            "--cutoff", str(config["cutoff"]),
            "--correction", config["correction"]]
    common = ["--threads", str(config["threads"]), "--devices", "1",
              *analysis_flags(analysis or {}, command), *flags]
    if command == "count":
        return ["count", "--file", fof, "--run-dir", run_dir, *count, *common]
    if command == "diff":
        return ["diff", "--km-run-dir", run_dir, "--output-dir", out_dir, *diff, *common]
    return ["run", "--file", fof, "--run-dir", run_dir, "--output-dir", out_dir,
            *count, *diff, *common]


def _call(args, device: torch.device, phases: dict):
    """The port's command for parsed `args`, in this process (the modules'
    functions are looked up when called)."""
    from kmdiff_tpu_torch import cli
    from kmdiff_tpu_torch.cmd import count as count_cmd
    from kmdiff_tpu_torch.cmd import diff as diff_cmd
    from kmdiff_tpu_torch.cmd import run as run_cmd

    if args.command == "count":
        return count_cmd.main_count(cli.count_options(args), device)
    if args.command == "diff":
        return diff_cmd.main_diff(cli.diff_options(args), device, timings=phases)
    return run_cmd.main_run(cli.count_options(args), cli.diff_options(args), device,
                            recurrence_min=args.recurrence_min,
                            count_files=not args.no_count_files, timings=phases)


def _timed(args, device: torch.device):
    """-> (wall_s, phases, result, error, fell_back) of one command, timed
    on the host clock to the card's last operation."""
    from kmdiff_tpu_torch.parallel import runtime
    from kmdiff_tpu_torch.utils.logging import logger

    marks = _Marks()
    logger.addHandler(marks)
    phases: dict = {}
    result, error = None, ""
    t0 = time.perf_counter()
    try:
        result = _call(args, device, phases)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception:  # a command that raises is a failed job, reported
        error = traceback.format_exc(limit=-8)
    finally:
        wall = time.perf_counter() - t0
        logger.removeHandler(marks)
        runtime.configure(None)
    # a `run` that left the fused path logs so, or has no merge phase
    fell_back = marks.seen or (args.command == "run" and not error
                               and "merge" not in phases)
    return wall, phases, result, error, fell_back


def setup(config: dict, traffic: dict, fof: str, work: str,
          device: torch.device) -> str:
    """Run the mix's set-up commands; -> their run directory (where a
    ``diff`` job reads its counts). Raises where one fails."""
    from kmdiff_tpu_torch import cli

    run_dir = os.path.join(work, "setup", "run")
    for step in traffic.get("setup", []):
        args = cli.parse_args(argv(config, step["command"], step.get("flags", []),
                                   fof, run_dir, "", traffic.get("analysis")))
        error = _timed(args, device)[3]
        if error:
            raise RuntimeError(f"set-up command {step['command']} failed:\n{error}")
    return run_dir


def run_job(index: int, config: dict, traffic: dict, fof: str, work: str,
            device: torch.device, setup_run_dir: str = "") -> Job:
    """One job on fresh directories under `work`."""
    from kmdiff_tpu_torch import cli

    base = os.path.join(work, f"job{index}")
    command = traffic["command"]
    run_dir = setup_run_dir if command == "diff" else os.path.join(base, "run")
    out_dir = os.path.join(base, "out")
    args = cli.parse_args(argv(config, command, traffic["flags"], fof, run_dir, out_dir,
                               traffic.get("analysis")))
    wall, phases, result, error, fell_back = _timed(args, device)
    return Job(wall, phases, result, run_dir, out_dir, fell_back, error, own=(base,))
