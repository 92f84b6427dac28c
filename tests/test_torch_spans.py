"""The port's spans (kmdiff_tpu_torch/profiling.py) in a command's timings,
on the CPU.

- `run` (the fused path), `diff` and `diff --model` (the numpy plugin)
  given timings: each span of the paths they take adds its thread-seconds
  under `<name>_thread_s`, and the outputs are byte-identical to the same
  command's without timings; `run` also tallies its six files as decoded,
  none by the record parser;
- the sample threads' parse, copy and count spans fit in `--threads` times
  the count's wall; a partition's stages fit in its `kmd:partition` span;
- the collector is one dict that every thread adds to under a lock: no
  update is lost with more threads than cores;
- kernel and shard ranges (`timed=False`) stay trace-only;
- a collector inside another restores the outer one.

The cohort is tests/test_torch_profile.py's: popsim's 3 + 3 samples of a
20 kbp genome, seed 5.
"""

import pathlib
import sys
import threading

import pytest
import torch

from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch import cli, profiling
from kmdiff_tpu_torch.cmd import diff as tdiff
from kmdiff_tpu_torch.cmd import run as trun

OUTPUTS = ("control_kmers.fasta", "case_kmers.fasta", "options.json")
LOOSE = ["-1", "3", "-2", "3", "-s", "0.5", "--cutoff", "1", "-c", "disabled",
         "--threads", "2"]
RUN_SPANS = {"parse_thread_s", "h2d_thread_s", "count_thread_s",
             "merge_chunk_thread_s", "device_thread_s"}
#: the fused run's tallies: files decoded, and those the record parser took
RUN_TALLIES = {"parse_files", "parse_fallback_files"}
DIFF_STAGES = {"decode_thread_s", "groupsum_thread_s", "build_thread_s",
               "h2d_thread_s", "device_thread_s"}
#: a custom model's partitions: the host union merge and its scores
MODEL_STAGES = {"decode_thread_s", "union_thread_s", "score_thread_s"}
PLUGIN = (pathlib.Path(__file__).resolve().parents[1] / "kmdiff_tpu_torch"
          / "examples" / "plugins" / "fold_change_model.py")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    assert cli.main(["count", "--file", str(root / "sim" / "fof.txt"), "-k",
                     "31", "--nb-partitions", "4", "--threads", "2",
                     "--run-dir", str(root / "rd")], device="cpu") == 0
    return root


def _command(cohort, command, out, timings):
    if command.startswith("diff"):
        model = (["--model", str(PLUGIN)] if command == "diff_model" else [])
        args = cli.parse_args(["diff", "--km-run-dir", str(cohort / "rd"),
                               "--output-dir", str(out), *LOOSE, *model])
        return tdiff.main_diff(cli.diff_options(args), torch.device("cpu"),
                               timings=timings)
    args = cli.parse_args(["run", "--file", str(cohort / "sim" / "fof.txt"),
                           "-k", "31", "--nb-partitions", "4", "--run-dir",
                           str(out) + "_rd", "--output-dir", str(out), *LOOSE])
    return trun.main_run(cli.count_options(args), cli.diff_options(args),
                         torch.device("cpu"), timings=timings)


@pytest.mark.parametrize("command", ["run", "diff", "diff_model"])
def test_spans_fill_the_timings_and_change_no_output(cohort, tmp_path, command):
    plain = _command(cohort, command, tmp_path / "plain", None)
    timings: dict = {}
    assert _command(cohort, command, tmp_path / "timed", timings) == plain
    for name in OUTPUTS:
        assert ((tmp_path / "timed" / name).read_bytes()
                == (tmp_path / "plain" / name).read_bytes()), name
    assert plain["total_kmers"] > 0
    if command == "run":
        assert set(timings) == {"count", "merge", "total"} | RUN_SPANS | RUN_TALLIES
        assert all(timings[k] > 0 for k in RUN_SPANS)
        assert (timings["parse_files"], timings["parse_fallback_files"]) == (6, 0)
        # the three never overlap on a sample thread, and two sample
        # threads run at once
        count = sum(timings[k] for k in ("parse_thread_s", "h2d_thread_s",
                                         "count_thread_s"))
        assert count <= 2 * timings["count"] + 0.05
        assert timings["device_thread_s"] <= timings["merge_chunk_thread_s"]
    else:
        stages = DIFF_STAGES if command == "diff" else MODEL_STAGES
        assert set(timings) == {"partition_thread_s"} | stages
        assert all(timings[k] > 0 for k in timings)
        assert sum(timings[k] for k in stages) <= timings["partition_thread_s"]
    assert profiling._sink is None


def test_no_update_is_lost_across_threads(monkeypatch):
    """Every span of 32 threads adds exactly one second (a clock that
    reads 0, then 1, on each thread): the sum is the count of spans."""
    local = threading.local()

    def clock():
        local.t = 1.0 - getattr(local, "t", 1.0)
        return local.t

    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    timings: dict = {}
    start = threading.Barrier(32)

    def work():
        start.wait(timeout=30)
        for _ in range(4000):
            with profiling.span("kmd:stress"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.collect(timings):
            threads = [threading.Thread(target=work) for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert timings == {"stress_thread_s": 32 * 4000.0}


def test_trace_only_ranges_and_nested_collectors():
    outer: dict = {}
    inner: dict = {}
    with profiling.collect(outer):
        # a kernel launch's or a shard's range: nothing outside a trace
        with profiling.span("kmd:K-EXT", timed=False) as s:
            assert s is None
        with profiling.collect(inner):
            with profiling.span("kmd:inner"):
                pass
        with profiling.collect(None):
            with profiling.span("kmd:outer"):
                pass
    assert set(inner) == {"inner_thread_s"}
    assert set(outer) == {"outer_thread_s"}
    assert profiling._sink is None
    with profiling.span("kmd:after") as s:
        assert s is None
