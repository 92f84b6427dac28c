"""`--profile DIR` (kmdiff_tpu_torch/profiling.py): a torch.profiler Chrome
trace of one command, on the CPU.

- `diff` and `run` with and without --profile: outputs byte-identical, one
  trace a command that parses as JSON;
- at --devices 2, the mesh's shard threads reach the trace: a `kmd:shard<d>`
  range on a thread other than the command's, with aten ops inside it
  (profile_all_threads);
- two --distributed ranks write two files, rank0.* and rank1.*;
- `infos --profile` writes a trace (the JAX CLI traces every command);
- without a trace the launch path's switch is off.

The cohort is tests/test_torch_mesh.py's: popsim's 3 + 3 samples of a
20 kbp genome, seed 5.
"""

import json
import os
import pathlib
import threading

import pytest

from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch import profiling
from kmdiff_tpu_torch.cli import main as torch_main
from test_torch_distributed import run_cli_ranks

FASTA = ("control_kmers.fasta", "case_kmers.fasta")
LOOSE = ["-1", "3", "-2", "3", "-s", "0.5", "--cutoff", "1", "-c", "disabled",
         "--threads", "2"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    assert torch_main(["count", "--file", str(root / "sim" / "fof.txt"), "-k",
                       "31", "--nb-partitions", "4", "--threads", "2",
                       "--run-dir", str(root / "rd")], device="cpu") == 0
    return root


def _traces(directory: pathlib.Path) -> list[pathlib.Path]:
    return sorted(directory.glob("*.pt.trace.json"))


def _events(path: pathlib.Path) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def _command(cohort, command, out, extra=()):
    if command == "diff":
        argv = ["diff", "--km-run-dir", str(cohort / "rd")]
    else:
        argv = ["run", "--file", str(cohort / "sim" / "fof.txt"), "-k", "31",
                "--nb-partitions", "4", "--run-dir", str(out) + "_rd"]
    return [*argv, *LOOSE, "--output-dir", str(out), *extra]


@pytest.mark.parametrize("devices", ["1", "2"])
@pytest.mark.parametrize("command", ["diff", "run"])
def test_profile_keeps_outputs_and_writes_a_trace(cohort, tmp_path, command,
                                                  devices):
    flags = ["--devices", devices]
    assert torch_main(_command(cohort, command, tmp_path / "plain", flags),
                      device="cpu") == 0
    prof = tmp_path / "prof"
    assert torch_main(_command(cohort, command, tmp_path / "traced",
                               [*flags, "--profile", str(prof)]),
                      device="cpu") == 0
    assert not profiling.active
    for name in (*FASTA, "options.json"):
        assert ((tmp_path / "traced" / name).read_bytes()
                == (tmp_path / "plain" / name).read_bytes()), name
    assert any((tmp_path / "plain" / n).read_bytes() for n in FASTA)
    traces = _traces(prof)
    assert [t.name.split(".")[0] for t in traces] == ["process"]
    events = _events(traces[0])
    names = {e["name"] for e in events}
    assert any(n.startswith("aten::") for n in names)
    shards = [e for e in events if e["name"].startswith("kmd:shard")]
    if devices == "1":
        # one shard: its work runs on the calling thread
        assert {e["name"] for e in shards} <= {"kmd:shard0"}
        return
    # a shard thread's ops: aten ops inside a kmd:shard range of a thread
    # that is not the command's own
    main_tid = threading.main_thread().native_id
    assert {e["name"] for e in shards} == {"kmd:shard0", "kmd:shard1"}
    inside = [e for s in shards if s["tid"] != main_tid for e in events
              if e["tid"] == s["tid"] and e["name"].startswith("aten::")
              and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
    assert inside


def test_two_ranks_write_a_trace_each(cohort, tmp_path):
    prof = tmp_path / "prof"
    run_cli_ranks([_command(cohort, "diff", tmp_path / "out",
                            ["--profile", str(prof)])], tmp_path / "logs")
    traces = _traces(prof)
    assert sorted(t.name.split(".")[0] for t in traces) == ["rank0", "rank1"]
    for t in traces:
        assert any(e["name"].startswith("aten::") for e in _events(t))
    assert torch_main(_command(cohort, "diff", tmp_path / "plain"),
                      device="cpu") == 0
    for name in FASTA:
        assert ((tmp_path / "out" / name).read_bytes()
                == (tmp_path / "plain" / name).read_bytes()), name


def test_infos_writes_a_trace(tmp_path, capsys):
    assert torch_main(["infos", "--profile", str(tmp_path / "prof")],
                      device="cpu") == 0
    assert "kmdiff-tpu-torch " in capsys.readouterr().out
    (trace,) = _traces(tmp_path / "prof")
    with open(trace) as f:
        assert "traceEvents" in json.load(f)


def test_span_is_a_null_context_without_a_trace():
    assert not profiling.active
    with profiling.span("kmd:nothing") as s:
        assert s is None
    with profiling.trace("", None):
        assert not profiling.active


def test_no_trace_leaves_no_directory(cohort, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert torch_main(_command(cohort, "diff", tmp_path / "out"),
                      device="cpu") == 0
    assert sorted(os.listdir(tmp_path)) == ["out"]


# -- the readers of a trace: chip_smoke.py's check_trace, tools/trace_walls.py

def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "X", **e} for e in events]}, f)
    return str(path)


SHARD = [{"name": "kmd:shard1", "tid": 5, "ts": 100, "dur": 50},
         {"name": "aten::add", "tid": 5, "ts": 110, "dur": 5}]


def test_check_trace_holds_ranges_activity_and_shard_ops(tmp_path):
    smoke = _smoke()
    syms = smoke.kernel_symbols()
    assert "lrt_pairs_kernel" in syms["lrt_filter"]
    assert "run_encode_mw_kernel" in syms["run_bounds"]
    good = [{"name": "kmd:lrt_filter", "tid": 1, "ts": 0, "dur": 3},
            {"name": "void lrt_pairs_kernel<true>(float const*)", "cat": "kernel",
             "tid": 7, "ts": 2, "dur": 1}, *SHARD]
    launches = {"lrt_filter": 2, "compact": 0}
    assert "1 CUDA kernels" in smoke.check_trace(
        _write_trace(tmp_path / "a.json", good), launches)
    for drop, what in ((0, "no kmd:lrt_filter range"), (1, "no CUDA activity"),
                       (3, "no aten op")):
        bad = [e for i, e in enumerate(good) if i != drop]
        with pytest.raises(AssertionError, match=what):
            smoke.check_trace(_write_trace(tmp_path / f"b{drop}.json", bad),
                              launches)


def test_trace_walls_busy_unions_device_intervals(tmp_path):
    from kmdiff_tpu_torch.tools.trace_walls import _warmup_log, busy

    events = [{"name": "aten::mm", "tid": 1, "ts": 0, "dur": 1000},
              {"name": "ours_kernel", "cat": "kernel", "tid": 7, "ts": 100, "dur": 200},
              {"name": "other_kernel", "cat": "kernel", "tid": 7, "ts": 250, "dur": 100},
              {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "tid": 8, "ts": 600,
               "dur": 100}]
    got = busy(_write_trace(tmp_path / "t.json", events), ["ours_kernel"])
    # [100, 350) and [600, 700): 350 us of a 1,000 us span
    assert got == {"busy_ms": 0.35, "span_s": 0.001, "busy_share": 0.35,
                   "kernel_ms": 0.3, "port_kernel_share": 0.6667}
    log = ("[2026-10-17 21:26:44.170] [INFO] Warmup on cuda:0 for S=6, k=31: "
           "kernel library 29.5 s, native library 0.0 s to build (0 when built).\n"
           "[2026-10-17 21:26:44.964] [INFO]   count: 0.793 s\n"
           "[2026-10-17 21:26:45.013] [INFO]   run chunk: 0.049 s\n")
    assert _warmup_log(log) == {"build_kernels_s": 29.5, "build_native_s": 0.0,
                                "count": 0.793, "run chunk": 0.049}
