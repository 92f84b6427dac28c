"""The general generator runs a mix of another command from its data file
alone, and the trace reduction names the card's idle gaps by what the host
had open."""

import json

import torch

from kbench import run, trace, traffic
from kbench.tests.helpers import tiny_config


def test_a_diff_mix_runs_from_data_alone(tmp_path, monkeypatch):
    """A `diff` mix whose set-up counts the cohort once: every job reads
    that run directory, and the comparison holds its outputs."""
    mix = {"about": "diff jobs on count files written at set-up", "command": "diff",
           "flags": [], "setup": [{"command": "count", "flags": []}]}
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "diff.json").write_text(json.dumps(mix))
    assert traffic.load(str(tmp_path), "diff") == mix
    monkeypatch.setattr(traffic, "load", lambda _dir, _name: mix)
    bench = run.load_bench()
    bench["workloads"] = [dict(bench["workloads"][0], name="ecoli-k31.diff",
                               traffic="diff")]
    res = run.run_cell(bench, "ecoli-k31.diff", 11, 0.5, True, torch.device("cpu"),
                       config=tiny_config())
    run.finish(res, [])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    # a diff job has no fused count or merge phase: their readers stay silent
    assert not {"run_count_s", "run_merge_s"} & set(res["metrics"])


def test_idle_gaps_are_named_by_the_host_ranges_open(tmp_path):
    ev = [
        {"ph": "X", "name": trace.JOB_RANGE, "cat": "user_annotation", "ts": 0,
         "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "name": "kmd:K-EXT", "cat": "user_annotation", "ts": 5, "dur": 10,
         "pid": 1, "tid": 2},
        {"ph": "X", "name": "aten::copy_", "cat": "cpu_op", "ts": 40, "dur": 30,
         "pid": 1, "tid": 3},
        {"ph": "X", "name": "canonical_kmers_kernel<31>(...)", "cat": "kernel",
         "ts": 12, "dur": 4, "pid": 0, "tid": 7},
        {"ph": "X", "name": "Memcpy HtoD (Pageable -> Device)", "cat": "gpu_memcpy",
         "ts": 75, "dur": 5, "pid": 0, "tid": 7},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.reduce(str(path))
    assert tr["busy_s"] == 9e-6 and tr["span_s"] == 1e-4
    assert tr["kernel_s"] == {"K-EXT": 4e-6}
    # gaps 16-75 (middle in aten::copy_), 80-100 (nothing open but the
    # job: the host's own code) and 0-12 (middle in the port's range)
    assert [g[0] for g in tr["idle_gaps"]] == ["aten::copy_", "host", "kmd:K-EXT"]
