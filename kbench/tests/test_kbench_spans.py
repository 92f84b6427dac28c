"""The port's spans reach the metric readers: ecoli-k31.diff's mix from its
data file reports diff's partition spans, a run cell reports the count's,
and the trace reduction names a gap by the spans open on every thread."""

import json

import pytest
import torch

from kbench import run, trace, traffic
from kbench.tests.helpers import tiny_config, tiny_run


def test_the_diff_cell_reports_the_partition_spans():
    """ecoli-k31.diff's mix, kbench/traffic/diff.json, whose set-up counts
    the cohort once: every job reads that run directory, the comparison
    holds its outputs, and a traced run reports diff's partition spans."""
    mix = traffic.load(run.KBENCH, "diff")
    assert (mix["command"], mix["flags"]) == ("diff", [])
    assert mix["setup"] == [{"command": "count", "flags": []}]
    res = run.run_cell(run.load_bench(), "ecoli-k31.diff", 2**31 + 11, 0.5, True,
                       torch.device("cpu"), config=tiny_config())
    run.finish(res, [])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    # the diff jobs' partition spans; a diff job has no fused count or merge
    # phase, and the run cells' metrics are not read here
    diff = {"diff_decode_thread_s", "diff_groupsum_thread_s", "diff_build_thread_s",
            "diff_device_thread_s"}
    assert set(res["metrics"]) == diff
    assert all(res["metrics"][m]["value"] > 0 for m in diff)


def test_a_traced_run_reports_the_count_spans():
    res = tiny_run(seed=2**31 + 5, trace=True)
    assert res["correct"], res["checks"]
    for m in ("count_parse_thread_s", "count_h2d_thread_s", "count_device_thread_s"):
        assert res["metrics"][m]["value"] > 0, m
    # the sample threads' spans fit in their walls: at most --threads of
    # them at once through the count
    spans = sum(res["metrics"][m]["value"] for m in
                ("count_parse_thread_s", "count_h2d_thread_s", "count_device_thread_s"))
    assert spans <= tiny_config()["threads"] * res["metrics"]["run_count_s"]["value"] * 1.05


@pytest.mark.parametrize("second", ["kmd:h2d", None])
def test_an_idle_gap_is_named_by_every_threads_span(tmp_path, second):
    """A gap in a sample thread's parse while another copies its codes
    carries both spans' names; with the copy gone, the parse's alone."""
    ev = [
        {"ph": "X", "name": trace.JOB_RANGE, "cat": "user_annotation", "ts": 0,
         "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "name": "kmd:parse", "cat": "user_annotation", "ts": 10, "dur": 80,
         "pid": 1, "tid": 2},
        {"ph": "X", "name": "Memcpy HtoD (Pageable -> Device)", "cat": "gpu_memcpy",
         "ts": 0, "dur": 20, "pid": 0, "tid": 7},
    ]
    if second:
        ev.append({"ph": "X", "name": second, "cat": "user_annotation", "ts": 30,
                   "dur": 50, "pid": 1, "tid": 3})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    # one gap, 20-100, its middle at 60
    assert trace.reduce(str(path))["idle_gaps"] == [
        ["kmd:h2d+kmd:parse" if second else "kmd:parse", 8e-5]]
