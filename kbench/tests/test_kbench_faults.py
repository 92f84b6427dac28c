"""A run with the timed path broken underneath comes out not correct, once
for each fault a `run` job can have on one chip (no exchange between chips
exists here); a sound run is correct and writes only under its TMPDIR."""

import os
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from kbench import reaper, run
from kbench.tests.helpers import tiny_config, tiny_run


def _tree(root: str) -> dict:
    """Every file of the checkout outside build/ and bytecode caches, with
    its size and modification time."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("build", "__pycache__", ".git",
                                                 ".pytest_cache")]
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def test_sound_run_is_correct_and_writes_only_under_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = _tree(run.ROOT)
    res = tiny_run(seed=2**31 + 99, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert {"job_s", "setup_s"} <= set(res["metrics"])
    assert _tree(run.ROOT) == before
    # the run's own directory is gone; torch's profiler may leave its cache
    # directory (torchinductor_<user>) there, as TMPDIR allows
    assert not [d for d in os.listdir(tmp_path) if d.startswith("kbench-")]


def _alter_p(monkeypatch):
    from kmdiff_tpu_torch.core.model import PoissonLikelihood

    orig = PoissonLikelihood.process_sums

    def process_sums(self, s_c, s_k):
        p, sg, mc, mk = orig(self, s_c, s_k)
        return p * (1 + 1e-4), sg, mc, mk
    monkeypatch.setattr(PoissonLikelihood, "process_sums", process_sums)


def _drop_one_kmer(monkeypatch):
    from kmdiff_tpu_torch.pipeline import aggregate

    orig = aggregate._OutputPair.write_block

    def write_block(self, block):
        return orig(self, block.take(np.arange(1, len(block))) if len(block) else block)
    monkeypatch.setattr(aggregate._OutputPair, "write_block", write_block)


def _half_the_samples(monkeypatch):
    """The merge reads half of the samples; the rest count as empty."""
    from kmdiff_tpu_torch.pipeline import fused

    orig = fused.fused_merge

    def fused_merge(processor, accumulators, streams, *args):
        for st in streams[len(streams) // 2:]:
            st.counts = torch.zeros_like(st.counts)
        return orig(processor, accumulators, streams, *args)
    monkeypatch.setattr(fused, "fused_merge", fused_merge)


def _state_unchanged(monkeypatch):
    """A job that returns without writing anything."""
    from kmdiff_tpu_torch.cmd import run as run_cmd

    monkeypatch.setattr(run_cmd, "main_run", lambda *a, **k: (
        k["timings"].update(count=0.0, merge=0.0, total=0.0)
        or {"total_kmers": 0, "control": 0, "case": 0}))


def _fall_back(monkeypatch):
    from kmdiff_tpu_torch.cmd import run as run_cmd
    from kmdiff_tpu_torch.pipeline.fused import FusedFallback

    def fused(*_a, **_k):
        raise FusedFallback("planted")
    monkeypatch.setattr(run_cmd, "_main_run_fused", fused)


def _orphan(monkeypatch):
    """A job that leaves a process running (the subreaper is the test's)."""
    from kmdiff_tpu_torch.cmd import run as run_cmd

    reaper.become_subreaper()
    orig = run_cmd.main_run

    def main_run(*a, **k):
        subprocess.run(["sh", "-c", "sleep 600 & exit 0"], check=True)
        return orig(*a, **k)
    monkeypatch.setattr(run_cmd, "main_run", main_run)


FAULTS = {"p_altered": (_alter_p, "pval_off"),
          "kmer_dropped": (_drop_one_kmer, "missing"),
          "half_the_samples": (_half_the_samples, "missing"),
          "state_unchanged": (_state_unchanged, "hist_off"),
          "fell_back": (_fall_back, "jobs_failed")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, fault):
    plant, check = FAULTS[fault]
    plant(monkeypatch)
    res = tiny_run(seed=31 + len(fault))
    assert not res["correct"]
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]


def test_leftover_process_is_not_correct(monkeypatch):
    _orphan(monkeypatch)
    res = run.run_cell(run.load_bench(), "ecoli-k31.run", 5, 0.5, False,
                       torch.device("cpu"), config=tiny_config())
    found = reaper.end_descendants(grace=1.0)
    run.finish(res, found)
    assert found and not res["correct"]
    assert res["checks"]["procs_left"]["value"] == len(found)
    assert reaper.descendants() == []
