"""No process outlives a run: the harness's reaper ends a planted orphan,
and ``python -m kbench`` without a card fails at once, prints no result and
leaves its session empty."""

import os
import subprocess
import sys
import time

from kbench import reaper, run


def _session(sid: int) -> list[int]:
    """Processes of session `sid`, from /proc."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[3]) == sid and fields[0] != "Z":
                out.append(int(d))
    return out


def test_planted_orphan_is_ended():
    reaper.become_subreaper()
    # the shell exits at once; its `sleep` is orphaned and comes to us
    subprocess.run(["sh", "-c", "sleep 600 & exit 0"], check=True, timeout=30)
    deadline = time.monotonic() + 10
    while not reaper.descendants() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert reaper.descendants(), "the orphan did not come to the subreaper"
    found = reaper.end_descendants(grace=1.0)
    assert any("sleep 600" in f for f in found)
    assert reaper.descendants() == []


def test_guard_ends_descendants_on_an_exception():
    reaper.become_subreaper()
    guard = reaper.Guard()
    try:
        with guard:
            subprocess.Popen(["sleep", "600"])
            raise RuntimeError("a job failed")
    except RuntimeError:
        pass
    assert any("sleep 600" in f for f in guard.found)
    assert reaper.descendants() == []


def test_no_card_no_result_no_descendant():
    proc = subprocess.Popen(
        [sys.executable, "-B", "-m", "kbench", "--workload", "ecoli-k31.run",
         "--seed", str(2**31 + 17), "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 2, err
    assert out.strip() == "" and "CUDA card" in err
    assert _session(proc.pid) == []
