"""The port's multi-process runtime (kmdiff_tpu_torch/parallel/distributed.py)
on the CPU: two-rank gloo groups of spawned `python -c` workers, each
calling kmdiff_tpu_torch.cli.main(argv, device="cpu"), held against the JAX
package's single-process runs (the cohorts of tests/test_distributed.py)
and the port's own.

- the runtime's pieces: owned_samples / owned_partitions, global_sum,
  barrier, from_primary, in a single process and over two ranks;
- `count` + `diff` over two ranks at k = 21 and k = 45 (two words): FASTA,
  every count file and histogram byte-identical to the JAX package's
  single-process `count` + `diff`;
- popstrat `diff --save-sk` over two ranks, then a resume with a new
  correction (merge and popstrat skipped): byte-identical to the port's
  single process, and within the popstrat rule of the JAX package;
- `run --distributed` equals the two-rank `count` + `diff`; `diff --model`
  over two ranks equals a single process's;
- the CLI: `--distributed` runs, `--devices 2` beside it (item 7c) and
  `--profile` raise, and `--devices N` alone runs the mesh;
- tools/dist_walls.py's reading of a rank's log.

Every rank has a wall-clock limit and the group a gloo timeout
(KMDIFF_DIST_TIMEOUT), and both ranks are killed when one fails, so no test
hangs.
"""

import datetime
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.io.fasta import read_fasta
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.cli import parse_args
from kmdiff_tpu_torch.parallel import distributed as D
from kmdiff_tpu_torch.tools.dist_walls import log_breakdown

REPO = str(pathlib.Path(__file__).resolve().parents[1])
PLUGIN = os.path.join(REPO, "kmdiff_tpu_torch", "examples", "plugins",
                      "device_fold_change_model.py")
#: seconds a rank may run, and a collective may wait for the other rank
RANK_LIMIT = 240
GROUP_TIMEOUT = "60"

_CLI_WORKER = r"""
import json, os, sys, time
time.sleep(float(os.environ.get("TEST_RANK_DELAY", "0")))
from kmdiff_tpu_torch.cli import main
for argv, port in json.loads(sys.argv[1]):
    if "KMDIFF_COORDINATOR" in os.environ:
        os.environ["KMDIFF_COORDINATOR"] = f"127.0.0.1:{port}"
    assert main(argv, device="cpu") == 0, argv
print("RANK_OK", flush=True)
"""

_RUNTIME_WORKER = r"""
from kmdiff_tpu_torch.parallel import distributed as D
assert D.init_distributed()
r = D.rank()
assert D.is_distributed() and D.world_size() == 2
assert D.is_primary() == (r == 0)
assert D.owned_partitions(5) == ([0, 2, 4] if r == 0 else [1, 3])
assert D.owned_samples(5) == D.owned_partitions(5)
assert D.owned_samples(1) == ([0] if r == 0 else [])
assert D.global_sum([1, r, 10 * r, 2**40]) == [2, 1, 10, 2**41]
D.barrier("test")
assert D.from_primary({"rank": r, "v": [r]}) == {"rank": 0, "v": [0]}
assert str(D.rank_device(__import__("torch").device("cpu"))) == "cpu"
D.shutdown()
assert not D.is_distributed() and D.owned_partitions(3) == [0, 1, 2]
print("RANK_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, commands: list[list[str]], logs: pathlib.Path,
              via: str = "env", world: int = 2,
              delays: tuple = ()) -> list[str]:
    """Run `script` in `world` ranks, its argument the JSON list of
    [argv, port] of `commands`, each command on a coordinator port of its
    own: passed in the KMDIFF_* environment (the script sets
    KMDIFF_COORDINATOR for each command), or with `via` "flags" appended
    to each argv as --distributed, --num-processes and --process-id.
    Returns each rank's output. Rank r's script may wait delays[r] seconds
    before it starts (TEST_RANK_DELAY). Both ranks are killed once one
    fails or the limit passes."""
    ports = [_free_port() for _ in range(max(1, len(commands)))]
    logs.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    for r in range(world):
        env = dict(os.environ, KMDIFF_DIST_TIMEOUT=GROUP_TIMEOUT,
                   TEST_RANK_DELAY=str(delays[r] if r < len(delays) else 0),
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        if via == "env":
            env.update(KMDIFF_COORDINATOR=f"127.0.0.1:{ports[0]}",
                       KMDIFF_NUM_PROCESSES=str(world), KMDIFF_PROCESS_ID=str(r))
        runs = []
        for a, p in zip(commands, ports):
            if via == "flags":
                a = [*a, "--distributed", f"127.0.0.1:{p}", "--num-processes",
                     str(world), "--process-id", str(r)]
            runs.append([a, p])
        argv = json.dumps(runs)
        log = open(logs / f"rank{r}.log", "w")
        files.append(log)
        procs.append(subprocess.Popen([sys.executable, "-c", script, argv],
                                      env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_LIMIT
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    outs = [(logs / f"rank{r}.log").read_text() for r in range(world)]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
        assert "RANK_OK" in out
    return outs


def run_cli_ranks(commands: list[list[str]], logs, via="flags",
                  delays: tuple = ()) -> list[str]:
    return run_ranks(_CLI_WORKER, commands, logs, via=via, delays=delays)


def _same_files(a: pathlib.Path, b: pathlib.Path, rels) -> None:
    for rel in rels:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _run_dir_files(run_dir: pathlib.Path) -> list[str]:
    rels = ["kmtricks.fof", "kmdiff-count.opt"]
    for sub in ("counts", "histograms"):
        rels += sorted(str(p.relative_to(run_dir))
                       for p in (run_dir / sub).rglob("*") if p.is_file())
    return rels


FASTA = ("control_kmers.fasta", "case_kmers.fasta")


# -- the runtime's pieces -------------------------------------------------------


def test_single_process_runtime():
    assert not D.is_distributed() and D.is_primary()
    assert (D.rank(), D.world_size()) == (0, 1)
    assert D.owned_samples(5) == D.owned_partitions(5) == [0, 1, 2, 3, 4]
    assert D.global_sum([3, 2**40]) == [3, 2**40]
    assert D.from_primary({"a": 1}) == {"a": 1}
    D.barrier("nothing to wait for")
    assert D.rank_device(torch.device("cpu")) == torch.device("cpu")


def test_init_without_a_group_opens_nothing(monkeypatch):
    for name in ("KMDIFF_COORDINATOR", "KMDIFF_NUM_PROCESSES", "KMDIFF_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert D.init_distributed() is False
    assert D.init_distributed("127.0.0.1:1", 1, 0) is False
    monkeypatch.setenv("KMDIFF_COORDINATOR", "127.0.0.1:1")
    assert D.init_distributed() is False  # no process count
    with pytest.raises(ValueError, match="process-id"):
        D.init_distributed(num_processes=2, process_id=2)
    with pytest.raises(ValueError, match="process-id"):
        D.init_distributed(num_processes=2)
    assert not D.is_distributed()


def test_two_rank_runtime(tmp_path):
    run_ranks(_RUNTIME_WORKER, [], tmp_path)


# -- count + diff against the JAX package ---------------------------------------


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """tests/test_distributed.py's count + diff cohort (seed 21): 2 + 2
    samples of shared and private 120 bp sequences."""
    root = tmp_path_factory.mktemp("dist_cohort")
    rng = np.random.default_rng(21)
    bases = np.array(list("ACGT"))
    shared_c = ["".join(rng.choice(bases, 120)) for _ in range(3)]
    shared_k = ["".join(rng.choice(bases, 120)) for _ in range(3)]
    fof_lines = []
    for sid in ("C1", "C2", "K1", "K2"):
        fa = root / f"{sid}.fasta"
        shared = shared_c if sid.startswith("C") else shared_k
        with open(fa, "w") as f:
            for j, s in enumerate(shared):
                for r in range(6):
                    f.write(f">s{j}_{r}\n{s}\n")
            for j in range(3):
                f.write(f">r{j}\n{''.join(rng.choice(bases, 120))}\n")
        fof_lines.append(f"{sid} : {fa}")
    (root / "fof.txt").write_text("\n".join(fof_lines) + "\n")
    return root


def _count_args(fof, run_dir, k):
    return ["count", "--file", str(fof), "--run-dir", str(run_dir),
            "--kmer-size", str(k), "--hard-min", "1", "--nb-partitions", "5",
            "--threads", "2"]


def _diff_args(run_dir, out, *extra):
    return ["diff", "--km-run-dir", str(run_dir), "-1", "2", "-2", "2",
            "--output-dir", str(out), "-s", "0.5", "--cutoff", "1",
            "--threads", "2", *extra]


@pytest.mark.parametrize("k", [21, 45])
def test_two_rank_count_diff_matches_jax(cohort, tmp_path, k):
    fof = cohort / "fof.txt"
    assert jax_main([*_count_args(fof, tmp_path / "jrun", k), "--devices", "1"]) == 0
    assert jax_main([*_diff_args(tmp_path / "jrun", tmp_path / "jout"),
                     "--devices", "1"]) == 0
    outs = run_cli_ranks([_count_args(fof, tmp_path / "run", k),
                          _diff_args(tmp_path / "run", tmp_path / "out")],
                         tmp_path / "logs")
    assert "owns partitions [0, 2, 4]" in outs[0]
    assert "owns partitions [1, 3]" in outs[1]
    assert "Counted 2/4 samples" in outs[0] and "Counted 2/4 samples" in outs[1]
    rels = _run_dir_files(tmp_path / "jrun")
    assert len(rels) == 2 + 4 * 5 + 4
    assert _run_dir_files(tmp_path / "run") == rels
    _same_files(tmp_path / "run", tmp_path / "jrun", rels)
    _same_files(tmp_path / "out", tmp_path / "jout", (*FASTA, "options.json"))
    assert read_fasta(str(tmp_path / "out" / "case_kmers.fasta"))
    # the spills went with the primary's clean-up (no --keep-tmp)
    assert not os.listdir(tmp_path / "out" / "partitions")


def test_late_rank_follows_the_primarys_resume_decision(cohort, tmp_path):
    """A rerun whose merge spills are incomplete: the primary redoes the
    merge, and rank 1, started late, sees the primary's fresh spills beside
    its own old ones. It must take the primary's decision (redo) and not its
    own probe's (resume), or the ranks meet at different collectives."""
    fof = cohort / "fof.txt"
    assert torch_main(_count_args(fof, tmp_path / "run", 21), device="cpu") == 0
    diff = _diff_args(tmp_path / "run", tmp_path / "out", "--keep-tmp")
    run_cli_ranks([diff], tmp_path / "logs1")
    first = {n: (tmp_path / "out" / n).read_bytes() for n in (*FASTA, "options.json")}
    for p in (0, 2, 4):  # the primary's partitions
        os.remove(tmp_path / "out" / "partitions" / f"p{p}_uncorrected")
    outs = run_cli_ranks([diff], tmp_path / "logs2", delays=(0, 4))
    assert not any("merge stage resumed" in o for o in outs)
    for name, data in first.items():
        assert (tmp_path / "out" / name).read_bytes() == data, name


def test_two_rank_run_equals_count_diff(cohort, tmp_path):
    fof = cohort / "fof.txt"
    run = ["run", "--file", str(fof), "-d", str(tmp_path / "rrun"), "-k",
           "21", "--nb-partitions", "5", "-1", "2", "-2", "2", "-o",
           str(tmp_path / "rout"), "-s", "0.5", "--cutoff", "1", "--threads", "2"]
    outs = run_cli_ranks([_count_args(fof, tmp_path / "run", 21),
                          _diff_args(tmp_path / "run", tmp_path / "out"), run],
                         tmp_path / "logs", via="env")
    assert all("standard count+diff flow" in o for o in outs)
    rels = _run_dir_files(tmp_path / "run")
    assert _run_dir_files(tmp_path / "rrun") == rels
    _same_files(tmp_path / "rrun", tmp_path / "run", rels)
    _same_files(tmp_path / "rout", tmp_path / "out", (*FASTA, "options.json"))


def test_two_rank_custom_model_matches_single(cohort, tmp_path):
    fof = cohort / "fof.txt"
    model = ["-c", "disabled", "--model", PLUGIN]
    assert torch_main(_count_args(fof, tmp_path / "run", 21), device="cpu") == 0
    assert torch_main(_diff_args(tmp_path / "run", tmp_path / "single", *model),
                      device="cpu") == 0
    run_cli_ranks([_diff_args(tmp_path / "run", tmp_path / "out", *model)],
                  tmp_path / "logs")
    _same_files(tmp_path / "out", tmp_path / "single", (*FASTA, "options.json"))
    assert read_fasta(str(tmp_path / "out" / "case_kmers.fasta"))


# -- popstrat and resume ---------------------------------------------------------


@pytest.fixture(scope="module")
def stratified(tmp_path_factory):
    """tests/test_distributed.py's stratified cohort (seed 33): 10 + 10
    samples from two subpopulations, cases enriched in one, six
    case-associated sequences in every case."""
    root = tmp_path_factory.mktemp("dist_pop")
    rng = np.random.default_rng(33)
    bases = np.array(list("ACGT"))

    def reads(background, private, n=60):
        seqs = []
        for _ in range(n):
            src = private if rng.random() < 0.5 else background
            seqs.append(src[rng.integers(0, len(src))])
        return seqs

    shared = ["".join(rng.choice(bases, 60)) for _ in range(30)]
    pop_a = ["".join(rng.choice(bases, 60)) for _ in range(20)]
    pop_b = ["".join(rng.choice(bases, 60)) for _ in range(20)]
    case_signal = ["".join(rng.choice(bases, 60)) for _ in range(6)]
    fof_lines = []
    for i in range(20):
        is_case = i >= 10
        in_b = (i % 5 != 0) if is_case else (i % 2 == 0)
        sid = f"{'CASE' if is_case else 'CONTROL'}{i}"
        fa = root / f"{sid}.fasta"
        with open(fa, "w") as f:
            for j, s in enumerate(reads(shared, pop_b if in_b else pop_a)):
                f.write(f">r{j}\n{s}\n")
            if is_case:
                for j, s in enumerate(case_signal):
                    for rep in range(3):
                        f.write(f">sig{j}_{rep}\n{s}\n")
            else:
                for j in range(12 + int(rng.integers(0, 12))):
                    f.write(f">pad{j}\n{''.join(rng.choice(bases, 60))}\n")
        fof_lines.append(f"{sid} : {fa}")
    (root / "fof.txt").write_text("\n".join(fof_lines) + "\n")
    return root


POP_THRESHOLD = 0.2
POP_ARTIFACTS = ("gwas_eigenstratX.geno", "gwas_eigenstratX.snp",
                 "gwas_eigenstratX.ind", "gwas_eigenstratX.total", "control.ind",
                 "case.ind", "parfile.txt", "pcs.evec", "null_fit.npz")


def _pop_args(run_dir, out, correction):
    return ["diff", "--km-run-dir", str(run_dir), "-1", "10", "-2", "10",
            "--output-dir", str(out), "-s", str(POP_THRESHOLD), "--cutoff", "1",
            "-c", correction, "--pop-correction", "--kmer-pca", "0.05",
            "--n-pc", "2", "--save-sk", "--keep-tmp", "--threads", "2"]


def _pvals(out) -> dict:
    ps = {}
    for cls in ("control", "case"):
        for name, seq in read_fasta(os.path.join(out, f"{cls}_kmers.fasta")):
            ps[(cls, seq)] = float(name.split("pval=")[1].split("_")[0])
    return ps


def _same_pop_output(ours: pathlib.Path, ref: pathlib.Path) -> None:
    _same_files(ours, ref, (*FASTA, "options.json"))
    _same_files(ours / "popstrat", ref / "popstrat", POP_ARTIFACTS)
    mdir = pathlib.Path("positive_kmer_matrix", "matrices")
    mats = sorted(os.listdir(ref / mdir))
    assert mats == [f"matrix_{p}.count.lz4" for p in range(5)]
    assert sorted(os.listdir(ours / mdir)) == mats
    _same_files(ours / mdir, ref / mdir, mats)


def test_two_rank_popstrat_and_resume(stratified, tmp_path):
    fof = stratified / "fof.txt"
    single = tmp_path / "single_run"
    assert torch_main(_count_args(fof, single, 21), device="cpu") == 0
    for corr in ("disabled", "benjamini"):
        assert torch_main(_pop_args(single, tmp_path / f"single_{corr}", corr),
                          device="cpu") == 0
    assert jax_main([*_pop_args(single, tmp_path / "jax", "disabled"),
                     "--devices", "1"]) == 0

    run, out = tmp_path / "run", tmp_path / "out"
    outs = run_cli_ranks([_count_args(fof, run, 21),
                          _pop_args(run, out, "disabled")],
                         tmp_path / "logs1", via="env")
    assert "popstrat corrected partitions [0, 2, 4]" in outs[0]
    assert "popstrat corrected partitions [1, 3]" in outs[1]
    assert "Null fit" in outs[0] and "Null fit" not in outs[1]
    _same_files(run, single, _run_dir_files(single))
    _same_pop_output(out, tmp_path / "single_disabled")
    assert not list((out / "popstrat").glob("geno_part_*.npy"))

    # the JAX package's popstrat rule: the same k-mers but for those within
    # 1% of the threshold, p-values within 1%
    got, want = _pvals(out), _pvals(tmp_path / "jax")
    assert len(want) >= 10
    near = {k for k, p in want.items()
            if abs(p - POP_THRESHOLD) <= 0.01 * POP_THRESHOLD}
    assert set(got) - near == set(want) - near
    for key in set(got) & set(want):
        assert got[key] == pytest.approx(want[key], rel=1e-2), key

    # resume: only the correction changed -> merge and popstrat skipped
    outs = run_cli_ranks([_pop_args(run, out, "benjamini")],
                         tmp_path / "logs2")
    assert all("merge stage resumed from spills" in o for o in outs)
    assert not any("popstrat corrected partitions" in o for o in outs)
    _same_pop_output(out, tmp_path / "single_benjamini")


# -- the CLI ----------------------------------------------------------------------


def test_cli_distributed_flags_parse():
    args = parse_args(["count", "--file", "f", "--run-dir", "d", "--distributed",
                       "127.0.0.1:1", "--num-processes", "2", "--process-id", "1"])
    assert (args.distributed, args.num_processes, args.process_id) == \
        ("127.0.0.1:1", 2, 1)


@pytest.mark.parametrize("extra, item", [
    (["--devices", "2", "--distributed", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0"], "item 7c: the mesh under --distributed"),
    (["--profile", "trace"], "item 10"),
])
def test_cli_unported_flags_name_their_item(cohort, tmp_path, extra, item):
    # raised before any process group is opened: nothing waits for rank 1
    with pytest.raises(NotImplementedError, match=item):
        torch_main(_diff_args(cohort, tmp_path, *extra), device="cpu")
    assert not D.is_distributed()


@pytest.mark.parametrize("extra", [["--devices", "2"], ["--devices", "8"]])
def test_cli_devices_without_distributed_runs_the_mesh(cohort, tmp_path, extra):
    # without --distributed, --devices N is the mesh of N shards in one
    # process (kmdiff_tpu_torch/parallel/): the output of --devices 1
    run_dir = tmp_path / "rd"
    assert torch_main(_count_args(cohort / "fof.txt", run_dir, 21),
                      device="cpu") == 0
    outs = []
    for tag, flags in (("one", ["--devices", "1"]), ("mesh", extra)):
        out = tmp_path / tag
        assert torch_main(_diff_args(run_dir, out, *flags), device="cpu") == 0
        outs.append({n: (out / n).read_bytes()
                     for n in ("control_kmers.fasta", "case_kmers.fasta")})
    assert not D.is_distributed()
    assert outs[0] == outs[1] and any(outs[0].values())


def test_log_breakdown_reads_a_rank_log():
    """tools/dist_walls.py's reading of a process's log (chip_smoke.py
    phase 9 prints it): the first sample's time after the command's start,
    the samples' thread seconds, the merge's and the aggregation's."""
    log = (
        "[2026-01-02 03:04:05.500] [INFO] distributed runtime: process 0/2\n"
        "[2026-01-02 03:04:06.250] [INFO] [C1] 600 distinct k-mers (600 after "
        "hard-min=1; count+fetch 0.6s, hist+spill 0.4s).\n"
        "[2026-01-02 03:04:06.900] [INFO] [C2] 600 distinct k-mers (600 after "
        "hard-min=1; count+fetch 0.5s, hist+spill 0.3s).\n"
        "[2026-01-02 03:04:09.000] [INFO] Partitions processed (01m02.50s)\n"
        "[2026-01-02 03:04:09.100] [INFO] Partitions aggregated (00.04s)\n")
    start = datetime.datetime(2026, 1, 2, 3, 4, 5).timestamp()
    assert log_breakdown({"log": log, "start": start}) == {
        "samples": 2, "count_fetch": 1.1, "hist_spill": 0.7, "first": 1.25,
        "merge": 62.5, "aggregate": 0.04}
    assert log_breakdown({"log": "", "start": start}) == {"samples": 0}
