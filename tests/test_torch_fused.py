"""The port's fused `run` end to end, on the CPU (device="cpu": every kernel
wrapper takes its plain twin), on a simulated cohort (20 kbp genome, 3
controls + 3 cases, k=31). Its outputs (FASTA, KFF, options.json) and its
run directory (count files, histograms, kmtricks.fof, kmdiff-count.opt)
must be byte-identical to the JAX package's `run` and to the port's own
`count` + `diff`, also with a sample in two files (FASTA and .gz FASTQ)
and a FASTQ file that the record parser takes. Both packages'
`_standard_flow` is made to fail wherever the fused path must serve the run.
"""

import gzip
import os
import sys
import threading

import pytest
import torch

import kmdiff_tpu.cmd.run as jrun
import kmdiff_tpu.pipeline.count as jcount
import kmdiff_tpu.pipeline.fused as jfused
from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch import profiling
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.cmd import run as trun
from kmdiff_tpu_torch.pipeline import count as tcount
from kmdiff_tpu_torch.pipeline import fused

OUTPUTS = ("control_kmers.fasta", "case_kmers.fasta", "options.json")


def _files(root):
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def fof(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    return str(root / "sim" / "fof.txt")


def _no_fallback(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("the fused path fell back to the standard flow")

    monkeypatch.setattr(jrun, "_standard_flow", boom)
    monkeypatch.setattr(trun, "_standard_flow", boom)
    # the JAX merge sorts its whole padded S x CHUNK_ROWS buffer (6 x 2^21
    # rows by default); a cohort this small fits 2^15 rows a stream, and the
    # outputs do not depend on the chunking
    monkeypatch.setattr(jfused, "CHUNK_ROWS", 1 << 15)


def _run(main, fof, root, extra=(), **kw):
    args = ["run", "--file", fof, "-d", str(root / "kc"), "-o", str(root / "out"),
            "-k", "31", "-1", "3", "-2", "3", "--nb-partitions", "4",
            "--threads", "2", *extra]
    assert main(args, **kw) == 0
    return root


def _port_run(fof, root, extra=()):
    return _run(torch_main, fof, root, extra, device="cpu")


def _jax_run(fof, root, extra=()):
    return _run(jax_main, fof, root, [*extra, "--devices", "1"])


def _port_count_diff(fof, root, count_extra=(), diff_extra=()):
    """The port's two stages with the run's flags."""
    assert torch_main(["count", "--file", fof, "--run-dir", str(root / "kc"),
                       "-k", "31", "--nb-partitions", "4", "--threads", "2",
                       *count_extra], device="cpu") == 0
    assert torch_main(["diff", "--km-run-dir", str(root / "kc"), "-1", "3",
                       "-2", "3", "--output-dir", str(root / "out"),
                       "--threads", "2", *diff_extra], device="cpu") == 0
    return root


def _same_outputs(a, b, names=OUTPUTS):
    for name in names:
        got = (a / "out" / name).read_bytes()
        assert got == (b / "out" / name).read_bytes(), name


def _same_run_dirs(a, b):
    fa, fb = _files(a / "kc"), _files(b / "kc")
    assert sorted(fa) == sorted(fb)
    assert sum(n.endswith(".kmer.lz4") for n in fa) == 4 * 6
    assert {"kmtricks.fof", "kmdiff-count.opt"} <= set(fa)
    for name in sorted(fa):
        assert fa[name] == fb[name], name


@pytest.mark.parametrize("variant", ["bonferroni", "disabled", "kff"])
def test_run_matches_jax_run(fof, tmp_path, monkeypatch, variant):
    extra = {"bonferroni": [], "disabled": ["-c", "disabled"],
             "kff": ["--kff-output"]}[variant]
    _no_fallback(monkeypatch)
    ours = _port_run(fof, tmp_path / "t", extra)
    ref = _jax_run(fof, tmp_path / "j", extra)
    if variant == "kff":
        _same_outputs(ours, ref, ("control_kmers.kff", "case_kmers.kff",
                                  "options.json"))
    else:
        _same_outputs(ours, ref)
        assert (ref / "out" / "case_kmers.fasta").stat().st_size > 0
    _same_run_dirs(ours, ref)


def test_run_matches_port_count_diff(fof, tmp_path, monkeypatch):
    _no_fallback(monkeypatch)
    ours = _port_run(fof, tmp_path / "f")
    two = _port_count_diff(fof, tmp_path / "s")
    _same_outputs(ours, two)
    _same_run_dirs(ours, two)


def _mixed_fof(fof, root) -> str:
    """The cohort with its first sample in two files (a FASTA and a
    gzipped FASTQ of the rest of its reads) and its second a FASTQ that
    is not strict four-line records (a blank last line)."""
    entries = [line.split(" : ") for line in open(fof).read().splitlines()]
    reads = open(entries[0][1]).read().splitlines()
    half = len(reads) // 4 * 2
    (root / "s0a.fasta").write_text("\n".join(reads[:half]) + "\n")
    with gzip.open(root / "s0b.fastq.gz", "wt") as f:
        for name, seq in zip(reads[half::2], reads[half + 1::2]):
            f.write(f"@{name[1:]}\n{seq}\n+\n{'I' * len(seq)}\n")
    reads = open(entries[1][1]).read().splitlines()
    with open(root / "s1.fastq", "w") as f:
        for name, seq in zip(reads[0::2], reads[1::2]):
            f.write(f"@{name[1:]}\n{seq}\n+\n{'I' * len(seq)}\n")
        f.write("\n")
    entries[0][1] = f"{root / 's0a.fasta'} ; {root / 's0b.fastq.gz'}"
    entries[1][1] = str(root / "s1.fastq")
    path = root / "mixed_fof.txt"
    path.write_text("".join(f"{e} : {p}\n" for e, p in entries))
    return str(path)


def test_run_decodes_mixed_files_as_count_does(fof, tmp_path, monkeypatch):
    """A sample in two files (FASTA and .gz FASTQ, joined on the device)
    and a FASTQ file that the record parser takes: the fused run tallies
    all seven files, that one as the record parser's, and its outputs and
    run directory equal count + diff's, whose host parse is flat_codes."""
    mixed = _mixed_fof(fof, tmp_path)
    _no_fallback(monkeypatch)
    timings: dict = {}
    with profiling.collect(timings):
        ours = _port_run(mixed, tmp_path / "f")
    assert (timings["parse_files"], timings["parse_fallback_files"]) == (7, 1)
    two = _port_count_diff(mixed, tmp_path / "s")
    _same_outputs(ours, two)
    _same_run_dirs(ours, two)


def test_run_multichunk_hard_min_matches_jax(fof, tmp_path, monkeypatch):
    """A 4096-window sort chunk puts every sample through several chunks
    (dedup_sum of partial counts), with hard-min 2 on top."""
    monkeypatch.setattr(jcount, "SORT_ROWS", 1 << 12)
    monkeypatch.setattr(tcount, "SORT_ROWS", 1 << 12)
    chunked = []
    real = fused.count_sample_resident

    def spy(codes, k, hard_min, device):
        chunked.append(len(tcount._host_code_chunks(codes, k, tcount.SORT_ROWS)))
        return real(codes, k, hard_min, device)

    monkeypatch.setattr(fused, "count_sample_resident", spy)
    _no_fallback(monkeypatch)
    extra = ["--hard-min", "2", "-s", "0.5", "--cutoff", "1"]
    ours = _port_run(fof, tmp_path / "t", extra)
    ref = _jax_run(fof, tmp_path / "j", extra)
    assert len(chunked) == 6 and min(chunked) > 2
    _same_outputs(ours, ref)
    _same_run_dirs(ours, ref)


def test_run_tiny_merge_chunks(fof, tmp_path, monkeypatch):
    """A 300-row chunk budget cuts the merge into hundreds of K-ASM chunks;
    the outputs do not depend on the cut."""
    monkeypatch.setattr(fused, "FUSED_CHUNK_ROWS", 300)
    plans = []
    real = fused.plan_key_chunks

    def spy(streams, max_rows=None, n_shards=1):
        plans.append(real(streams, max_rows, n_shards))
        return plans[-1]

    monkeypatch.setattr(fused, "plan_key_chunks", spy)
    _no_fallback(monkeypatch)
    extra = ["-s", "0.5", "--cutoff", "1", "-c", "disabled"]
    ours = _port_run(fof, tmp_path / "f", extra)
    two = _port_count_diff(fof, tmp_path / "s", (), extra)
    starts, lens = plans[0]
    assert len(starts) > 300 and lens.sum(1).max() <= 300
    _same_outputs(ours, two)


def test_run_no_count_files(fof, tmp_path, monkeypatch):
    _no_fallback(monkeypatch)
    ours = _port_run(fof, tmp_path / "f", ["--no-count-files"])
    two = _port_count_diff(fof, tmp_path / "s")
    _same_outputs(ours, two)
    for p in range(4):
        assert not os.listdir(ours / "kc" / "counts" / f"partition_{p}")
    hists = sorted(os.listdir(ours / "kc" / "histograms"))
    assert len(hists) == 6
    for h in hists:
        assert ((ours / "kc" / "histograms" / h).read_bytes()
                == (two / "kc" / "histograms" / h).read_bytes())


def test_run_k15_matches_jax(fof, tmp_path, monkeypatch):
    """k=15: one int64 key whose high half is zero needs no special path."""
    _no_fallback(monkeypatch)
    extra = ["-k", "15", "-s", "0.5", "--cutoff", "1"]
    ours = _port_run(fof, tmp_path / "t", extra)
    ref = _jax_run(fof, tmp_path / "j", extra)
    _same_outputs(ours, ref)
    _same_run_dirs(ours, ref)


def test_run_p32_counts(tmp_path, monkeypatch):
    """A k-mer counted 40,000 times packs the merge's counts as int32
    (p32) and lands in the histogram's oversize bin; main_run fills the
    timings of the fused path."""
    from kmdiff_tpu.cmd.options import CountOptions, DiffOptions
    from kmdiff_tpu.core.corrector import CorrectionType

    lines = []
    for i, reps in enumerate((40000, 3)):
        fa = tmp_path / f"s{i}.fasta"
        with open(fa, "w") as f:
            for j in range(reps):
                f.write(f">r{j}\nACGTACGTACGTACGTACGTA\n")
            f.write(">u\nTTTTTGGGGGCCCCCAAAAAT\n")
        lines.append(f"s{i} : {fa}")
    fof = tmp_path / "fof.txt"
    fof.write_text("\n".join(lines) + "\n")
    packings = []
    real = fused.ChunkTable.assemble

    def spy(table, c, pack16, with_sample=False):
        packings.append(pack16)
        return real(table, c, pack16, with_sample)

    monkeypatch.setattr(fused.ChunkTable, "assemble", spy)
    _no_fallback(monkeypatch)

    def opts(root):
        return (CountOptions(fof=str(fof), directory=str(root / "kc"),
                             kmer_size=21, hard_min=1, nb_partitions=4,
                             nb_threads=2, n_devices=1),
                DiffOptions(kmtricks_dir=str(root / "kc"),
                            output_directory=str(root / "out"), nb_controls=1,
                            nb_cases=1, threshold=0.5, cutoff=1.0,
                            correction=CorrectionType.NOTHING, nb_threads=2,
                            n_devices=1))

    timings = {}
    res = trun.main_run(*opts(tmp_path / "t"), torch.device("cpu"),
                        timings=timings)
    jres = jrun.main_run(*opts(tmp_path / "j"))
    assert packings == [False]
    assert res == jres and res["total_kmers"] > 0
    # the fused path's walls and the thread-seconds of its spans
    # (profiling.collect): a sample's parse, copy and count, a merge chunk
    # and its device merge; and its tallies of the files decoded
    assert set(timings) == {"count", "merge", "total", "parse_thread_s",
                            "h2d_thread_s", "count_thread_s",
                            "merge_chunk_thread_s", "device_thread_s",
                            "parse_files", "parse_fallback_files"}
    assert (timings["parse_files"], timings["parse_fallback_files"]) == (2, 0)
    _same_outputs(tmp_path / "t", tmp_path / "j")
    assert (_files(tmp_path / "t" / "kc") == _files(tmp_path / "j" / "kc"))


def test_run_resumes_through_standard_flow(fof, tmp_path, monkeypatch):
    _no_fallback(monkeypatch)
    ours = _port_run(fof, tmp_path / "f")
    first = _files(ours / "out")
    monkeypatch.undo()
    called = []
    real = trun._standard_flow

    def spy(copt, dopt, device):
        called.append(device)
        return real(copt, dopt, device)

    monkeypatch.setattr(trun, "_standard_flow", spy)
    _port_run(fof, tmp_path / "f")
    assert called == [torch.device("cpu")]
    assert _files(ours / "out") == first


@pytest.mark.parametrize("where,error", [
    ("merge", fused.FusedFallback("forced after counting")),
    ("merge", torch.cuda.OutOfMemoryError("forced device allocation failure")),
    ("count", torch.cuda.OutOfMemoryError("forced device allocation failure")),
])
def test_fallback_drains_spills_outside_the_handler(fof, tmp_path, monkeypatch,
                                                    where, error):
    """A FusedFallback or a device OOM during the fused attempt: every spill
    has finished, the exception is no longer being handled when the
    standard flow starts, and the outputs are count + diff's."""
    if where == "merge":
        def boom(*_a, **_k):
            raise error

        monkeypatch.setattr(fused, "fused_merge", boom)
    else:
        real_count = fused.count_sample_resident
        calls = []

        def boom(codes, k, hard_min, device):
            calls.append(1)
            if len(calls) == 4:
                raise error
            return real_count(codes, k, hard_min, device)

        monkeypatch.setattr(fused, "count_sample_resident", boom)
    seen = {}
    real = trun._standard_flow

    def spy(copt, dopt, device):
        seen["exc_info"] = sys.exc_info()
        seen["complete"] = trun._run_dir_complete(copt.directory)
        seen["spilling"] = [t.name for t in threading.enumerate()
                            if t.name.startswith("kmdiff-spill")]
        return real(copt, dopt, device)

    monkeypatch.setattr(trun, "_standard_flow", spy)
    ours = _port_run(fof, tmp_path / "f")
    assert seen["exc_info"] == (None, None, None)
    assert seen["spilling"] == []
    # after counting, every sample was spilled, so count is not redone
    assert seen["complete"] == (where == "merge")
    two = _port_count_diff(fof, tmp_path / "s")
    _same_outputs(ours, two)
    _same_run_dirs(ours, two)
