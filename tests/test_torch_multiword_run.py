"""The port's fused `run` and its popstrat at k > 32 (multi-word k-mers),
on the CPU (every kernel wrapper takes its plain twin), against the JAX
package's:

- `run` at k = 33 and 47 on a simulated cohort (20 kbp genome, 150 bp
  reads, 3 + 3 samples): outputs and run directory byte-identical to the
  JAX `run`'s and to the port's `count` + `diff`, also with two-chunk
  samples and merge chunks cut on the leading word;
- `diff --pop-correction --save-sk` at k = 55 on a stratified cohort (the
  generator of tests/test_popstrat.py with 100-base sequences): every
  popstrat artifact (pcs.evec included; the live f32 null fit aside) and
  every --save-sk matrix byte-identical, the FASTA held to the 1% rule of
  tests/test_torch_popstrat.py; `run --pop-correction` at k = 55: FASTA
  and pcs.evec byte-identical to the port's diff, .geno and pcs.evec to
  the JAX `run`'s.
"""

import os

import numpy as np
import pytest

import kmdiff_tpu.cmd.run as jrun
import kmdiff_tpu.pipeline.count as jcount
import kmdiff_tpu.pipeline.fused as jfused
from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.io.fasta import read_fasta
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.cmd import run as trun
from kmdiff_tpu_torch.pipeline import count as tcount
from kmdiff_tpu_torch.pipeline import fused

OUTPUTS = ("control_kmers.fasta", "case_kmers.fasta", "options.json")
#: the popstrat artifacts held byte-identical; null_fit.npz, a live f32
#: IRLS fit here (the samples' totals differ), is held like the FASTA by
#: tests/test_torch_popstrat.py's unequal-totals test, so it is left out
ARTIFACTS = ("gwas_eigenstratX.geno", "gwas_eigenstratX.snp",
             "gwas_eigenstratX.ind", "gwas_eigenstratX.total", "control.ind",
             "case.ind", "parfile.txt", "pcs.evec")
THRESHOLD = 0.2


def _files(root):
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _no_fallback(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("the fused path fell back to the standard flow")

    monkeypatch.setattr(jrun, "_standard_flow", boom)
    monkeypatch.setattr(trun, "_standard_flow", boom)
    monkeypatch.setattr(jfused, "CHUNK_ROWS", 1 << 15)


@pytest.fixture(scope="module")
def fof(tmp_path_factory):
    root = tmp_path_factory.mktemp("mw_run_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, read_size=150, seed=5))
    return str(root / "sim" / "fof.txt")


def _run(main, fof, root, k, extra=(), **kw):
    args = ["run", "--file", fof, "-d", str(root / "kc"), "-o", str(root / "out"),
            "-k", str(k), "-1", "3", "-2", "3", "--nb-partitions", "4",
            "--threads", "2", "-s", "0.5", "--cutoff", "1", "-c", "disabled",
            *extra]
    assert main(args, **kw) == 0
    return root


def _same(a, b, names=OUTPUTS):
    for name in names:
        assert (a / "out" / name).read_bytes() == (b / "out" / name).read_bytes(), name


def _same_run_dirs(a, b):
    fa, fb = _files(a / "kc"), _files(b / "kc")
    assert sorted(fa) == sorted(fb)
    assert sum(n.endswith(".kmer.lz4") for n in fa) == 4 * 6
    for name in sorted(fa):
        assert fa[name] == fb[name], name


@pytest.mark.parametrize("k", [33, 47])
def test_run_matches_jax_run_and_count_diff(fof, tmp_path, monkeypatch, k):
    _no_fallback(monkeypatch)
    ours = _run(torch_main, fof, tmp_path / "t", k, device="cpu")
    ref = _run(jax_main, fof, tmp_path / "j", k, ["--devices", "1"])
    _same(ours, ref)
    assert (ref / "out" / "case_kmers.fasta").stat().st_size > 1000
    _same_run_dirs(ours, ref)
    two = tmp_path / "s"
    common = ["-k", str(k), "--nb-partitions", "4", "--threads", "2"]
    assert torch_main(["count", "--file", fof, "--run-dir", str(two / "kc"),
                       *common[:-2]], device="cpu") == 0
    assert torch_main(["diff", "--km-run-dir", str(two / "kc"), "-1", "3", "-2",
                       "3", "--output-dir", str(two / "out"), "--threads", "2",
                       "-s", "0.5", "--cutoff", "1", "-c", "disabled"],
                      device="cpu") == 0
    _same(ours, two)
    _same_run_dirs(ours, two)


def test_run_multichunk_samples_and_leading_word_chunks(fof, tmp_path, monkeypatch):
    """k = 47 with every sample counted in several chunks (dedup_sum on
    [2, N] keys) and hard-min 2, and merge chunks of at most 6,000 rows cut
    on the leading word: outputs and run directory as the JAX `run`'s."""
    _no_fallback(monkeypatch)
    monkeypatch.setattr(jcount, "SORT_ROWS", (1 << 14) - 128)
    monkeypatch.setattr(tcount, "SORT_ROWS", (1 << 14) - 128)
    monkeypatch.setattr(fused, "FUSED_CHUNK_ROWS", 6000)
    plans = []
    real_plan = fused.plan_key_chunks

    def plan(streams, max_rows=None, n_shards=1):
        out = real_plan(streams, max_rows, n_shards)
        plans.append(len(out[0]))
        return out

    monkeypatch.setattr(fused, "plan_key_chunks", plan)
    ours = _run(torch_main, fof, tmp_path / "t", 47, ["--hard-min", "2"],
                device="cpu")
    assert plans and plans[0] > 10
    ref = _run(jax_main, fof, tmp_path / "j", 47, ["--hard-min", "2", "--devices", "1"])
    _same(ours, ref)
    _same_run_dirs(ours, ref)


@pytest.fixture(scope="module")
def strat55(tmp_path_factory):
    """tests/test_popstrat.py's stratified cohort with 100-base sequences,
    counted by the JAX package at k = 55."""
    from kmdiff_tpu.cmd.count import main_count
    from kmdiff_tpu.cmd.options import CountOptions

    out = tmp_path_factory.mktemp("strat55")
    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))
    shared = ["".join(rng.choice(bases, 100)) for _ in range(30)]
    pop_a = ["".join(rng.choice(bases, 100)) for _ in range(20)]
    pop_b = ["".join(rng.choice(bases, 100)) for _ in range(20)]
    nc = nk = 6
    fof_lines = []
    for i in range(nc + nk):
        is_case = i >= nc
        private = pop_b if ((i % 3 != 0) if is_case else (i % 3 == 0)) else pop_a
        sid = f"{'CASE' if is_case else 'CONTROL'}{i}"
        fa = out / f"{sid}.fasta"
        with open(fa, "w") as f:
            for j in range(40 + 5 * (5 * i % 12)):
                src = private if rng.random() < 0.5 else shared
                f.write(f">r{j}\n{src[rng.integers(0, len(src))]}\n")
        fof_lines.append(f"{sid} : {fa}")
    (out / "fof.txt").write_text("\n".join(fof_lines) + "\n")
    run_dir = out / "run"
    main_count(CountOptions(fof=str(out / "fof.txt"), directory=str(run_dir),
                            kmer_size=55, hard_min=1, nb_partitions=4,
                            nb_threads=2))
    return out, run_dir, nc, nk


def _pvals(out):
    ps = {}
    for cls in ("control", "case"):
        for name, seq in read_fasta(os.path.join(out, f"{cls}_kmers.fasta")):
            ps[(cls, seq)] = float(name.split("pval=")[1].split("_")[0])
    return ps


def _pop_flags(nc, nk):
    return ["-1", str(nc), "-2", str(nk), "-s", str(THRESHOLD), "--cutoff", "1",
            "-c", "disabled", "--pop-correction", "--kmer-pca", "0.05",
            "--save-sk", "--threads", "2"]


def test_diff_popstrat_save_sk_matches_jax_at_k55(strat55, tmp_path):
    _root, run_dir, nc, nk = strat55
    args = ["diff", "--km-run-dir", str(run_dir), *_pop_flags(nc, nk)]
    assert jax_main([*args, "--output-dir", str(tmp_path / "j")]) == 0
    assert torch_main([*args, "--output-dir", str(tmp_path / "t")], device="cpu") == 0
    for name in ARTIFACTS:
        want = (tmp_path / "j" / "popstrat" / name).read_bytes()
        assert (tmp_path / "t" / "popstrat" / name).read_bytes() == want, name
    assert len((tmp_path / "j" / "popstrat" / "gwas_eigenstratX.geno")
               .read_text().splitlines()) > 20
    mdir = os.path.join("positive_kmer_matrix", "matrices")
    mats = sorted(os.listdir(tmp_path / "j" / mdir))
    assert mats == [f"matrix_{p}.count.lz4" for p in range(4)]
    assert sorted(os.listdir(tmp_path / "t" / mdir)) == mats
    for name in mats:
        want = (tmp_path / "j" / mdir / name).read_bytes()
        assert (tmp_path / "t" / mdir / name).read_bytes() == want, name
    got, want = _pvals(tmp_path / "t"), _pvals(tmp_path / "j")
    assert len(want) >= 10 and all(len(seq) == 55 for _g, seq in want)
    near = {k for k, p in want.items() if abs(p - THRESHOLD) <= 0.01 * THRESHOLD}
    assert set(got) - near == set(want) - near
    for key in set(got) & set(want):
        assert got[key] == pytest.approx(want[key], rel=1e-2), key


def test_run_popstrat_at_k55_matches_diff_and_jax(strat55, tmp_path, monkeypatch):
    _no_fallback(monkeypatch)
    root, run_dir, nc, nk = strat55
    run_args = ["run", "--file", str(root / "fof.txt"), "-k", "55",
                "--nb-partitions", "4", *_pop_flags(nc, nk)]
    assert torch_main([*run_args, "-d", str(tmp_path / "tk"), "-o",
                       str(tmp_path / "t")], device="cpu") == 0
    assert torch_main(["diff", "--km-run-dir", str(run_dir), *_pop_flags(nc, nk),
                       "--output-dir", str(tmp_path / "d")], device="cpu") == 0
    assert jax_main([*run_args, "-d", str(tmp_path / "jk"), "-o",
                     str(tmp_path / "j"), "--devices", "1"]) == 0
    for name in ("control_kmers.fasta", "case_kmers.fasta"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "d" / name).read_bytes()
    pop = "popstrat"
    for name in ("gwas_eigenstratX.geno", "pcs.evec"):
        assert ((tmp_path / "t" / pop / name).read_bytes()
                == (tmp_path / "j" / pop / name).read_bytes()), name
    assert ((tmp_path / "t" / pop / "pcs.evec").read_bytes()
            == (tmp_path / "d" / pop / "pcs.evec").read_bytes())
    rows = [sorted((p / pop / "gwas_eigenstratX.geno").read_text().splitlines())
            for p in (tmp_path / "t", tmp_path / "d")]
    assert rows[0] == rows[1] and len(rows[0]) > 20
    mats = tmp_path / "t" / "positive_kmer_matrix" / "matrices"
    for name in sorted(os.listdir(mats)):
        assert ((mats / name).read_bytes() == (
            tmp_path / "d" / "positive_kmer_matrix" / "matrices" / name).read_bytes())
