"""The port's population-stratification correction end to end, on the CPU
(every kernel wrapper takes its plain twin), on the stratified cohort of
tests/test_popstrat.py (12 samples, k = 21), against the JAX package.

- `diff --pop-correction --save-sk`: every popstrat artifact (the Eigenstrat
  files, pcs.evec, null_fit.npz) and every --save-sk matrix byte-identical;
  the FASTA holds the same k-mers, but for those whose JAX p-value lies
  within 1% of the threshold, with p-values within 1% relative (both
  packages fit in f32, with other summation orders).
- The host-numerics paths (--compat-popstrat, also with covariates and
  gender) give byte-identical FASTA. The host Newton null fit
  (DiffOptions(irls=False)) gives a byte-identical null_fit.npz, but its
  alt fits are K-IRLS's, as in the JAX package, so its FASTA is held like
  the IRLS path's.
- Resume, load_corrector on a JAX-written null fit, the pipelined drain,
  `run --pop-correction` (FASTA byte-identical to the port's diff, .geno
  byte-identical to the JAX `run`'s), and the prebuilt-matrix path with
  count rows, geno sampling and --save-sk.
"""

import json
import logging
import os
import pathlib

import numpy as np
import pytest
import torch
from test_popstrat import stratified_cohort  # noqa: F401  (fixture)

import kmdiff_tpu.cmd.run as jrun
import kmdiff_tpu.pipeline.fused as jfused
from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.cmd.diff import main_diff as jax_diff
from kmdiff_tpu.cmd.options import DiffOptions
from kmdiff_tpu.core.corrector import CorrectionType
from kmdiff_tpu.io.accumulator import FileAccumulator, KmerSignBlock
from kmdiff_tpu.io.fasta import read_fasta
from kmdiff_tpu.io.kmtricks import read_config, read_fof
from kmdiff_tpu.pipeline import popstrat as jpop
from kmdiff_tpu_torch.cli import count_options, diff_options, parse_args
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.cmd import run as trun
from kmdiff_tpu_torch.cmd.diff import main_diff as torch_diff
from kmdiff_tpu_torch.pipeline import popstrat as tpop

CPU = torch.device("cpu")
THRESHOLD = 0.2
ARTIFACTS = ("gwas_eigenstratX.geno", "gwas_eigenstratX.snp",
             "gwas_eigenstratX.ind", "gwas_eigenstratX.total", "control.ind",
             "case.ind", "parfile.txt", "pcs.evec", "null_fit.npz")


def _opts(cohort, out, **kw):
    _root, run_dir, nc, nk = cohort
    base = dict(kmtricks_dir=run_dir, output_directory=str(out),
                nb_controls=nc, nb_cases=nk, threshold=THRESHOLD, cutoff=1.0,
                correction=CorrectionType.NOTHING, pop_correction=True,
                kmer_pca=0.05, npc=2, nb_threads=2)
    base.update(kw)
    return DiffOptions(**base)


def _both(cohort, tmp_path, **kw):
    jax_diff(_opts(cohort, tmp_path / "j", **kw))
    torch_diff(_opts(cohort, tmp_path / "t", **kw), CPU)
    return tmp_path / "t", tmp_path / "j"


def _pvals(out):
    ps = {}
    for cls in ("control", "case"):
        for name, seq in read_fasta(os.path.join(out, f"{cls}_kmers.fasta")):
            ps[(cls, seq)] = float(name.split("pval=")[1].split("_")[0])
    return ps


def _same_bytes(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _close_fasta(ours, ref, min_kmers=10):
    got, want = _pvals(ours), _pvals(ref)
    assert len(want) >= min_kmers
    near = {k for k, p in want.items() if abs(p - THRESHOLD) <= 0.01 * THRESHOLD}
    assert set(got) - near == set(want) - near
    for k in set(got) & set(want):
        assert got[k] == pytest.approx(want[k], rel=1e-2), k


@pytest.mark.parametrize("null_fit", ["irls", "newton"])
def test_diff_popstrat_matches_jax(stratified_cohort, tmp_path, null_fit):
    ours, ref = _both(stratified_cohort, tmp_path, save_sk=True,
                      irls=null_fit == "irls")
    _same_bytes(ours / "popstrat", ref / "popstrat", ARTIFACTS)
    mats = sorted(os.listdir(ref / "positive_kmer_matrix" / "matrices"))
    assert mats == [f"matrix_{p}.count.lz4" for p in range(4)]
    assert sorted(os.listdir(ours / "positive_kmer_matrix" / "matrices")) == mats
    _same_bytes(ours / "positive_kmer_matrix" / "matrices",
                ref / "positive_kmer_matrix" / "matrices", mats)
    _close_fasta(ours, ref)


def _cov_gender(cohort, root):
    _out, run_dir, nc, nk = cohort
    cov = root / "covariates.txt"
    cov.write_text(" ".join(str(0.1 * i) for i in range(nc + nk)) + "\n")
    gender = root / "gender.txt"
    gender.write_text("".join(f"{e.id} {'M' if i % 2 else 'F'}\n"
                              for i, e in enumerate(read_fof(run_dir).entries)))
    return dict(covariates=str(cov), gender=str(gender))


@pytest.mark.parametrize("variant", ["compat", "compat_cov_gender"])
def test_host_numerics_paths_byte_identical(stratified_cohort, tmp_path, variant):
    kw = {"compat": dict(compat_popstrat=True, seed=7),
          "compat_cov_gender": dict(compat_popstrat=True, threshold=1.0,
                                    **_cov_gender(stratified_cohort, tmp_path))
          }[variant]
    ours, ref = _both(stratified_cohort, tmp_path, **kw)
    names = ("control_kmers.fasta", "case_kmers.fasta")
    _same_bytes(ours, ref, names)
    assert sum((ref / n).stat().st_size for n in names) > 0
    _same_bytes(ours / "popstrat", ref / "popstrat", ARTIFACTS)


def test_cli_flags_reach_the_corrector(stratified_cohort, tmp_path, caplog,
                                      monkeypatch):
    """The popstrat flags through the port's CLI; --model drops popstrat."""
    _out, run_dir, nc, nk = stratified_cohort
    files = _cov_gender(stratified_cohort, tmp_path)
    args = ["diff", "--km-run-dir", run_dir, "-1", str(nc), "-2", str(nk),
            "-s", str(THRESHOLD), "--cutoff", "1", "-c", "disabled",
            "--pop-correction", "--kmer-pca", "0.05", "--n-pc", "3",
            "--ploidy", "1", "--stand", "--covariates", files["covariates"],
            "--gender", files["gender"], "--threads", "2"]
    assert torch_main([*args, "--output-dir", str(tmp_path / "t")],
                      device="cpu") == 0
    assert jax_main([*args, "--output-dir", str(tmp_path / "j"),
                     "--devices", "1"]) == 0
    _same_bytes(tmp_path / "t" / "popstrat", tmp_path / "j" / "popstrat",
                ARTIFACTS[:-1])
    fit = np.load(tmp_path / "t" / "popstrat" / "null_fit.npz")
    assert fit["null_features"].shape == (nc + nk, 1 + 3 + 1 + 1 + 1)
    _close_fasta(tmp_path / "t", tmp_path / "j", min_kmers=1)
    # a custom model drops popstrat (with a warning), as in the JAX package
    plugin = str(pathlib.Path(__file__).resolve().parents[1] / "kmdiff_tpu_torch"
                 / "examples" / "plugins" / "fold_change_model.py")
    monkeypatch.setattr(logging.getLogger("kmdiff"), "propagate", True)
    with caplog.at_level(logging.WARNING, logger="kmdiff"):
        assert torch_main([*args, "--output-dir", str(tmp_path / "m"),
                           "--model", plugin], device="cpu") == 0
    assert any("stratification correction disabled" in r.message
               for r in caplog.records)
    assert not (tmp_path / "m" / "popstrat").exists()
    with open(tmp_path / "m" / "options.json") as f:
        assert json.load(f)["pop_correction"] is False


def test_resume_uses_corrected_spills(stratified_cohort, tmp_path):
    """A rerun with another correction reads the popstrat spills (not the
    merge's), and a third with the first's options writes its FASTA again."""
    def run(correction):
        return torch_diff(_opts(stratified_cohort, tmp_path, keep_tmp=True,
                                correction=correction), CPU)

    names = ("control_kmers.fasta", "case_kmers.fasta")
    run(CorrectionType.NOTHING)
    first = {n: (tmp_path / n).read_bytes() for n in names}
    assert _pvals(tmp_path)
    spill = tmp_path / "partitions" / "p0_popstrat_uncorrected"
    t0 = os.stat(spill).st_mtime_ns
    res = run(CorrectionType.BONFERRONI)
    assert res["control"] + res["case"] < len(_pvals_of(first))
    run(CorrectionType.NOTHING)
    assert os.stat(spill).st_mtime_ns == t0, "the popstrat stage must be skipped"
    # the corrected p-values again, not the merge's raw ones
    for n in names:
        assert (tmp_path / n).read_bytes() == first[n], n


def _pvals_of(fastas):
    return [line for data in fastas.values() for line in data.splitlines()
            if line.startswith(b">")]


def _blocks(rng, n, sizes):
    return [KmerSignBlock(
        rng.integers(0, 2**62, (B, 1)).astype(np.uint64),
        np.full(B, 1e-4), np.ones(B, np.int8), np.zeros(B), np.zeros(B),
        rng.integers(0, 40, (B, n)).astype(np.float64)) for B in sizes]


def _write_geno(pop_dir, n, seed, rows):
    rng = np.random.default_rng(seed)
    geno = (rng.random((rows, n)) < 0.4).astype(int)
    with open(pop_dir / "gwas_eigenstratX.geno", "w") as f:
        for row in geno:
            f.write("\t".join(map(str, row)) + "\t\n")


def test_load_corrector_reads_a_jax_null_fit(stratified_cohort, tmp_path):
    _out, run_dir, nc, nk = stratified_cohort
    n = nc + nk
    opt = DiffOptions(kmtricks_dir=run_dir, nb_controls=nc, nb_cases=nk, npc=2)
    config = read_config(run_dir)
    pop_dir = tmp_path / "pop"
    pop_dir.mkdir()
    _write_geno(pop_dir, n, 3, 300)
    jpop.fit_corrector(opt, config, str(pop_dir))  # writes null_fit.npz
    ref = jpop.load_corrector(opt, config, str(pop_dir))
    ours = tpop.load_corrector(opt, config, str(pop_dir), CPU)
    np.testing.assert_array_equal(ours.null_features, ref.null_features)
    np.testing.assert_array_equal(ours.alt_features, ref.alt_features)
    np.testing.assert_array_equal(ours.null_model, ref.null_model)
    assert ours.null_loglik == ref.null_loglik
    # every sample of this cohort has the same total, a constant column
    # that makes every design singular (each fit freezes at its starting
    # weights); distinct totals make the alt fits live
    totals = np.random.default_rng(2).uniform(2000.0, 2800.0, n)
    for corr in (ours, ref):
        corr.alt_features = corr.alt_features.copy()
        corr.alt_features[:, -2] = totals
    (b1,) = _blocks(np.random.default_rng(11), n, [64])
    (b2,) = _blocks(np.random.default_rng(11), n, [64])
    ref.correct_block(b1)
    ours.correct_block(b2)
    assert (b1.pvalues < 0.5).sum() > 10
    np.testing.assert_allclose(b2.pvalues, b1.pvalues, rtol=1e-2)


def test_pipelined_drain_matches_serial(stratified_cohort, tmp_path):
    _out, run_dir, nc, nk = stratified_cohort
    n = nc + nk
    opt = DiffOptions(kmtricks_dir=run_dir, nb_controls=nc, nb_cases=nk, npc=2)
    config = read_config(run_dir)
    pop_dir = tmp_path / "pop"
    pop_dir.mkdir()
    _write_geno(pop_dir, n, 5, 200)
    corr = tpop.fit_corrector(opt, config, str(pop_dir), CPU)
    assert isinstance(corr, tpop.PopStratCorrector)

    def run(mode):
        d = tmp_path / mode
        d.mkdir()
        pairs = []
        for p in range(3):
            src = str(d / f"p{p}_uncorrected")
            acc = FileAccumulator(src, config.kmer_size, read=False,
                                  delete_on_destroy=False, nb_samples=n)
            rng = np.random.default_rng(100 + p)
            for block in _blocks(rng, n, rng.integers(5, 60, p + 1)):
                acc.push_block(block)
            acc.finish()
            pairs.append((FileAccumulator(src, config.kmer_size, read=True,
                                          nb_samples=n),
                          FileAccumulator(str(d / f"p{p}_pop"), config.kmer_size,
                                          read=False, nb_samples=n)))
        if mode == "serial":
            for acc, pacc in pairs:
                tpop.correct_partition(corr, acc, pacc)
        else:
            tpop.correct_partitions_pipelined(corr, pairs)
        return [(d / f"p{p}_pop").read_bytes() for p in range(3)]

    for a, b in zip(run("serial"), run("pipelined")):
        assert a == b and len(a) > 0


def test_run_popstrat_matches_diff_and_jax_geno(stratified_cohort, tmp_path,
                                                monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("the fused path fell back to the standard flow")

    monkeypatch.setattr(jrun, "_standard_flow", boom)
    monkeypatch.setattr(trun, "_standard_flow", boom)
    monkeypatch.setattr(jfused, "CHUNK_ROWS", 1 << 15)
    root, run_dir, nc, nk = stratified_cohort
    flags = ["-1", str(nc), "-2", str(nk), "-s", str(THRESHOLD), "--cutoff",
             "1", "-c", "disabled", "--pop-correction", "--kmer-pca", "0.05",
             "--save-sk", "--threads", "2"]
    run_flags = ["run", "--file", os.path.join(root, "fof.txt"), "-k", "21",
                 "--nb-partitions", "4", *flags]
    timings = {}
    args = parse_args([*run_flags, "-d", str(tmp_path / "tk"), "-o",
                       str(tmp_path / "t")])
    trun.main_run(count_options(args), diff_options(args), CPU, timings=timings)
    assert {"merge", "pca", "null_fit", "alt_fits"} <= set(timings)
    assert torch_main(["diff", "--km-run-dir", run_dir, *flags,
                       "--output-dir", str(tmp_path / "d")], device="cpu") == 0
    assert jax_main([*run_flags, "-d", str(tmp_path / "jk"), "-o",
                     str(tmp_path / "j"), "--devices", "1"]) == 0
    names = ("control_kmers.fasta", "case_kmers.fasta")
    _same_bytes(tmp_path / "t", tmp_path / "d", names)
    assert sum((tmp_path / "t" / n).stat().st_size for n in names) > 0
    pop = "popstrat"
    _same_bytes(tmp_path / "t" / pop, tmp_path / "j" / pop,
                ("gwas_eigenstratX.geno", "pcs.evec"))
    # diff adds the geno rows partition by partition, run in key order:
    # the same rows, the same PCs
    rows = [sorted((p / pop / "gwas_eigenstratX.geno").read_text().splitlines())
            for p in (tmp_path / "t", tmp_path / "d")]
    assert rows[0] == rows[1]
    _same_bytes(tmp_path / "t" / pop, tmp_path / "d" / pop, ("pcs.evec",))
    mats = tmp_path / "t" / "positive_kmer_matrix" / "matrices"
    _same_bytes(mats, tmp_path / "d" / "positive_kmer_matrix" / "matrices",
                sorted(os.listdir(mats)))


@pytest.fixture(scope="module")
def unequal_cohort(tmp_path_factory):
    """The stratified cohort of tests/test_popstrat.py (the same generator
    and seed), but sample i draws 40 + 5 ((5 i) mod 12) reads: the
    per-sample totals differ, so the totals column is no constant, the
    designs are not singular and the IRLS fits iterate. The read counts
    are interleaved between controls and cases, since totals that grew
    with i would separate the labels and leave no null fit with a
    maximum."""
    from kmdiff_tpu.cmd.count import main_count
    from kmdiff_tpu.cmd.options import CountOptions

    out = tmp_path_factory.mktemp("unequal")
    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))
    shared = ["".join(rng.choice(bases, 60)) for _ in range(30)]
    pop_a = ["".join(rng.choice(bases, 60)) for _ in range(20)]
    pop_b = ["".join(rng.choice(bases, 60)) for _ in range(20)]
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
                            kmer_size=21, hard_min=1, nb_partitions=4,
                            nb_threads=2))
    return str(out), str(run_dir), nc, nk


@pytest.mark.parametrize("command", ["diff", "run"])
def test_unequal_totals_popstrat_matches_jax(unequal_cohort, tmp_path,
                                             monkeypatch, command):
    """Live IRLS fits: the port's popstrat `diff` (IRLS null fit) and
    `run --pop-correction` against the JAX package's, under the 1% rule,
    with at least one alt fit taking more than one iteration."""
    root, _run_dir, nc, nk = unequal_cohort
    alt_iters = []
    real_irls = tpop.irls

    def spy(X, last, *a, **kw):
        out = real_irls(X, last, *a, **kw)
        if last is not None:
            alt_iters.append(int(out[2].max()))
        return out

    monkeypatch.setattr(tpop, "irls", spy)
    if command == "diff":
        ours, ref = _both(unequal_cohort, tmp_path)
    else:
        def boom(*_a, **_k):
            raise AssertionError("the fused path fell back to the standard flow")

        monkeypatch.setattr(jrun, "_standard_flow", boom)
        monkeypatch.setattr(trun, "_standard_flow", boom)
        flags = ["run", "--file", os.path.join(root, "fof.txt"), "-k", "21",
                 "--nb-partitions", "4", "-1", str(nc), "-2", str(nk), "-s",
                 str(THRESHOLD), "--cutoff", "1", "-c", "disabled",
                 "--pop-correction", "--kmer-pca", "0.05", "--threads", "2"]
        ours, ref = tmp_path / "t", tmp_path / "j"
        assert torch_main([*flags, "-d", str(tmp_path / "tk"), "-o", str(ours)],
                          device="cpu") == 0
        assert jax_main([*flags, "-d", str(tmp_path / "jk"), "-o", str(ref),
                         "--devices", "1"]) == 0
    _same_bytes(ours / "popstrat", ref / "popstrat", ARTIFACTS[:-1])
    _close_fasta(ours, ref)
    assert alt_iters and max(alt_iters) > 1



def test_matrix_path_rows_geno_and_save_sk_match_jax(tmp_path):
    """A prebuilt count matrix through the port's and the JAX package's
    process_matrix with popstrat's count rows and geno sampler and with
    --save-sk: the same survivors with their rows, the same geno rows and
    a byte-identical survivor matrix."""
    from kmdiff_tpu.core.model import PoissonLikelihood
    from kmdiff_tpu.io.accumulator import VectorAccumulator
    from kmdiff_tpu.io.kmtricks import write_matrix_file
    from kmdiff_tpu.pipeline.merge import PartitionProcessor as JaxProcessor
    from kmdiff_tpu_torch.core.model import PoissonLikelihood as TPoissonLikelihood
    from kmdiff_tpu_torch.pipeline.merge import PartitionProcessor

    rng = np.random.default_rng(21)
    U, nc, nk = 3000, 4, 4
    kmers = np.unique(rng.integers(0, 2**62, U, dtype=np.uint64)).reshape(-1, 1)
    counts = rng.integers(0, 30, (len(kmers), nc + nk)).astype(np.uint32)
    counts[:300, :nc] *= 9
    path = str(tmp_path / "matrix_2.count.lz4")
    write_matrix_file(path, kmers, counts, 31, 2)
    model = PoissonLikelihood(nc, nk, [10**6] * nc, [10**6] * nk)
    tmodel = TPoissonLikelihood(nc, nk, [10**6] * nc, [10**6] * nk)
    outs = []
    for name, make in (("t", lambda **kw: PartitionProcessor(tmodel, nc, nk, 1e-3,
                                                            CPU, **kw)),
                       ("j", lambda **kw: JaxProcessor(model, nc, nk, 1e-3, **kw))):
        save = tmp_path / name
        save.mkdir()
        sampler = jpop.GenoSampler(str(save), 0.2, 3, nc + nk)
        acc = VectorAccumulator()
        make(keep_counts=True, sampler=sampler,
             save_matrix_path=str(save)).process_matrix(2, path, acc)
        outs.append((KmerSignBlock.concat(list(acc.blocks())), sampler._rows[2],
                     (save / "matrix_2.count.lz4").read_bytes()))
    (got, g_geno, g_mat), (want, w_geno, w_mat) = outs
    assert len(want) > 100 and len(w_geno) > 300
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.pvalues, want.pvalues)
    np.testing.assert_array_equal(got.counts_ratio, want.counts_ratio)
    np.testing.assert_array_equal(g_geno, w_geno)
    assert g_mat == w_mat


def test_knife_edges_compare_and_describe(stratified_cohort, tmp_path):
    """tools.knife_edges, which chip_smoke.py's popstrat checks use: two
    CPU runs agree, every refit gives its FASTA, and describe reports a few
    planted k-mers, its refits equal to compare's."""
    from kmdiff_tpu_torch.tools import knife_edges

    _root, run_dir, nc, nk = stratified_cohort
    flags = ["diff", "--km-run-dir", str(run_dir), "-1", str(nc), "-2", str(nk),
             "-s", str(THRESHOLD), "--cutoff", "1", "-c", "disabled",
             "--pop-correction", "--kmer-pca", "0.05", "--n-pc", "2", "--keep-tmp"]
    outs = [str(tmp_path / side) for side in ("a", "b")]
    for out in outs:
        torch_main([*flags, "--output-dir", out], device="cpu")
    opt = diff_options(parse_args(flags))
    cmp = knife_edges.compare(CPU, opt, str(run_dir), *outs, THRESHOLD, nc + nk)
    assert cmp["only"] == set() and len(cmp["both"]) >= 10 and cmp["rel"] == 0.0
    assert cmp["sig"]["gpu"] == set(cmp["got"]) == cmp["sig"]["cpu"]
    assert len(cmp["sig"]["f64"] ^ cmp["sig"]["gpu"]) <= 2
    assert knife_edges.describe(CPU, opt, str(run_dir), *outs, cmp,
                                THRESHOLD) == "no k-mer in one FASTA only"
    cmp["only"] = set(sorted(cmp["both"])[:5])
    why = knife_edges.describe(CPU, opt, str(run_dir), *outs, cmp, THRESHOLD)
    assert why.startswith("5 k-mers in one FASTA only are ")
    for side in ("K-IRLS", "twin (CPU)", "twin (card, f32)"):
        assert f"{side} significant on " in why
        assert "f64 sides with it on " in why
    # a line a design: each side's p / alpha, and the f64 fit run on past
    # its stopping rule
    head, *designs = why.split("\n")
    n_designs = int(head.split(" are ")[1].split(" distinct")[0])
    assert len(designs) == n_designs >= 1
    for line in designs:
        assert line.startswith("  design of k-mer row ")
        assert "K-IRLS p/alpha " in line and "f64 p/alpha " in line
        assert "run on with no tolerance: p/alpha " in line
