"""ecoli-k31.pop: the popstrat reference agrees with the port's CPU path on a
small cohort, its likelihood ratio does not see how the PCs are turned, the
existing mixes run as before, and the controls and four planted faults
read not correct."""

import json

import numpy as np
import pytest
import torch

from kbench import cohort, compare, control, reference, run, traffic
from kbench.reference import count, popstrat
from kbench.tests.helpers import pop_config, pop_run, tiny_run

CONFIG = run.load_json("configs", "ecoli-k31.json")


def test_pop_reference_matches_the_port_on_cpu():
    res = pop_run(seed=2**31 + 23, trace=True)
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["pop_pval_off"]["value"] == 0
    assert checks["missing"]["value"] == checks["extra"]["value"] == 0
    assert checks["ref_hits"]["value"] >= 300
    assert set(res["metrics"]) == {"pop_pca_s", "pop_alt_fits_s"}  # no card, no kernels


def test_the_pop_cell_resolves_by_name():
    """The cell reports job_s and setup_s, and with a trace its three
    popstrat metrics, each of whose readers finds nothing in an empty run
    and says so."""
    bench = run.load_bench(pending=True)
    assert "ecoli-k31.pop" not in {w["name"] for w in run.load_bench()["workloads"]}
    cell = next(w for w in bench["workloads"] if w["name"] == "ecoli-k31.pop")
    assert cell["config"] == "ecoli-k31-pop" and cell["chips"] == 1
    assert traffic.load(run.KBENCH, cell["traffic"])["command"] == "diff"
    assert [m["name"] for m in run.cell_metrics(bench, cell["name"], False)] == [
        "job_s", "setup_s"]
    pop = run.cell_metrics(bench, cell["name"], True)
    assert [m["name"] for m in pop] == ["pop_pca_s", "pop_alt_fits_s", "pop_kernel_s"]
    assert {m["layer"] for m in pop} == {"popstrat"}
    for m in pop:
        assert run.read_metric(m["name"], {"jobs": [], "trace": None}) is None
    # no other cell reports them
    for other in bench["workloads"]:
        if other is not cell:
            names = {m["name"] for m in run.cell_metrics(bench, other["name"], True)}
            assert not names & {m["name"] for m in pop}


def test_pending_entries_keep_the_format(monkeypatch):
    """BENCHMARK.json with kbench/pending.json's entries added keeps every
    rule that BENCHMARK.json is held to."""
    from kbench.tests import test_kbench_benchmark as fmt

    monkeypatch.setattr(fmt, "BENCH", run.load_bench(pending=True))
    fmt.test_keys_and_sizes()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        fmt.test_names_units_and_lines(group)
    fmt.test_metrics_bounds_and_sources()
    fmt.test_cell_resolves_by_name("ecoli-k31.pop")
    fmt.test_every_config_is_used_and_four_chip_cells_are_few()


def test_lrt_unchanged_when_the_pcs_turn():
    g = torch.Generator().manual_seed(3)
    pcs = torch.randn(40, 2, generator=g, dtype=torch.float64)
    totals = 1e7 + 1e3 * torch.randn(40, generator=g, dtype=torch.float64)
    ratios = torch.poisson(3 * torch.rand(64, 40, generator=g, dtype=torch.float64),
                           generator=g) / totals
    y = (torch.arange(40) < 20).double()
    p, _ = popstrat.logistic_lrt(pcs, totals, ratios, y)
    c, s = np.cos(0.7), np.sin(0.7)
    turn = torch.tensor([[c, -s], [s, c]], dtype=torch.float64)
    for other in (pcs @ turn, pcs * torch.tensor([-1.0, 1.0], dtype=torch.float64),
                  3 * pcs + 1):
        q, _ = popstrat.logistic_lrt(other, totals, ratios, y)
        assert torch.allclose(q, p, rtol=1e-7, atol=0)
    assert (p < 1).any() and (p < 1e-2).any()


def test_equal_totals_leave_the_lrt_defined():
    """A constant totals column lies in the intercept's span: the test is
    the one without it."""
    g = torch.Generator().manual_seed(4)
    pcs = torch.randn(40, 2, generator=g, dtype=torch.float64)
    ratios = torch.rand(16, 40, generator=g, dtype=torch.float64)
    y = (torch.arange(40) < 20).double()
    equal, _ = popstrat.logistic_lrt(pcs, torch.full((40,), 1e7, dtype=torch.float64),
                                        ratios, y)
    alone = popstrat.logistic_lrt(pcs, torch.ones(40, dtype=torch.float64), ratios, y)[0]
    assert torch.isfinite(equal).all() and torch.allclose(equal, alone, rtol=1e-9)


@pytest.mark.parametrize("k", [31, 63])
def test_sample_mask_is_the_ports_hash(k):
    from kmdiff_tpu_torch.pipeline.popstrat import sample_mask

    rng = np.random.default_rng(k)
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (200, 120))]
    keys, _ = count.count(count.canonical_keys(reads, k, "cpu"))
    raw = (keys.numpy() ^ np.int64(-(1 << 63))).view(np.uint64).T.copy()
    for seed in (0, 2**31 + 5):
        want = sample_mask(raw, 0.05, seed)
        assert (popstrat.sample_mask(keys, 0.05, seed).numpy() == want).all()
        assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("nw", [1, 2])
def test_lookup_finds_each_query(nw):
    rng = np.random.default_rng(nw)
    pool = torch.from_numpy(rng.integers(-2**62, 2**62, (nw, 500)))
    keys = pool[:, count.sort_keys(pool)][:, ::2]
    counts = torch.arange(keys.shape[1]) + 1
    query = pool[:, count.sort_keys(pool)][:, 100:400]
    got = popstrat.lookup(keys, counts, query)
    have = {tuple(keys[:, i].tolist()): int(counts[i]) for i in range(keys.shape[1])}
    assert got.tolist() == [have.get(tuple(query[:, i].tolist()), 0)
                            for i in range(query.shape[1])]


def test_bh_walk_stops_at_the_first_rejection():
    p = torch.tensor([1e-9, 4e-9, 1e-3, 2e-9, 9e-9], dtype=torch.float64)
    # ranks 1-4 against 1e-9, 2e-9, 3e-9, 4e-9 (alpha 0.1, 1e8 tested):
    # 1e-9 fails (not <), so nothing passes; with p / 2 the first three do
    assert not popstrat.accept(p, "benjamini", 0.1, 10**8).any()
    assert popstrat.accept(p / 2, "benjamini", 0.1, 10**8).tolist() == [
        True, True, False, True, False]


@pytest.mark.parametrize("correction", ["disabled", "bonferroni", "benjamini"])
def test_corrections_are_the_ports(correction):
    from kmdiff_tpu_torch.core.corrector import correction_type_from_str
    from kmdiff_tpu_torch.ops.correct import correction_mask_sorted

    g = torch.Generator().manual_seed(5)
    p = torch.cat([10 ** (-12 * torch.rand(300, generator=g, dtype=torch.float64)),
                   torch.full((20,), 1e-9, dtype=torch.float64)])
    for alpha, n in ((0.05, 10**6), (0.05, 10**9), (0.5, 10**10)):
        order = np.argsort(p.numpy(), kind="stable")
        want = np.zeros(len(p), dtype=bool)
        want[order] = correction_mask_sorted(p.numpy()[order],
                                             correction_type_from_str(correction), alpha, n)
        got = popstrat.accept(p, correction, alpha, n).numpy()
        assert (got == want).all()
        assert 0 < want.sum() or correction != "disabled"


def test_existing_mixes_keep_their_argv():
    fof, rd, od = "c/fof.txt", "w/run", "w/out"
    common = ["--threads", "4", "--devices", "1"]
    count_flags = ["--kmer-size", "31", "--hard-min", "1", "--nb-partitions", "4"]
    diff_flags = ["-1", "20", "-2", "20", "--significance", "0.05", "--cutoff", "100000",
                  "--correction", "bonferroni"]
    run_mix = traffic.load(run.KBENCH, "run")
    diff_mix = traffic.load(run.KBENCH, "diff")
    assert "analysis" not in run_mix and "analysis" not in diff_mix
    for analysis in (None, {}, run_mix.get("analysis")):
        assert traffic.argv(CONFIG, "run", run_mix["flags"], fof, rd, od, analysis) == [
            "run", "--file", fof, "--run-dir", rd, "--output-dir", od, *count_flags,
            *diff_flags, *common, "--no-count-files"]
        assert traffic.argv(CONFIG, "diff", diff_mix["flags"], fof, rd, od, analysis) == [
            "diff", "--km-run-dir", rd, "--output-dir", od, *diff_flags, *common]
        assert traffic.argv(CONFIG, "count", [], fof, rd, "", analysis) == [
            "count", "--file", fof, "--run-dir", rd, *count_flags, *common]
    assert traffic.overlay(CONFIG, run_mix) == CONFIG == traffic.overlay(CONFIG, diff_mix)


def test_the_pop_mix_sets_the_analysis(tmp_path):
    """The configuration states hard-min and the correction; the mix,
    popstrat's settings alone: a mix that restates the analysis is
    refused."""
    from kmdiff_tpu_torch import cli

    config = run.load_json("configs", "ecoli-k31-pop.json")
    mix = traffic.load(run.KBENCH, "pop")
    assert set(mix["analysis"]) == set(traffic.ANALYSIS_FLAGS)
    a = cli.parse_args(traffic.argv(config, "diff", mix["flags"], "f", "r", "o",
                                    mix["analysis"]))
    assert (a.correction, a.pop_correction, a.kmer_pca, a.n_pc, a.ploidy,
            a.random_seed) == ("benjamini", True, 0.001, 2, 2, popstrat.RANDOM_SEED)
    c = cli.parse_args(traffic.argv(config, "count", [], "f", "r", "", mix["analysis"]))
    assert c.hard_min == 2
    assert traffic.argv(config, "count", [], "f", "r", "", mix["analysis"]) == \
        traffic.argv(config, "count", [], "f", "r", "")
    assert traffic.overlay(config, mix) == {**config, **mix["analysis"]}
    (tmp_path / "traffic").mkdir()
    for key, value in (("nope", 1), ("hard_min", 1), ("correction", "disabled"),
                       ("ploidy", 2), ("random_seed", 0)):
        (tmp_path / "traffic" / "bad.json").write_text(
            json.dumps(mix | {"analysis": {key: value}}))
        with pytest.raises(ValueError, match=key):
            traffic.load(str(tmp_path), "bad")


def test_a_poisson_run_keeps_its_checks():
    res = tiny_run(seed=2**31 + 41)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == [
        "hist_off", "tested_off", "missing", "extra", "wrong_file", "means_off",
        "pval_off", "jobs_failed", "ref_hits", "procs_left", "threads_left"]
    assert {k: c.get("limit", c.get("min")) for k, c in res["checks"].items()} == {
        **dict.fromkeys(compare.LIMITS, 0), "jobs_failed": 0, "ref_hits": run.MIN_HITS,
        "procs_left": 0, "threads_left": 0}


def test_pop_controls_fail(tmp_path):
    cfg = traffic.overlay(pop_config(), traffic.load(run.KBENCH, "pop"))
    co = cohort.make(cfg, 2**31 + 29, str(tmp_path))
    counts = reference.count_cohort(co, 31, cfg["hard_min"], torch.device("cpu"),
                                    keep_samples=True)
    for name, numbers in control.pop_control_numbers(counts, cfg).items():
        assert compare.failures(numbers | {"hist_off": 0, "tested_off": 0},
                                compare.POP_LIMITS), (name, numbers)
        assert numbers["pop_pval_off"] > 0, (name, numbers)


def _uncorrected(monkeypatch):
    """The merge's Poisson p-values written where popstrat's should be."""
    from kmdiff_tpu_torch.pipeline import popstrat as port

    monkeypatch.setattr(port, "do_pop", lambda opt, config, accs, *a, **k: accs)


def _zeroed_pcs(monkeypatch):
    from kmdiff_tpu_torch.pipeline import popstrat as port

    orig = port.eigenstrat_pca

    def eigenstrat_pca(*a, **k):
        z, evals = orig(*a, **k)
        return np.zeros_like(z), evals
    monkeypatch.setattr(port, "eigenstrat_pca", eigenstrat_pca)


def _wrong_pcs(monkeypatch):
    """Nonzero, unit-norm, wrong PCs: eigenvectors 3 and 4 in place of 1
    and 2."""
    from kmdiff_tpu_torch.pipeline import popstrat as port

    orig = port.eigenstrat_pca

    def eigenstrat_pca(*a, **k):
        z, evals = orig(*a, **k)
        return np.roll(z, -2, axis=1), evals
    monkeypatch.setattr(port, "eigenstrat_pca", eigenstrat_pca)


def _alt_fits_one_iteration(monkeypatch):
    from kmdiff_tpu_torch.pipeline import popstrat as port

    orig = port.irls

    def irls(X, last, y, max_iters=500, *a):
        return orig(X, last, y, 1 if last is not None else max_iters, *a)
    monkeypatch.setattr(port, "irls", irls)


POP_FAULTS = {"uncorrected": (_uncorrected, "pop_pval_off"),
              # zero columns: the port's fits freeze at their start, none written
              "zeroed_pcs": (_zeroed_pcs, "missing"),
              # fits that converge, on the wrong PCs: the p-values move
              "wrong_pcs": (_wrong_pcs, "pop_pval_off"),
              # every alt fit stays at its start, below the null: p = 1, none written
              "alt_fits_one_iteration": (_alt_fits_one_iteration, "missing")}


@pytest.mark.parametrize("fault", sorted(POP_FAULTS))
def test_pop_fault_is_not_correct(monkeypatch, fault):
    plant, check = POP_FAULTS[fault]
    plant(monkeypatch)
    res = pop_run(seed=2**31 + 61)
    assert not res["correct"]
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]
