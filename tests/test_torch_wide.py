"""The port's wide group sums (cohorts whose k-mer mass reaches 2^31) on the
CPU, where every kernel wrapper takes its plain twin, against the JAX
package and exact numpy int64 arithmetic.

- The four-sample files of tests/test_merge.py (counts to 3.1e9, group sums
  past 2^32) through both packages' PartitionProcessor.process_files with
  count rows, and a matrix file with counts >= 2^31 through process_matrix
  with --save-sk: k-mers, p-values, signs, means, count rows and the
  survivors' matrices exactly equal, and equal to numpy's int64 sums.
- LrtParams.wide_sums forced true in both packages on the stratified cohort
  of tests/test_popstrat.py (`diff`, `diff --pop-correction --save-sk`,
  `run`, `run --pop-correction`): the port's outputs byte-identical to its
  narrow ones and to the JAX package's forced-wide ones, but for popstrat's
  FASTA against the JAX package, held as tests/test_torch_popstrat.py holds
  it (both packages fit the alt models in f32 with other summation orders:
  the same k-mers but within 1% of alpha, p-values within 1% relative).
- The plain twins: K-RUN's full form against numpy int64 sums at counts
  near 2^32; K-ROWS's raw rows and presence at 2^31 and 2^32 - 1; K-LRT on
  int64 sums bit-identical to the JAX wide merge's f32 hi * 65536 + lo
  filter for S in {2, 20, 256} (where a half-sum stays below 2^24), and the
  whole wide merge against the JAX kernel there; at S = 300 the outputs
  after the f64 rescore equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_popstrat import stratified_cohort  # noqa: F401  (fixture)

import kmdiff_tpu.cmd.run as jrun
import kmdiff_tpu.pipeline.fused as jfused
import kmdiff_tpu.pipeline.merge as jmerge_pipe
from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.core.model import PoissonLikelihood
from kmdiff_tpu.io.accumulator import KmerSignBlock, VectorAccumulator
from kmdiff_tpu.io.fasta import read_fasta
from kmdiff_tpu.io.kmtricks import write_kmer_file
from kmdiff_tpu.ops import lrt as jlrt
from kmdiff_tpu.ops import merge_dev as jmerge
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.cmd import run as trun
from kmdiff_tpu_torch.core.model import PoissonLikelihood as TPoissonLikelihood
from kmdiff_tpu_torch.io.kmtricks import write_matrix_file
from kmdiff_tpu_torch.ops import codec, lrt, merge_dev
from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter
from kmdiff_tpu_torch.pipeline import count as tcount
from kmdiff_tpu_torch.pipeline import merge as tmerge

CPU = torch.device("cpu")

#: tests/test_merge.py::test_wide_sums_counts_near_u32_max's cohort
WIDE_KMERS = np.array([[5], [9], [123456]], dtype=np.uint64)
WIDE_COUNTS = [
    np.array([2_000_000_000, 1_500_000_000, 7], dtype=np.uint32),
    np.array([1_900_000_000, 1_600_000_000, 5], dtype=np.uint32),
    np.array([400_000_000, 3_100_000_000, 6], dtype=np.uint32),
    np.array([300_000_000, 3_000_000_000, 8], dtype=np.uint32),
]


def _block(acc):
    return KmerSignBlock.concat(list(acc.blocks()))


def _same_blocks(got, want, rows=True):
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.pvalues, want.pvalues)
    np.testing.assert_array_equal(got.signs, want.signs)
    np.testing.assert_array_equal(got.mean_control, want.mean_control)
    np.testing.assert_array_equal(got.mean_case, want.mean_case)
    if rows:
        np.testing.assert_array_equal(got.counts_ratio, want.counts_ratio)


def _models(per_sample, nbc):
    tot = [int(c.astype(np.int64).sum()) for c in per_sample]
    args = (nbc, len(tot) - nbc, tot[:nbc], tot[nbc:])
    return PoissonLikelihood(*args), TPoissonLikelihood(*args)


def _numpy_scores(model, per_sample, nbc):
    s_c = sum(c.astype(np.int64) for c in per_sample[:nbc])
    s_k = sum(c.astype(np.int64) for c in per_sample[nbc:])
    return model.process_sums(s_c, s_k)


def test_count_files_match_jax_and_int64(tmp_path):
    paths = []
    for i, cts in enumerate(WIDE_COUNTS):
        path = str(tmp_path / f"s{i}.kmer.lz4")
        write_kmer_file(path, WIDE_KMERS, cts, 20, sample_idx=i, partition=0,
                        count_bytes=4)
        paths.append(path)
    jmodel, tmodel = _models(WIDE_COUNTS, 2)
    ours = tmerge.PartitionProcessor(tmodel, 2, 2, 1.0, CPU, keep_counts=True)
    assert ours.params.wide_sums and ours.full
    acc, ref_acc = VectorAccumulator(), VectorAccumulator()
    res = ours.process_files(0, paths, acc)
    ref = jmerge_pipe.PartitionProcessor(jmodel, 2, 2, threshold=1.0,
                                         keep_counts=True).process_files(0, paths, ref_acc)
    assert (res.total_kmers, res.nb_sign, res.sign_controls) == (
        ref.total_kmers, ref.nb_sign, ref.sign_controls) == (3, 3, ref.sign_controls)
    got = _block(acc)
    _same_blocks(got, _block(ref_acc))
    pv, sg, mc, mk = _numpy_scores(jmodel, WIDE_COUNTS, 2)
    np.testing.assert_array_equal(got.kmers, WIDE_KMERS)
    np.testing.assert_array_equal(got.pvalues, pv)
    np.testing.assert_array_equal(got.signs, sg)
    np.testing.assert_array_equal(got.mean_control, mc)
    np.testing.assert_array_equal(got.mean_case, mk)
    np.testing.assert_array_equal(got.counts_ratio,
                                  np.stack(WIDE_COUNTS, 1).astype(np.float64))


def test_matrix_matches_jax(tmp_path):
    rng = np.random.default_rng(21)
    S, nbc, B = 6, 3, 500
    kmers = np.sort(rng.choice(2**40, B, replace=False)).astype(np.uint64).reshape(-1, 1)
    counts = rng.integers(0, 400, (B, S)).astype(np.uint32)
    counts[::5] = rng.integers(2**31, 2**32, (len(counts[::5]), S), dtype=np.int64)
    counts[1::5, :nbc] *= 30
    path = str(tmp_path / "matrix_0.count.lz4")
    write_matrix_file(path, kmers, counts, 31, 0)
    per_sample = list(counts.T)
    jmodel, tmodel = _models(per_sample, nbc)
    outs = {}
    for name, make in (
            ("t", lambda d: tmerge.PartitionProcessor(tmodel, nbc, S - nbc, 0.05, CPU,
                                                      keep_counts=True,
                                                      save_matrix_path=d)),
            ("j", lambda d: jmerge_pipe.PartitionProcessor(jmodel, nbc, S - nbc, 0.05,
                                                           keep_counts=True,
                                                           save_matrix_path=d))):
        d = tmp_path / name
        d.mkdir()
        proc = make(str(d))
        assert proc.params.wide_sums
        acc = VectorAccumulator()
        res = proc.process_matrix(0, path, acc)
        outs[name] = (res, _block(acc), (d / "matrix_0.count.lz4").read_bytes())
    (res, got, mat), (ref, want, ref_mat) = outs["t"], outs["j"]
    assert (res.total_kmers, res.nb_sign, res.sign_controls) == (
        ref.total_kmers, ref.nb_sign, ref.sign_controls)
    assert res.nb_sign > 0 and mat == ref_mat
    assert (got.counts_ratio >= 2**31).any()
    _same_blocks(got, want)
    pv = _numpy_scores(jmodel, per_sample, nbc)[0]
    np.testing.assert_array_equal(got.pvalues, pv[pv <= 0.05])


# -- forced wide on a small cohort ---------------------------------------------

THRESHOLD = 0.2
NAMES = ("control_kmers.fasta", "case_kmers.fasta")
ARTIFACTS = ("gwas_eigenstratX.geno", "gwas_eigenstratX.snp",
             "gwas_eigenstratX.ind", "gwas_eigenstratX.total", "pcs.evec")


def _force_wide(monkeypatch, port: bool, jax: bool):
    """LrtParams.wide_sums true in this process, in either package."""
    for on, mod in ((port, tmerge), (jax, jmerge_pipe)):
        if on:
            base = mod.LrtParams

            class Wide(base):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    self.wide_sums = True

            monkeypatch.setattr(mod, "LrtParams", Wide)


def _packed_merge(*_a, **_k):
    raise AssertionError("a wide cohort took the packed merge")


def _spy_port_merges(monkeypatch):
    """Count the port's full merges; fail on a packed merge or a host group
    pre-sum."""
    calls = {"full": 0}
    full = merge_dev.merge_lrt_full

    def spy(*a, **k):
        calls["full"] += 1
        return full(*a, **k)

    monkeypatch.setattr(merge_dev, "merge_lrt_full", spy)
    monkeypatch.setattr(merge_dev, "merge_lrt", _packed_merge)
    monkeypatch.setattr(tcount, "_merge_streams", _packed_merge)
    return calls


def _pvals(out):
    ps = {}
    for cls in ("control", "case"):
        for name, seq in read_fasta(os.path.join(out, f"{cls}_kmers.fasta")):
            ps[(cls, seq)] = float(name.split("pval=")[1].split("_")[0])
    return ps


def _close_fasta(ours, ref):
    got, want = _pvals(ours), _pvals(ref)
    assert len(want) >= 10
    near = {k for k, p in want.items() if abs(p - THRESHOLD) <= 0.01 * THRESHOLD}
    assert set(got) - near == set(want) - near
    for k in set(got) & set(want):
        assert got[k] == pytest.approx(want[k], rel=1e-2), k


def _same(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _command(cohort, variant, out, scratch):
    root, run_dir, nc, nk = cohort
    flags = ["-1", str(nc), "-2", str(nk), "-s", str(THRESHOLD), "--cutoff", "1",
             "-c", "disabled", "--threads", "2"]
    if "pop" in variant:
        flags += ["--pop-correction", "--kmer-pca", "0.05"]
    if variant == "diff_pop_save_sk":
        flags += ["--save-sk"]
    if variant.startswith("diff"):
        return ["diff", "--km-run-dir", run_dir, *flags, "--output-dir", str(out)]
    return ["run", "--file", os.path.join(root, "fof.txt"), "-k", "21",
            "--nb-partitions", "4", *flags, "-d", str(scratch), "-o", str(out)]


@pytest.mark.parametrize("variant", ["diff", "diff_pop_save_sk", "run", "run_pop"])
def test_forced_wide_matches_narrow_and_jax(stratified_cohort, tmp_path,
                                            monkeypatch, variant):
    def no_fallback(*_a, **_k):
        raise AssertionError("the fused path fell back to the standard flow")

    monkeypatch.setattr(jrun, "_standard_flow", no_fallback)
    monkeypatch.setattr(trun, "_standard_flow", no_fallback)
    monkeypatch.setattr(jfused, "CHUNK_ROWS", 1 << 15)
    narrow, wide, ref = tmp_path / "narrow", tmp_path / "wide", tmp_path / "jax"
    cmd = lambda out, d: _command(stratified_cohort, variant, out, tmp_path / d)  # noqa: E731
    assert torch_main(cmd(narrow, "kn"), device="cpu") == 0
    with monkeypatch.context() as m:
        _force_wide(m, port=True, jax=False)
        calls = _spy_port_merges(m)
        assert torch_main(cmd(wide, "kw"), device="cpu") == 0
        assert calls["full"] > 0
    with monkeypatch.context() as m:
        _force_wide(m, port=False, jax=True)
        m.setattr(jmerge, "build_triples_packed", _packed_merge)
        extra = ["--devices", "1"] if variant.startswith("run") else []
        assert jax_main([*cmd(ref, "kj"), *extra]) == 0
    _same(wide, narrow, NAMES)
    assert sum((wide / n).stat().st_size for n in NAMES) > 0
    if "pop" in variant:
        pop = "popstrat"
        _same(wide / pop, narrow / pop, ARTIFACTS)
        _same(wide / pop, ref / pop, ARTIFACTS)
        _close_fasta(wide, ref)
    else:
        _same(wide, ref, NAMES)
    if variant == "diff_pop_save_sk":
        mats = sorted(os.listdir(ref / "positive_kmer_matrix" / "matrices"))
        assert mats
        for other in (narrow, ref):
            _same(wide / "positive_kmer_matrix" / "matrices",
                  other / "positive_kmer_matrix" / "matrices", mats)


# -- the plain twins ---------------------------------------------------------------

def _streams(rng, S, n_pool=1500, per=600, wide_every=4):
    pool = np.unique(rng.integers(0, 2**62, n_pool, dtype=np.uint64) * 3)
    kmers, counts = [], []
    for s in range(S):
        take = np.sort(rng.choice(len(pool), min(per, len(pool)), replace=False))
        kmers.append(pool[take].reshape(-1, 1))
        c = rng.integers(1, 300, len(take)).astype(np.uint32)
        c[::wide_every] = rng.integers(2**31, 2**32, len(c[::wide_every]),
                                       dtype=np.int64).astype(np.uint32)
        if s < S // 2:
            c[1::7] *= 20
        counts.append(c)
    return kmers, counts


def _triples(kmers, counts):
    keys, count, sample, _n = merge_dev.build_triples(kmers, counts)
    return torch.from_numpy(keys), torch.from_numpy(count), torch.from_numpy(sample)


def test_run_encode_full_form_matches_numpy_int64():
    rng = np.random.default_rng(31)
    kmers, counts = _streams(rng, 20)
    keys, count, sample = _triples(kmers, counts)
    keys_s, perm = torch.sort(keys)
    raw = np.concatenate(counts).astype(np.int64)
    for nbc in (0, 7, 20):
        starts, run_keys, n_valid, sums = codec.run_encode(
            keys_s, perm, count, sample=sample, nb_controls=nbc)
        assert sums.dtype == torch.int64 and int(n_valid) == keys.numel()
        run_of = np.searchsorted(run_keys.numpy(), keys.numpy())
        is_ctrl = sample.numpy() < nbc
        want = np.zeros((run_keys.numel(), 2), np.int64)
        np.add.at(want, (run_of, np.where(is_ctrl, 0, 1)), raw)
        np.testing.assert_array_equal(sums.numpy(), want)
    assert int(sums.max()) >= 2**32


def test_run_rows_raw_counts_and_presence():
    keys = torch.tensor([1, 1, 1, 4, 4], dtype=torch.int64)
    keys_s, perm = torch.sort(keys, stable=True)
    count = torch.tensor([-(2**31), -1, 0, 5, -(2**31) + 3], dtype=torch.int32)
    sample = torch.tensor([0, 1, 2, 2, 0], dtype=torch.int16)
    starts, _k, n_valid, _ = codec.run_encode(keys_s)
    sel = torch.tensor([0, 1])
    rows = merge_dev.run_rows(starts, n_valid, sel, perm, count, sample, 3)
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  [[2**31, 2**32 - 1, 0], [2**31 + 3, 0, 5]])
    pres = merge_dev.run_rows(starts, n_valid, sel, perm, count, sample, 3,
                              presence=True)
    assert pres.tolist() == [[1, 1, 0], [1, 0, 1]]


def _jax_wide_keep(counts, nbc, params):
    """The JAX wide merge's filter (merge_dev.py:244-267) on [B, S] u32
    counts: per-group sums of each count's 16-bit halves, f32 hi * 65536 +
    lo, its LR and margin."""
    hi = (counts >> np.uint32(16)).astype(np.int32)
    lo = (counts & np.uint32(0xFFFF)).astype(np.int32)
    f = []
    for cols in (slice(0, nbc), slice(nbc, None)):
        h = jnp.asarray(hi[:, cols].sum(1, dtype=np.int32))
        low = jnp.asarray(lo[:, cols].sum(1, dtype=np.int32))
        f.append(h.astype(jnp.float32) * 65536.0 + low.astype(jnp.float32))
    f_c, f_k = f
    tot = f_c + f_k
    lr = jlrt._lr_from_sums(f_c, f_k, params.ratio_c, params.ratio_k)
    keep = lr + jlrt.MARGIN_PER_COUNT * tot + jlrt.MARGIN_ABS >= jnp.float32(params.lr_min)
    return np.asarray(keep), np.asarray(f_c), np.asarray(f_k)


@pytest.mark.parametrize("S", [2, 20, 256])
def test_lrt_filter_int64_bit_identical_to_jax_wide_filter(S):
    """Sums in the cohort's ratio (LR near 0, the margin decides), at random
    and past 2^32; the cut at the median of lr + margin, so that half the
    rows lie on each side, many near it. The f32 sums the filter sees are
    bit-identical (one rounding of the exact sum on both sides) and so are
    the keep masks; the LR itself is not compared, since XLA's and
    PyTorch's f32 logs may differ by an ulp."""
    rng = np.random.default_rng(S)
    B, nbc = 4096, S // 2
    counts = rng.integers(0, 2**32, (B, S), dtype=np.int64).astype(np.uint32)
    counts[::3] = rng.integers(0, 300, (len(counts[::3]), S)).astype(np.uint32)
    counts[1::3] = np.repeat(rng.integers(0, 2**32, (len(counts[1::3]), 1),
                                         dtype=np.int64), S, 1).astype(np.uint32)
    sums = np.stack([counts[:, :nbc].sum(1, dtype=np.int64),
                     counts[:, nbc:].sum(1, dtype=np.int64)], 1)
    probe = lrt.LrtParams(nbc, S - nbc, 10**9 * nbc, 10**9 * (S - nbc), 0.5)
    _k, lr0, _c, _s = lrt.lrt_filter_block(torch.from_numpy(sums), 1, probe.ratio_c,
                                           probe.ratio_k, 0.0)
    score = lr0.numpy() + lrt.MARGIN_PER_COUNT * sums.sum(1).astype(np.float32)
    params = lrt.LrtParams(nbc, S - nbc, 10**9 * nbc, 10**9 * (S - nbc), 0.5)
    params.lr_min = float(np.median(score))
    jparams = jlrt.LrtParams(nbc, S - nbc, 10**9 * nbc, 10**9 * (S - nbc), 0.5)
    jparams.lr_min = params.lr_min
    assert (params.ratio_c, params.ratio_k) == (jparams.ratio_c, jparams.ratio_k)
    keep = lrt_filter(torch.from_numpy(sums), 1, params.ratio_c, params.ratio_k,
                      params.lr_min, want_lr=False, want_sums=False)[0].numpy()
    want, f_c, f_k = _jax_wide_keep(counts, nbc, jparams)
    np.testing.assert_array_equal(torch.from_numpy(sums[:, 0]).to(torch.float32).numpy(), f_c)
    np.testing.assert_array_equal(torch.from_numpy(sums[:, 1]).to(torch.float32).numpy(), f_k)
    np.testing.assert_array_equal(keep, want)
    assert 0.3 < keep.mean() < 0.7


def _jax_full_merge(kmers, counts, nbc, params, wide):
    N = sum(len(k) for k in kmers)
    pad_to = 1 << (N - 1).bit_length()
    lanes, sample, count, _ = jmerge.build_triples(kmers, counts, pad_to)
    out = jmerge.merge_lrt_kernel(
        tuple(jnp.asarray(lane.copy()) for lane in lanes), jnp.asarray(sample.copy()),
        jnp.asarray(count.copy()), nbc, jnp.float32(params.ratio_c),
        jnp.float32(params.ratio_k), jnp.float32(params.lr_min), jnp.uint32(0),
        jnp.uint32(0), pad_to, pad_to, True, nb_samples=len(kmers),
        wide_sums=wide, packed_ctrl=False)
    nh = int(out["n_hits"])
    blob = np.asarray(out["hit_blob"])[:nh]
    lanes_h, s_c, s_k = jmerge_pipe.PartitionProcessor._unpack_blob(blob, 2, wide)
    return int(out["n_distinct"]), jmerge.lanes_to_words(lanes_h), s_c, s_k


@pytest.mark.parametrize("S", [2, 20, 256])
def test_wide_merge_matches_jax_kernel(S):
    """The port's full merge (K-RUN full form, K-LRT on int64 sums, K-CMP)
    against merge_lrt_kernel with wide_sums: the same survivors and exact
    int64 sums, at a cut that keeps part of the runs."""
    rng = np.random.default_rng(S + 1)
    kmers, counts = _streams(rng, S, per=max(40, 12_000 // S))
    nbc = S // 2
    tot = [int(c.astype(np.int64).sum()) for c in counts]
    params = lrt.LrtParams(nbc, S - nbc, sum(tot[:nbc]), sum(tot[nbc:]), 1e-3)
    jparams = jlrt.LrtParams(nbc, S - nbc, sum(tot[:nbc]), sum(tot[nbc:]), 1e-3)
    assert params.wide_sums and jparams.wide_sums
    nd, words, s_c, s_k = _jax_full_merge(kmers, counts, nbc, jparams, True)
    keys, count, sample = _triples(kmers, counts)
    n_distinct, hit_keys, hit_sums, _rows, _geno = merge_dev.merge_lrt_full(
        keys, count, sample, S, nbc, params.ratio_c, params.ratio_k, params.lr_min,
        False, False)
    assert n_distinct == nd and 0 < len(words) < nd
    np.testing.assert_array_equal(codec.keys_to_words(hit_keys.numpy()), words)
    np.testing.assert_array_equal(hit_sums.numpy(), np.stack([s_c, s_k], 1))


def test_wide_merge_past_256_samples_equal_after_rescore():
    """At S = 300 a JAX half-sum may pass 2^24 and its f32 round, so the
    keep masks may differ within the margin; the f64 rescore of exact int64
    sums makes every output equal."""
    rng = np.random.default_rng(300)
    S, nbc = 300, 150
    kmers, counts = _streams(rng, S, n_pool=600, per=60, wide_every=2)
    tot = [int(c.astype(np.int64).sum()) for c in counts]
    args = (nbc, S - nbc, tot[:nbc], tot[nbc:])
    acc, ref_acc = VectorAccumulator(), VectorAccumulator()
    res = tmerge.PartitionProcessor(TPoissonLikelihood(*args), nbc, S - nbc, 0.05, CPU,
                                    keep_counts=True)._process_device_merge(
        0, kmers, counts, acc)
    ref = jmerge_pipe.PartitionProcessor(PoissonLikelihood(*args), nbc, S - nbc, 0.05,
                                         keep_counts=True)._process_device_merge(
        0, kmers, counts, ref_acc, 31)
    assert (res.total_kmers, res.nb_sign, res.sign_controls) == (
        ref.total_kmers, ref.nb_sign, ref.sign_controls)
    assert res.nb_sign > 0
    _same_blocks(_block(acc), _block(ref_acc))
