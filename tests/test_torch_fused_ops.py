"""The fused run's modules in the port (ops.codec dedup_sum and sort_rle's
histogram, pipeline.fused) against the JAX package's, on the same
numpy-seeded inputs, on the CPU (every kernel wrapper takes its plain
twin). Keys, counts, histograms, chunk rows and routed survivors are
integers or the same host f64 values, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmdiff_tpu.pipeline.count as jcount
import kmdiff_tpu.pipeline.fused as jfused
from kmdiff_tpu.core.model import PoissonLikelihood
from kmdiff_tpu_torch.core.model import PoissonLikelihood as TPoissonLikelihood
from kmdiff_tpu.io.accumulator import KmerSignBlock, VectorAccumulator
from kmdiff_tpu.ops import codec as jcodec
from kmdiff_tpu.parallel import runtime as jruntime
from kmdiff_tpu.pipeline.merge import PartitionProcessor as JaxProcessor
from kmdiff_tpu_torch.ops import codec
from kmdiff_tpu_torch.pipeline import count as tcount
from kmdiff_tpu_torch.pipeline import fused
from kmdiff_tpu_torch.pipeline.merge import PartitionProcessor

CPU = torch.device("cpu")


def resident_from_lanes(blob, counts, U: int):
    """A JAX ResidentStream's [P, 2] u32 lane blob and [P] u32 counts ->
    the port's stream tensors: int64 keys [U] and int32 counts [U]."""
    blob = np.asarray(blob)[:U]
    words = jcodec.lanes_to_words((blob[:, 0], blob[:, 1]))
    keys = torch.from_numpy(codec.words_to_keys(words).copy())
    return keys, torch.from_numpy(np.asarray(counts)[:U].view(np.int32).copy())


def _port_stream(js) -> fused.ResidentStream:
    keys, counts = resident_from_lanes(js.blob, js.counts, js.U)
    return fused.ResidentStream(keys, counts, js.U, js.max_count,
                                np.asarray(js.hist_uvec, np.int64),
                                js.n_distinct_pre, js.total_mass)


def _codes(rng, n, repeat_every=0):
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.01] = codec.INVALID
    if repeat_every:
        # a valid 40-base motif every repeat_every bases: counts above 255
        motif = rng.integers(0, 4, 40).astype(np.uint8)
        for s in range(0, n - 40, repeat_every):
            codes[s : s + 40] = motif
    return codes


def _sorted_words(rng, pool, n):
    return pool[np.sort(rng.choice(len(pool), n, replace=False))]


@pytest.mark.parametrize("hard_min", [1, 3])
def test_dedup_sum_matches_jax(hard_min):
    """Three overlapping distinct streams with u32 weights (some above
    2^16) merge to the same distinct k-mers, sums, max and histogram."""
    rng = np.random.default_rng(hard_min)
    pool = np.unique(rng.integers(0, 2**63, 6000, dtype=np.uint64) * np.uint64(2))
    words = np.concatenate([_sorted_words(rng, pool, 2500) for _ in range(3)])
    weights = rng.integers(1, 6, len(words)).astype(np.uint32)
    weights[::97] = rng.integers(300, 70_000, len(weights[::97]))
    hi, lo = jcodec.words_to_lanes(words.reshape(-1, 1))
    stats, blob, counts = jcodec.dedup_sum_lanes(
        (jnp.asarray(hi), jnp.asarray(lo)), jnp.asarray(weights), len(words),
        hard_min=hard_min, with_hist=True)
    stats = np.asarray(stats)
    U = int(stats[0])
    want_words = jcodec.lanes_to_words(tuple(np.asarray(blob)[:U].T))

    keys, cnt, st = codec.dedup_sum(
        torch.from_numpy(codec.words_to_keys(words.reshape(-1, 1)).copy()),
        torch.from_numpy(weights.view(np.int32)), hard_min=hard_min,
        with_hist=True)
    assert keys.numel() == U > 0
    np.testing.assert_array_equal(codec.keys_to_words(keys.numpy()), want_words)
    np.testing.assert_array_equal(cnt.numpy().view(np.uint32),
                                  np.asarray(counts)[:U])
    assert st.max_count == int(stats[1])
    assert st.n_valid == int(stats[2])
    np.testing.assert_array_equal(st.hist[1:], stats[4:])
    if hard_min > 1:
        assert int(cnt.min()) >= hard_min


def test_dedup_sum_refuses_sums_past_u32():
    keys = torch.tensor([5, 5, 9], dtype=torch.int64)
    w = torch.from_numpy(np.array([2**31, 2**31, 1], np.uint32).view(np.int32))
    with pytest.raises(OverflowError):
        codec.dedup_sum(keys, w)


@pytest.mark.parametrize("k", [15, 31])
def test_sort_rle_histogram_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 40_000, repeat_every=97)
    lanes, _ = jcodec.extract_canonical_lanes(jnp.asarray(codes), k,
                                              mask_invalid=True)
    stats = np.asarray(jcodec.count_sort_rle_lanes(
        lanes, len(codes) - k + 1, with_hist=True)[0])
    keys, counts, st = codec.sort_rle(
        codec.canonical_kmers(torch.from_numpy(codes), k), with_hist=True)
    assert keys.numel() == int(stats[0])
    assert (st.max_count, st.n_valid) == (int(stats[1]), int(stats[2]))
    assert st.max_count > 255 and st.hist[256] > 0
    np.testing.assert_array_equal(st.hist[1:], stats[4:])
    assert st.hist[0] == 0


@pytest.mark.parametrize("mode", ["p16", "p32"])
def test_assemble_chunk_plain_matches_jax(mode):
    """Four streams (one slice empty, one a whole stream) in both packings,
    compared with the JAX rows where iota < lens, in order."""
    rng = np.random.default_rng(len(mode) + (mode == "p32"))
    pool = np.unique(rng.integers(0, 2**63, 5000, dtype=np.uint64) * np.uint64(2))
    M, P = 512, 2048
    blobs, jcounts, keys_list, counts_list = [], [], [], []
    for s in range(4):
        U = int(rng.integers(600, 1200))
        words = _sorted_words(rng, pool, U)
        top = 2**15 if mode == "p16" else 2**31
        cnt = rng.integers(1, top, U).astype(np.uint32)
        blob = np.full((P, 2), 0xFFFFFFFF, np.uint32)
        blob[:U, 0], blob[:U, 1] = jcodec.words_to_lanes(words.reshape(-1, 1))
        cpad = np.zeros(P, np.uint32)
        cpad[:U] = cnt
        blobs.append(jnp.asarray(blob))
        jcounts.append(jnp.asarray(cpad))
        k_t, c_t = resident_from_lanes(blob, cpad, U)
        keys_list.append(k_t)
        counts_list.append(c_t)
    starts = np.array([3, 100, 0, 250], np.int32)
    lens = np.array([400, 0, 512, 17], np.int32)
    lanes, _smp, cat = jfused._assemble_chunk_impl(
        blobs, jcounts, jnp.asarray(starts), jnp.asarray(lens), M, 2, mode)
    sel = np.concatenate([s * M + np.arange(n) for s, n in enumerate(lens)])
    want_words = jcodec.lanes_to_words(tuple(np.asarray(l)[sel] for l in lanes))
    want_counts = np.asarray(cat)[sel]

    keys, count = fused.ChunkTable(keys_list, counts_list, starts, lens, 2).assemble(
        0, pack16=mode == "p16")
    assert count.dtype == (torch.int16 if mode == "p16" else torch.int32)
    np.testing.assert_array_equal(codec.keys_to_words(keys.numpy()), want_words)
    np.testing.assert_array_equal(
        count.numpy().view(np.uint16 if mode == "p16" else np.int32),
        want_counts)


def test_routing_accumulator_matches_jax():
    rng = np.random.default_rng(8)
    blocks = []
    for n in (0, 1, 300, 77):
        kmers = np.sort(rng.integers(0, 2**63, n, dtype=np.uint64)).reshape(-1, 1)
        blocks.append(KmerSignBlock(
            kmers, rng.random(n), rng.integers(0, 2, n).astype(np.int8),
            rng.random(n), rng.random(n), None))
    for P in (1, 4, 7):
        accs_j = [VectorAccumulator() for _ in range(P)]
        accs_t = [VectorAccumulator() for _ in range(P)]
        rj = jfused._RoutingAccumulator(accs_j, P)
        rt = fused._RoutingAccumulator(accs_t, P)
        for b in blocks:
            rj.push_block(b)
            rt.push_block(b)
        rj.finish()
        rt.finish()
        for aj, at in zip(accs_j, accs_t):
            bj, bt = list(aj.blocks()), list(at.blocks())
            assert len(bj) == len(bt)
            for x, y in zip(bj, bt):
                for f in ("kmers", "pvalues", "signs", "mean_control", "mean_case"):
                    np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def _streams(rng, S, U_range, overlap_pool):
    out = []
    for _ in range(S):
        U = int(rng.integers(*U_range))
        keys = np.sort(rng.choice(overlap_pool, U, replace=False))
        out.append(fused.ResidentStream(
            torch.from_numpy(keys), torch.ones(U, dtype=torch.int32), U, 1,
            np.zeros(257, np.int64), U, U))
    return out


@pytest.mark.parametrize("max_rows", [300, 5000, 1 << 24])
def test_plan_key_chunks_properties(max_rows):
    """Chunks within budget, ascending and key-disjoint across streams, and
    every row of every stream in exactly one chunk."""
    rng = np.random.default_rng(max_rows)
    pool = np.unique(rng.integers(-(2**62), 2**62, 40_000))
    streams = _streams(rng, 6, (0, 9000), pool)
    streams.append(_streams(rng, 1, (1, 2), pool)[0])
    starts, lens = fused.plan_key_chunks(streams, max_rows)
    assert starts.shape == lens.shape and starts.shape[1] == len(streams)
    assert (lens.sum(1) <= max_rows).all() and (lens.sum(1) > 0).all()
    if max_rows < 5000:
        assert len(starts) > 10
    for s, st in enumerate(streams):
        # contiguous, in order, covering [0, U)
        assert starts[0, s] == 0
        np.testing.assert_array_equal(starts[1:, s], starts[:-1, s] + lens[:-1, s])
        assert starts[-1, s] + lens[-1, s] == st.U
    last = None
    for c in range(len(starts)):
        ks = np.concatenate([st.keys.numpy()[a : a + n]
                             for st, a, n in zip(streams, starts[c], lens[c])])
        if last is not None:
            assert ks.min() > last
        last = ks.max()


@pytest.mark.parametrize("sort_rows,hard_min", [(None, 1), (1 << 12, 2)])
def test_count_sample_resident_matches_jax(monkeypatch, sort_rows, hard_min):
    """One chunk, and several chunks (dedup_sum) with hard-min on top: the
    same stream, max, histogram and totals as the JAX resident count."""
    rng = np.random.default_rng(31)
    codes = [_codes(rng, 9000, repeat_every=61), _codes(rng, 3000)]
    if sort_rows:
        monkeypatch.setattr(jcount, "SORT_ROWS", sort_rows)
        monkeypatch.setattr(tcount, "SORT_ROWS", sort_rows)
        assert len(tcount._host_code_chunks(codes, 31, sort_rows)) > 2
    js = jfused.count_sample_resident(codes, 31, hard_min, slack=1 << 10)
    ts = fused.count_sample_resident(codes, 31, hard_min, CPU)
    want_keys, want_counts = resident_from_lanes(js.blob, js.counts, js.U)
    assert (ts.U, ts.max_count, ts.n_distinct_pre, ts.total_mass) == (
        js.U, js.max_count, js.n_distinct_pre, js.total_mass)
    assert ts.U < ts.n_distinct_pre if hard_min > 1 else ts.U == ts.n_distinct_pre
    assert torch.equal(ts.keys, want_keys)
    assert torch.equal(ts.counts, want_counts)
    np.testing.assert_array_equal(ts.hist_uvec[1:], js.hist_uvec[1:])
    empty = fused.count_sample_resident([], 31, 1, CPU)
    assert (empty.U, empty.total_mass, int(empty.hist_uvec.sum())) == (0, 0, 0)


@pytest.mark.parametrize("chunk_rows", [None, 900])
def test_fused_merge_matches_jax_on_same_streams(monkeypatch, chunk_rows):
    """Both merges fed identical streams (the JAX resident streams, carried
    across by resident_from_lanes) test the same k-mers and route the same
    survivors to the same partitions, in one chunk and in many."""
    rng = np.random.default_rng(2)
    nbc, nbk, P = 2, 2, 3
    jstreams = []
    for s in range(nbc + nbk):
        codes = _codes(rng, 6000, repeat_every=0 if s < nbc else 53)
        jstreams.append(jfused.count_sample_resident([codes], 21, 1,
                                                     slack=1 << 12))
    monkeypatch.setattr(jruntime, "_requested", 1)
    monkeypatch.setattr(jruntime, "_mesh", None)
    monkeypatch.setattr(jruntime, "_resolved", False)
    if chunk_rows:
        monkeypatch.setattr(jfused, "CHUNK_ROWS", 1 << 12)
        monkeypatch.setattr(fused, "FUSED_CHUNK_ROWS", chunk_rows)
    tot_c = sum(s.total_mass for s in jstreams[:nbc])
    tot_k = sum(s.total_mass for s in jstreams[nbc:])
    thr = 0.2
    totals = ([s.total_mass for s in jstreams[:nbc]],
              [s.total_mass for s in jstreams[nbc:]])
    model = PoissonLikelihood(nbc, nbk, *totals)
    assert tot_c and tot_k
    accs_j = [VectorAccumulator() for _ in range(P)]
    accs_t = [VectorAccumulator() for _ in range(P)]
    res_j = jfused.fused_merge(JaxProcessor(model, nbc, nbk, threshold=thr),
                               accs_j, jstreams, 21, P)
    res_t = fused.fused_merge(PartitionProcessor(TPoissonLikelihood(nbc, nbk, *totals),
                                                 nbc, nbk, thr, CPU),
                              accs_t, [_port_stream(s) for s in jstreams], P)
    assert res_t == tuple(res_j)
    assert res_t[1] > 0
    for aj, at in zip(accs_j, accs_t):
        bj = [b for b in aj.blocks() if len(b)]
        bt = [b for b in at.blocks() if len(b)]
        for f in ("kmers", "pvalues", "signs", "mean_control", "mean_case"):
            np.testing.assert_array_equal(
                np.concatenate([getattr(b, f) for b in bj]),
                np.concatenate([getattr(b, f) for b in bt]))
