"""Multi-word k-mers (33 <= k <= 128) in the port's modules, on the CPU
(every kernel wrapper takes its plain twin), against the JAX package's lane
machinery and numpy on the same numpy-seeded inputs: K-EXT's multi-word
twin, the row sort, K-RUN's forms on [nw, N] keys, K-GENO's chain, the
resident count, K-ASM's chunk rows, and the key-range plans' leading-word
cuts. Every output is an integer, so every comparison is exact.
"""

import functools

import numpy as np
import pytest
import torch

import kmdiff_tpu.pipeline.count as jcount
import kmdiff_tpu.pipeline.fused as jfused
from kmdiff_tpu.ops import codec as jcodec
from kmdiff_tpu.ops import merge_dev as jmerge
from kmdiff_tpu.pipeline.popstrat import sample_mask as jax_sample_mask
from kmdiff_tpu_torch.ops import codec, merge_dev
from kmdiff_tpu_torch.pipeline import count as tcount
from kmdiff_tpu_torch.pipeline import fused
from kmdiff_tpu_torch.pipeline.popstrat import sample_mask

CPU = torch.device("cpu")
KS = [33, 40, 48, 63, 64, 65, 80, 96, 97, 127, 128]
G = 3  # the code of G (A, C, T, G = 0, 1, 2, 3)


def _codes(rng, n, k):
    """Random codes with INVALID runs (read breaks and Ns) and a planted
    all-G stretch of k + 5 bases (its windows are all-ones forward words,
    whose canonical form is the all-C reverse complement)."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.004] = codec.INVALID
    codes[150::151] = codec.INVALID
    codes[500 : 500 + k + 5] = G
    return codes


def _jax_words(codes, k):
    lanes, ok = jcodec.extract_canonical_lanes(codes, k, mask_invalid=True)
    return jcodec.lanes_to_words([np.asarray(x) for x in lanes]), np.asarray(ok)


@pytest.mark.parametrize("k", KS)
def test_canonical_kmers_mw_twin_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 1500, k)
    keys = codec.canonical_kmers(torch.from_numpy(codes), k)
    nw = (k + 31) // 32
    assert keys.shape == (nw, len(codes) - k + 1) and keys.dtype == torch.int64
    words = codec.keys_to_words(keys.numpy())
    want, ok = _jax_words(codes, k)
    np.testing.assert_array_equal(words, want)
    # the sentinel row is every word all-ones, exactly at the invalid windows
    sent = (keys == codec.SENTINEL).all(0).numpy()
    np.testing.assert_array_equal(sent, ~ok)
    assert ok.sum() > 100 and (~ok).sum() > 100
    # the all-G windows are valid and canonical as all-C, never the sentinel
    allg = np.array([(codes[i : i + k] == G).all() for i in range(len(codes) - k + 1)])
    assert allg.sum() >= 6 and not sent[allg].any()
    cc = jcodec.lanes_to_words([np.asarray(x) for x in jcodec.extract_canonical_lanes(
        np.ones(k, np.uint8), k)[0]])
    assert (words[allg] == cc[0]).all()


#: the k of each word count's edges (33 and 64 bound two words, 65 and 96
#: three, 97 and 128 four; 63 is the reference's Kmer<64>)
K_MW = [33, 63, 64, 65, 96, 97, 127, 128]
#: the multi-word kernel's windows a thread's run at nw words
#: (csrc/canonical_kmers.cu kMwRuns2-4; a tile is 128 runs; the CUDA tests
#: read both from the built library)
MW_RUNS = {2: 32, 3: 16, 4: 16}


def _run_and_tile(k):
    run = MW_RUNS[(k + 31) // 32]
    return run, 128 * run


@functools.cache
def _edge_stream(k):
    """Codes for two tiles of windows and one more, and the JAX lanes of
    every window of them: the edge cases below compare the twin on this
    stream or a piece of it with the matching slice of the JAX windows
    (a window's key depends on its k codes alone)."""
    rng = np.random.default_rng(k + 700)
    codes = rng.integers(0, 4, 2 * _run_and_tile(k)[1] + k).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.003] = codec.INVALID
    return codes, *_jax_words(codes, k)


def _twin_words(codes, k):
    return codec.keys_to_words(codec.canonical_kmers(torch.from_numpy(codes), k).numpy())


def _mw_invalid_positions(k, n):
    """The first and the last code of a thread's run, and window positions
    31, 32, 63, 64, 95 and 96 of a run's first window (where the carries
    cross words), for runs at the start of a tile, inside it and at its
    end."""
    RUN, TILE = _run_and_tile(k)
    out = set()
    for r0 in (0, RUN, 5 * RUN, TILE - RUN, TILE):
        out |= {r0, r0 + RUN + k - 2, r0 + k - 1, r0 + RUN - 1}
        out |= {r0 + p for p in (31, 32, 63, 64, 95, 96)}
    return sorted(p for p in out if p < n)


@pytest.mark.parametrize("edge", ["lengths", "invalid", "views"])
@pytest.mark.parametrize("k", K_MW)
def test_canonical_kmers_mw_edges_match_jax(k, edge):
    """The twin against the JAX lanes on the multi-word kernel's edge
    inputs: window counts at a run and a tile, each plus or minus one
    window; one INVALID code at each edge position; the codes from byte
    offsets 1 to 15 on, short and across tiles."""
    codes, want, ok = _edge_stream(k)
    RUN, TILE = _run_and_tile(k)
    n = len(codes)
    if edge == "lengths":
        for w in (1, RUN - 1, RUN, RUN + 1, TILE - 1, TILE, TILE + 1, n - k + 1):
            np.testing.assert_array_equal(_twin_words(codes[: w + k - 1], k), want[:w])
    elif edge == "invalid":
        clean = np.where(codes == codec.INVALID, 0, codes).astype(np.uint8)
        for p in _mw_invalid_positions(k, n):
            one = clean.copy()
            one[p] = codec.INVALID
            got = _twin_words(one, k)
            np.testing.assert_array_equal(got, _jax_words(one, k)[0])
            sent = (got == np.uint64(2**64 - 1)).all(1)
            np.testing.assert_array_equal(np.flatnonzero(sent),
                                          np.arange(max(0, p - k + 1), min(p, n - k) + 1))
    else:
        for lead in range(1, 16):
            for m in (k, k + 40, TILE + k - 1 - lead, n - lead):
                np.testing.assert_array_equal(_twin_words(codes[lead : lead + m], k),
                                              want[lead : lead + m - k + 1])
    assert (~ok).sum() > 0


def test_canonical_kmers_mw_short_input_and_range():
    for k in (33, 128):
        out = codec.canonical_kmers(torch.zeros(k - 1, dtype=torch.uint8), k)
        assert out.shape == ((k + 31) // 32, 0)
    with pytest.raises(ValueError, match="k=129"):
        codec.canonical_kmers(torch.zeros(200, dtype=torch.uint8), 129)


@pytest.mark.parametrize("nw", [2, 3, 4])
def test_words_keys_round_trip_and_row_sort_matches_lexsort(nw):
    rng = np.random.default_rng(40 + nw)
    n = 5000
    # few leading words, so that ties go down to the last word
    words = rng.integers(0, 2**64 - 1, (n, nw), dtype=np.uint64)
    words[:, 0] = rng.choice(np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64), n)
    words[: n // 2, 1] = words[0, 1]
    words[::7] = words[3]  # equal rows: the sort must keep their order
    keys = codec.words_to_keys(words)
    assert keys.shape == (nw, n) and keys.flags.c_contiguous
    np.testing.assert_array_equal(codec.keys_to_words(keys), words)
    keys_s, perm = codec.sort_rows(torch.from_numpy(keys))
    want = np.lexsort(tuple(words[:, w] for w in range(nw - 1, -1, -1)))
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(codec.keys_to_words(keys_s.numpy()), words[want])
    assert codec.sort_keys(torch.from_numpy(keys))[1].equal(perm)


def _unique_rows(words, counts, ctrl):
    """numpy reference of K-RUN: distinct rows of sorted words (the
    all-ones sentinel rows dropped), their first rows, lengths and group
    sums."""
    valid = ~(words == np.uint64(2**64 - 1)).all(1)
    n_valid = int(valid.sum())
    w = words[:n_valid]
    start = np.ones(n_valid, bool)
    start[1:] = (w[1:] != w[:-1]).any(1)
    starts = np.flatnonzero(start)
    ends = np.append(starts[1:], n_valid)
    c = counts[:n_valid].astype(np.int64)
    sums = np.stack([np.add.reduceat(np.where(ctrl[:n_valid], c, 0), starts),
                     np.add.reduceat(np.where(ctrl[:n_valid], 0, c), starts)], 1)
    return starts, w[starts], n_valid, ends - starts, sums


@pytest.mark.parametrize("nw", [2, 3, 4])
def test_run_encode_mw_forms_match_numpy(nw):
    rng = np.random.default_rng(50 + nw)
    pool = rng.integers(0, 2**64 - 2, (700, nw), dtype=np.uint64)
    pool[:300, 0] = pool[0, 0]  # leading-word ties
    pool[:100, : nw - 1] = pool[0, : nw - 1]  # ties down to the last word
    n = 3001
    words = pool[rng.integers(0, len(pool), n)]
    words[-40:] = np.uint64(2**64 - 1)  # the sentinel tail
    order = np.lexsort(tuple(words[:, w] for w in range(nw - 1, -1, -1)))
    words = words[order]
    keys = torch.from_numpy(codec.words_to_keys(words))
    raw = rng.integers(1, 2**32, n, dtype=np.int64)
    sample = rng.integers(0, 20, n).astype(np.int16)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int64))
    p = perm.numpy()
    starts, rkeys, n_valid, lens, _ = _unique_rows(words, raw, np.ones(n, bool))

    got = codec.run_encode(keys, lengths=True)
    np.testing.assert_array_equal(got[0].numpy(), starts)
    np.testing.assert_array_equal(codec.keys_to_words(got[1].numpy()), rkeys)
    assert int(got[2]) == n_valid
    np.testing.assert_array_equal(got[3].numpy(), lens)
    dedup = codec.run_encode(keys, starts=False)
    assert dedup[0] is None and dedup[3] is None and dedup[1].equal(got[1])
    # the merge forms read counts through the permutation
    for dtype, top, flag in ((torch.int16, 2**15, 0x8000), (torch.int32, 2**20, 2**31)):
        v = rng.integers(0, top, n, dtype=np.int64)
        ctrl = rng.random(n) < 0.5
        packed = np.where(ctrl, v | flag, v)
        packed = packed.astype(np.uint16 if dtype == torch.int16 else np.uint32)
        packed = packed.view(np.int16 if dtype == torch.int16 else np.int32)
        res = codec.run_encode(keys, perm, torch.from_numpy(packed), starts=False)
        want = _unique_rows(words, v[p], ctrl[p])[4]
        np.testing.assert_array_equal(res[3].numpy(), want)
        assert res[3].dtype == torch.int32
    full = codec.run_encode(keys, perm, torch.from_numpy(raw.astype(np.uint32).view(np.int32)),
                            sample=torch.from_numpy(sample), nb_controls=9)
    want = _unique_rows(words, raw[p], sample[p] < 9)[4]
    np.testing.assert_array_equal(full[3].numpy(), want)
    assert full[3].dtype == torch.int64 and int(full[3].max()) >= 2**32
    # nothing but sentinels, and nothing at all
    empty = codec.run_encode(torch.full((nw, 5), codec.SENTINEL), lengths=True)
    assert empty[1].shape == (nw, 0) and int(empty[2]) == 0


@pytest.mark.parametrize("nw", [2, 3, 4])
def test_geno_sample_mw_matches_jax_chain_and_sample_mask(nw):
    rng = np.random.default_rng(60 + nw)
    words = rng.integers(0, 2**64 - 1, (20_000, nw), dtype=np.uint64)
    keys = torch.from_numpy(codec.words_to_keys(words))
    for rate, seed in ((0.05, 0), (0.3, 12345)):
        thr = merge_dev.pca_threshold_u32(rate)
        got = merge_dev.geno_sample(keys, thr, seed).numpy()
        # the JAX merge's chain over the u32 lanes, most significant first
        h = jmerge._SAMPLE_SEED ^ np.uint32(seed)
        for lane in jcodec.words_to_lanes(words):
            h = np.asarray(jmerge._avalanche(lane ^ h))
        np.testing.assert_array_equal(got, h < thr)
        np.testing.assert_array_equal(got, sample_mask(words, rate, seed))
        np.testing.assert_array_equal(got, jax_sample_mask(words, rate, seed))
        assert 0 < got.sum() < len(got)
    # a strided [nw, U] view (K-RUN's run keys) samples the same rows
    wide = torch.cat([keys, keys], 1)[:, : keys.shape[1]]
    assert merge_dev.geno_sample(wide, thr, 7).equal(merge_dev.geno_sample(keys, thr, 7))


@pytest.mark.parametrize("sort_rows,hard_min", [(None, 1), (1 << 11, 2)])
@pytest.mark.parametrize("k", [47, 128])
def test_count_sample_resident_mw_matches_jax(monkeypatch, k, sort_rows, hard_min):
    """One chunk, and several (dedup_sum over [nw, N] keys) with hard-min:
    the JAX resident count's stream, max, histogram and totals."""
    rng = np.random.default_rng(k)
    motif = rng.integers(0, 4, 140).astype(np.uint8)
    codes = [_codes(rng, 6000, k), _codes(rng, 2000, k)]
    for s in range(0, 5800, 300):
        codes[0][s : s + 140] = motif  # counts above 1 and runs across chunks
    if sort_rows:
        monkeypatch.setattr(jcount, "SORT_ROWS", sort_rows)
        monkeypatch.setattr(tcount, "SORT_ROWS", sort_rows)
        assert len(tcount._host_code_chunks(codes, k, sort_rows)) > 2
    js = jfused.count_sample_resident(codes, k, hard_min, slack=1 << 10)
    ts = fused.count_sample_resident(codes, k, hard_min, CPU)
    blob = np.asarray(js.blob)[: js.U]
    want = jcodec.lanes_to_words([blob[:, i] for i in range(blob.shape[1])])
    assert (ts.U, ts.max_count, ts.n_distinct_pre, ts.total_mass) == (
        js.U, js.max_count, js.n_distinct_pre, js.total_mass)
    assert ts.max_count > 1
    assert ts.keys.shape == ((k + 31) // 32, ts.U) and ts.keys.is_contiguous()
    np.testing.assert_array_equal(codec.keys_to_words(ts.keys.numpy()), want)
    np.testing.assert_array_equal(ts.counts.numpy(),
                                  np.asarray(js.counts)[: js.U].view(np.int32))
    np.testing.assert_array_equal(ts.hist_uvec[1:], js.hist_uvec[1:])
    assert ts.nbytes == ts.U * (8 * ts.keys.shape[0] + 4)
    empty = fused.count_sample_resident([], k, 1, CPU)
    assert empty.keys.shape == ((k + 31) // 32, 0)


def _mw_streams(rng, S, nw, n_pool, U, tie_block=0):
    """S sorted distinct [nw, U] key streams from one pool; the first
    tie_block pool rows share their leading word."""
    pool = rng.integers(0, 2**64 - 2, (n_pool, nw), dtype=np.uint64)
    pool[:tie_block, 0] = tied = pool[0, 0]
    pool = np.unique(pool, axis=0)
    streams = []
    for _ in range(S):
        pick = np.sort(rng.choice(len(pool), U, replace=False))
        w = pool[pick]
        streams.append(fused.ResidentStream(
            torch.from_numpy(codec.words_to_keys(w)), torch.ones(U, dtype=torch.int32),
            U, 1, np.zeros(257, np.int64), U, U))
    return streams, tied


@pytest.mark.parametrize("nw", [2, 4])
def test_plan_key_chunks_cuts_on_the_leading_word(nw):
    rng = np.random.default_rng(70 + nw)
    streams, tied = _mw_streams(rng, 5, nw, 6000, 3000, tie_block=300)
    max_rows = 2000
    starts, lens = fused.plan_key_chunks(streams, max_rows)
    assert (lens.sum(1) <= max_rows).all() and len(starts) > 5
    seen = []
    for c in range(len(starts)):
        lead = np.concatenate([codec.keys_to_words(st.keys[:, a : a + n].numpy())[:, 0]
                               for st, a, n in zip(streams, starts[c], lens[c])])
        seen.append((lead.min(), lead.max()))
    for (_lo, hi), (lo, _hi) in zip(seen, seen[1:]):
        assert hi < lo  # no leading word, so no k-mer, in two chunks
    for s, st in enumerate(streams):
        assert starts[0, s] == 0 and starts[-1, s] + lens[-1, s] == st.U
        np.testing.assert_array_equal(starts[1:, s], starts[:-1, s] + lens[:-1, s])
    # the tied block alone (~750 rows in all) cannot go below its size
    n_tied = sum(int((codec.keys_to_words(st.keys.numpy())[:, 0] == tied).sum())
                 for st in streams)
    assert n_tied > 500
    with pytest.raises(fused.FusedFallback, match="no key-range plan"):
        fused.plan_key_chunks(streams, n_tied - 1)


def test_quantile_key_split_keeps_leading_word_ties_together():
    rng = np.random.default_rng(80)
    streams, _tied = _mw_streams(rng, 4, 2, 5000, 2500, tie_block=1200)
    kmers = [codec.keys_to_words(st.keys.numpy()) for st in streams]
    bounds, slices, R = merge_dev.quantile_key_split(
        kmers, 8, lambda _r: 10**9, grow=True, attempts=1)
    assert R == 8 and len(slices) == len(bounds) + 1
    covered = [0] * len(kmers)
    last_hi = None
    for per in slices:
        lead = np.concatenate([km[a:b, 0] for (a, b), km in zip(per, kmers)])
        for s, (a, b) in enumerate(per):
            assert a == covered[s]
            covered[s] = b
        if lead.size:
            assert last_hi is None or lead.min() > last_hi
            last_hi = lead.max()
    assert covered == [len(k) for k in kmers]


@pytest.mark.parametrize("with_sample", [False, True])
def test_assemble_chunk_mw_plain_matches_the_jax_chunk(with_sample):
    rng = np.random.default_rng(90)
    streams, _tied = _mw_streams(rng, 4, 3, 4000, 900)
    for st in streams:
        st.counts = torch.from_numpy(rng.integers(1, 2**15, st.U).astype(np.int32))
    starts, lens = np.array([10, 0, 300, 5]), np.array([400, 0, 211, 895])
    table = fused.ChunkTable([s.keys for s in streams], [s.counts for s in streams],
                             starts, lens, 2)
    got = table.assemble(0, not with_sample, with_sample)
    words = np.concatenate([codec.keys_to_words(st.keys[:, a : a + n].numpy())
                            for st, a, n in zip(streams, starts, lens)])
    np.testing.assert_array_equal(codec.keys_to_words(got[0].numpy()), words)
    counts = np.concatenate([st.counts.numpy()[a : a + n]
                             for st, a, n in zip(streams, starts, lens)])
    sid = np.repeat(np.arange(4), lens)
    if with_sample:
        np.testing.assert_array_equal(got[1].numpy(), counts)
        np.testing.assert_array_equal(got[2].numpy(), sid)
    else:
        np.testing.assert_array_equal(got[1].numpy().view(np.uint16),
                                      counts | np.where(sid < 2, 0x8000, 0))
