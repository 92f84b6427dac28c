"""K-HIST's statistics (ops.codec.rle_stats_plain) and K-LRT's narrow forms
(ops.lrt_kernel.lrt_filter with want_lr / want_sums) against the JAX
package, on the CPU, where each wrapper runs its plain twin.

Tolerances: n_valid, the max, the histogram, the sums and keep against the
port's own full form are integers or flags and must be equal. lr against
the JAX package's filter and its Pallas kernel (interpret mode) follows
tests/test_torch_lrt.py's rule, with its reason there: |lr - lr_ref| <=
1e-6*|lr_ref| + 1e-6 + 2.5e-7*tot, and keep equal except on rows whose
margin-adjusted lr lies within that bound of lr_min.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmdiff_tpu.ops import codec as jcodec
from kmdiff_tpu.ops.lrt import LrtParams as JaxLrtParams
from kmdiff_tpu.ops.lrt import lrt_filter_block as jax_lrt_filter_block
from kmdiff_tpu.ops.lrt_pallas import TILE_B, lrt_filter_block_pallas
from kmdiff_tpu_torch.ops import codec
from kmdiff_tpu_torch.ops.lrt import MARGIN_ABS, MARGIN_PER_COUNT
from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter


def _check_stats(n_valid, counts, stats, U):
    """rle_stats_plain with and without the histogram, and the CPU
    wrapper, against a JAX stats array [n_distinct, max (u32 bits),
    n_valid, uvec[0..256]]."""
    st = np.asarray(stats).view(np.uint32)
    assert counts.numel() == U == int(st[0])
    got = codec.rle_stats_plain(n_valid, counts, True)
    assert (got.n_valid, got.max_count) == (int(st[2]), int(st[1]))
    np.testing.assert_array_equal(got.hist[1:], st[4:])
    assert got.hist[0] == 0 and got.hist.dtype == np.int64
    bare = codec.rle_stats_plain(n_valid, counts, False)
    assert (bare.n_valid, bare.max_count, bare.hist) == (got.n_valid, got.max_count, None)
    wrapped = codec.rle_stats(n_valid, counts, True)
    assert (wrapped.n_valid, wrapped.max_count) == (got.n_valid, got.max_count)
    np.testing.assert_array_equal(wrapped.hist, got.hist)
    return got


@pytest.mark.parametrize("k", [15, 31])
def test_rle_stats_matches_jax_count(k):
    """sort_rle's int32 run lengths: 40,000 codes with a repeated motif, so
    that counts above 255 reach bin 256."""
    rng = np.random.default_rng(k + 50)
    codes = rng.integers(0, 4, 40_000).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = codec.INVALID
    motif = rng.integers(0, 4, 40).astype(np.uint8)
    for s in range(0, len(codes) - 40, 89):
        codes[s : s + 40] = motif
    lanes, _ = jcodec.extract_canonical_lanes(jnp.asarray(codes), k, mask_invalid=True)
    stats = jcodec.count_sort_rle_lanes(lanes, len(codes) - k + 1, with_hist=True)[0]
    keys = torch.sort(codec.canonical_kmers(torch.from_numpy(codes), k)).values
    _s, _k, n_valid, counts = codec.run_encode(keys, lengths=True, starts=False)
    got = _check_stats(n_valid, counts, stats, counts.numel())
    assert got.max_count > 255 and got.hist[256] > 0


@pytest.mark.parametrize("hard_min", [1, 2])
def test_rle_stats_matches_jax_dedup(hard_min):
    """dedup_sum's int64 sums of three overlapping streams, the first one's
    every 101st weight above 2^31 (one a key, so each sum fits u32)."""
    rng = np.random.default_rng(hard_min + 60)
    pool = np.unique(rng.integers(0, 2**63, 6000, dtype=np.uint64) * np.uint64(2))
    words = np.concatenate([pool[np.sort(rng.choice(len(pool), 2500, replace=False))]
                            for _ in range(3)])
    weights = rng.integers(1, 6, len(words)).astype(np.uint32)
    weights[2500::97] = rng.integers(300, 70_000, len(weights[2500::97]))
    weights[:2500:101] = np.uint32(2**31 + 5)
    hi, lo = jcodec.words_to_lanes(words.reshape(-1, 1))
    stats = jcodec.dedup_sum_lanes((jnp.asarray(hi), jnp.asarray(lo)), jnp.asarray(weights),
                                   len(words), hard_min=hard_min, with_hist=True)[0]
    keys_s, perm = torch.sort(torch.from_numpy(codec.words_to_keys(words.reshape(-1, 1)).copy()))
    starts, run_keys, n_valid, _ = codec.run_encode(keys_s)
    sums = codec.weighted_run_sums(starts, n_valid, perm,
                                   torch.from_numpy(weights.view(np.int32)))
    if hard_min > 1:
        run_keys, sums = codec.keep_at_least(run_keys, sums, hard_min)
    assert sums.dtype == torch.int64
    got = _check_stats(n_valid, sums, stats, run_keys.numel())
    assert got.max_count >= 2**31


def test_rle_stats_edges():
    """No counts (the max is 0, n_valid passes through), u32 counts at and
    above 2^31 (the max is the u32 value), zeros in bin 0, and int64 counts
    up to 2^32 - 1 in bin 256."""
    n_valid = torch.tensor([7], dtype=torch.int64)
    for dtype in (torch.int32, torch.int64):
        st = codec.rle_stats_plain(n_valid, torch.zeros(0, dtype=dtype), True)
        assert (st.n_valid, st.max_count) == (7, 0)
        np.testing.assert_array_equal(st.hist, np.zeros(codec.HIST_BINS, np.int64))
    u32 = np.array([1, 2**31, 2**32 - 1, 0, 255, 256, 3], np.uint32)
    want = np.bincount(np.minimum(u32, 256), minlength=codec.HIST_BINS)
    for counts in (torch.from_numpy(u32.view(np.int32)), torch.from_numpy(u32.astype(np.int64))):
        st = codec.rle_stats_plain(n_valid, counts, True)
        assert st.max_count == 2**32 - 1
        np.testing.assert_array_equal(st.hist, want)


def _counts(rng, B, S):
    counts = rng.integers(0, 64, size=(B, S), dtype=np.int32)
    counts[rng.random(B) < 0.1] = 0
    return counts


def _close(ours, ref, lr_min):
    """tests/test_torch_lrt.py's rule: sums equal, lr within the bound, keep
    equal off the boundary."""
    keep, lr, s_c, s_k = (np.asarray(x) for x in ours)
    keep_r, lr_r, s_c_r, s_k_r = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(s_c, s_c_r)
    np.testing.assert_array_equal(s_k, s_k_r)
    tot = (s_c_r + s_k_r).astype(np.float64)
    tol = 1e-6 * np.abs(lr_r) + 1e-6 + 2.5e-7 * tot
    assert not (np.abs(lr.astype(np.float64) - lr_r) > tol).any()
    boundary = np.abs(lr_r + MARGIN_PER_COUNT * tot + MARGIN_ABS - lr_min) <= tol
    np.testing.assert_array_equal(keep[~boundary], keep_r[~boundary])


@pytest.mark.parametrize("B", [2051, 1024])
@pytest.mark.parametrize("S,nb_controls", [(2, 1), (20, 10)])
def test_lrt_narrow_forms(S, nb_controls, B):
    """keep alone (the merge's form), keep and the sums (run_filter's) and
    keep with lr hold the full form's values and None elsewhere; the full
    form holds the JAX filter and the Pallas kernel, which takes B % 1024
    == 0: it gets zero rows appended, and their results are dropped."""
    rng = np.random.default_rng(B + S)
    counts = _counts(rng, B, S)
    params = JaxLrtParams(nb_controls, S - nb_controls, 500_000, 600_000, 0.05)
    args = (nb_controls, params.ratio_c, params.ratio_k, params.lr_min)
    t = torch.from_numpy(counts)
    full = lrt_filter(t, *args)
    for want_lr, want_sums in ((False, False), (False, True), (True, False)):
        got = lrt_filter(t, *args, want_lr=want_lr, want_sums=want_sums)
        asked = (True, want_lr, want_sums, want_sums)
        for g, f, a in zip(got, full, asked):
            if a:
                assert g.dtype == f.dtype and torch.equal(g, f)
            else:
                assert g is None
    jargs = (nb_controls, jnp.float32(params.ratio_c), jnp.float32(params.ratio_k),
             jnp.float32(params.lr_min))
    _close(full, jax_lrt_filter_block(jnp.asarray(counts), *jargs), params.lr_min)
    padded = np.zeros((-(-B // TILE_B) * TILE_B, S), np.int32)
    padded[:B] = counts
    pallas = lrt_filter_block_pallas(jnp.asarray(padded), *jargs, interpret=True)
    _close(full, [np.asarray(x)[:B] for x in pallas], params.lr_min)
    assert 0 < int(full[0].sum()) < B
