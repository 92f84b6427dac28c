"""The port's popstrat kernels' plain twins against the JAX package, on
inputs made from numpy seeds: K-GENO against the host sample_mask; the
full merge (K-ROWS, K-GENO) against merge_lrt_kernel with rows and geno;
K-GRAM (also at its edge shapes: 31-65 and 2^16 + 7 rows, 1-257 samples,
all-zero and all-one blocks) and eigenstrat_pca against the JAX PCA forced
through its device tiles; K-IRLS against the JAX batched IRLS in f32.

Tolerances: integers, masks, PCs and eigenvalues exactly equal (the PCA's
integers are exact and its f64 host arithmetic is the same). The IRLS fits
are f32 in both packages with other summation orders and LU codes: iters
and the frozen items equal, ll within rtol 1e-5 (atol 1e-5 for the near-0
log-likelihood of a separable item), weights within rtol 1e-3 (atol 1e-4
for weights near 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmdiff_tpu.ops import glm as jglm
from kmdiff_tpu.ops import merge_dev as jmerge
from kmdiff_tpu.ops import pca as jpca
from kmdiff_tpu.pipeline.popstrat import _condition_design, sample_mask
from kmdiff_tpu_torch.ops import codec, glm, merge_dev, pca

CPU = torch.device("cpu")


def _keys_both_halves(rng, n):
    """u64 words with the top bit set in half of them, clear in the rest."""
    w = rng.integers(0, 2**63, n, dtype=np.uint64)
    w[::2] |= np.uint64(1 << 63)
    return w.reshape(-1, 1)


@pytest.mark.parametrize("rate", [0.0, 1e-3, 0.05, 1.0])
def test_geno_sample_matches_sample_mask(rate):
    rng = np.random.default_rng(int(rate * 1000) + 1)
    words = _keys_both_halves(rng, 40_000)
    assert (words[:, 0] >> np.uint64(63)).any() and not (
        words[1::2, 0] >> np.uint64(63)).any()
    keys = torch.from_numpy(codec.words_to_keys(words))
    for seed in (0, 7, 2**31 + 5):
        want = sample_mask(words, rate, seed)
        got = merge_dev.geno_sample(keys, merge_dev.pca_threshold_u32(rate), seed)
        np.testing.assert_array_equal(got.numpy(), want)
    assert merge_dev.pca_threshold_u32(rate) == jmerge.pca_threshold_u32(rate)


def _streams(rng, S, n_pool=2500, per=1200):
    pool = np.unique(_keys_both_halves(rng, n_pool)[:, 0])
    kmers, counts = [], []
    for s in range(S):
        take = np.sort(rng.choice(len(pool), per, replace=False))
        kmers.append(pool[take].reshape(-1, 1))
        c = rng.integers(1, 300, per, dtype=np.uint32)
        if s < S // 2:
            c[: per // 8] *= 25
        counts.append(c)
    return kmers, counts


@pytest.mark.parametrize("S,nbc", [(2, 1), (7, 3)])
def test_merge_lrt_full_matches_jax(S, nbc):
    rng = np.random.default_rng(S)
    kmers, counts = _streams(rng, S)
    ratio_c, ratio_k, lr_min = 0.45, 0.55, 2.0
    rate, seed = 0.05, 11
    thr = merge_dev.pca_threshold_u32(rate)

    N = sum(len(k) for k in kmers)
    pad_to = 1 << (N - 1).bit_length()
    lanes, sample, count, _ = jmerge.build_triples(kmers, counts, pad_to)
    out = jmerge.merge_lrt_kernel(
        tuple(jnp.asarray(l.copy()) for l in lanes), jnp.asarray(sample.copy()),
        jnp.asarray(count.copy()), nbc, jnp.float32(ratio_c),
        jnp.float32(ratio_k), jnp.float32(lr_min), jnp.uint32(thr),
        jnp.uint32(seed), pad_to, pad_to, True, nb_samples=S, want_rows=True,
        packed_ctrl=False,
    )
    nh, ng = int(out["n_hits"]), int(out["n_geno"])
    blob = np.asarray(out["hit_blob"])[:nh]

    keys, pcount, psample, n = merge_dev.build_triples(kmers, counts)
    assert n == N and pcount.dtype == np.int32 and psample.dtype == np.int16
    # raw counts, as the JAX package's full branch ships them
    np.testing.assert_array_equal(pcount, count[:N])
    nd, hit_keys, hit_sums, rows, geno = merge_dev.merge_lrt_full(
        torch.from_numpy(keys), torch.from_numpy(pcount),
        torch.from_numpy(psample), S, nbc, ratio_c, ratio_k, lr_min, True, True,
        thr, seed)
    assert hit_sums.dtype == torch.int64
    assert nd == int(out["n_distinct"])
    assert 0 < nh == len(hit_keys) and 0 < ng == len(geno)
    np.testing.assert_array_equal(codec.keys_to_words(hit_keys.numpy()),
                                  jmerge.lanes_to_words((blob[:, 0], blob[:, 1])))
    np.testing.assert_array_equal(hit_sums.numpy(), blob[:, 2:].astype(np.int32))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(out["hit_rows"])[:nh])
    np.testing.assert_array_equal(geno.numpy(), np.asarray(out["geno_rows"])[:ng])
    # the packed branch keeps the same survivors
    pk, pc, _ = merge_dev.build_triples_packed(kmers, counts, nbc)
    nd2, hk2, hs2 = merge_dev.merge_lrt(torch.from_numpy(pk), torch.from_numpy(pc),
                                        ratio_c, ratio_k, lr_min)
    assert nd2 == nd and torch.equal(hk2, hit_keys)
    assert torch.equal(hs2.to(torch.int64), hit_sums)


def test_run_rows_twin_edge_cases():
    """Empty selection, a run at the end of the valid rows, a sample id
    past S (ignored) and the presence form."""
    keys = torch.tensor([5, 5, 5, 9, 12, 12], dtype=torch.int64)
    starts = torch.tensor([0, 3, 4])
    n_valid = torch.tensor([6])
    perm = torch.tensor([2, 0, 1, 3, 5, 4])
    # raw u32 counts in int32: 2^31 + 16 is negative there and present
    count = torch.tensor([3, -0x7FFFFFF0, 0, 7, 1, 2], dtype=torch.int32)
    sample = torch.tensor([0, 1, 2, 1, 0, 9], dtype=torch.int16)
    assert keys.numel() == perm.numel()
    none = merge_dev.run_rows(starts, n_valid, torch.zeros(0, dtype=torch.int64),
                              perm, count, sample, 3)
    assert none.shape == (0, 3) and none.dtype == torch.int32
    rows = merge_dev.run_rows(starts, n_valid, torch.tensor([0, 2]), perm, count,
                              sample, 3)
    assert rows.tolist() == [[3, -0x7FFFFFF0, 0], [1, 0, 0]]
    assert rows.numpy().view(np.uint32)[0, 1] == 2**31 + 16
    pres = merge_dev.run_rows(starts, n_valid, torch.tensor([0, 1, 2]), perm,
                              count, sample, 3, presence=True)
    assert pres.dtype == torch.uint8
    assert pres.tolist() == [[1, 1, 0], [0, 1, 0], [1, 0, 0]]


@pytest.mark.parametrize("B,S", [(0, 5), (1, 3), (1000, 12), (333, 37)])
def test_int_gram_matches_jax(B, S):
    rng = np.random.default_rng(B + S)
    X = (rng.random((B, S)) < 0.3).astype(np.uint8)
    want = jpca._int_gram(X, block_rows=64)
    got = pca.int_gram(torch.from_numpy(X))
    assert got.dtype == torch.int64 and got.shape == (S, S)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


#: K-GRAM's edges: rows around its 32-row words and 2^16 + 7; samples
#: around its 8-sample micro-tiles, 32-sample slabs and two forms (256
#: fused, 257 tiled)
GRAM_B = [31, 32, 33, 63, 64, 65, (1 << 16) + 7]
GRAM_S = [1, 16, 17, 20, 33, 200, 256, 257]


@pytest.mark.parametrize("S", GRAM_S)
@pytest.mark.parametrize("B", GRAM_B)
def test_int_gram_edges_match_jax(B, S):
    """The twin against the JAX Gram (through its device tiles past 64
    rows) at K-GRAM's edge shapes, on values 0..3 (any nonzero counts as
    1, as the JAX PCA's 0/1 geno matrix has it)."""
    rng = np.random.default_rng(B * 1000 + S)
    X = ((rng.random((B, S)) < 0.35) * rng.integers(1, 4, (B, S))).astype(np.uint8)
    want = jpca._int_gram((X != 0).astype(np.uint8), block_rows=64)
    got = pca.int_gram(torch.from_numpy(X))
    assert got.dtype == torch.int64 and got.shape == (S, S)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


@pytest.mark.parametrize("fill", [0, 1])
@pytest.mark.parametrize("B,S", [(65, 20), ((1 << 16) + 7, 257)])
def test_int_gram_constant_blocks_match_jax(B, S, fill):
    X = np.full((B, S), fill, np.uint8)
    want = jpca._int_gram(X, block_rows=64)
    np.testing.assert_array_equal(pca.int_gram(torch.from_numpy(X)).numpy(), want)
    assert int(want.max()) == B * fill


@pytest.mark.parametrize("diploid", [True, False])
@pytest.mark.parametrize("M", [0, 2500])
def test_eigenstrat_pca_matches_jax_bitwise(diploid, M):
    rng = np.random.default_rng(M + diploid)
    S = 24
    pop = np.repeat([0, 1], S // 2)
    base = rng.uniform(0.1, 0.9, M)
    shift = np.where(rng.random(M) < 0.5, 0.25, -0.25)
    probs = np.clip(base[:, None] + shift[:, None] * pop[None, :], 0.02, 0.98)
    geno = (rng.random((M, S)) < probs).astype(np.uint8)
    # a small block_rows forces the JAX package's device tiles
    Zj, ej = jpca.eigenstrat_pca(geno, is_diploid=diploid, n_evec=10,
                                 block_rows=128)
    Zt, et = pca.eigenstrat_pca(geno, CPU, is_diploid=diploid, n_evec=10)
    np.testing.assert_array_equal(Zt, Zj)
    np.testing.assert_array_equal(et, ej)


def _alt_designs(rng, n, F, B):
    """Popstrat's alt-fit inputs: a conditioned shared design and per-item
    centered, max-abs-scaled ratio columns; item 0's ratios are constant
    (a zero column: singular), item 1 separates the labels."""
    y = np.concatenate([np.ones(n // 2), np.zeros(n - n // 2)])
    X = np.column_stack([np.ones(n), rng.normal(size=(n, F - 3)),
                         rng.uniform(5.9e6, 6.1e6, n)])
    Xc, _c, _s = _condition_design(X)
    Xb = np.column_stack([Xc, np.zeros(n)])
    r = rng.gamma(2.0, 1.0, (B, n)) + 0.3 * y
    r[0] = 1.0
    r[1] = np.where(y == 1, 2.0, 1.0)
    r = r - r.mean(1, keepdims=True)
    r = r / np.maximum(np.abs(r).max(1, keepdims=True), 1e-300)
    return Xb, r, y


@pytest.mark.parametrize("n,F,B,seed", [(20, 5, 64, 1), (48, 8, 40, 2)])
def test_irls_lastcol_matches_jax(n, F, B, seed):
    Xb, last, y = _alt_designs(np.random.default_rng(seed), n, F, B)
    f32 = jnp.float32
    Wj, _ej, itj = jglm.batched_irls_lastcol(jnp.asarray(Xb, f32),
                                             jnp.asarray(last, f32),
                                             jnp.asarray(y, f32), 500)
    llj = np.asarray(jglm.log_likelihood_lastcol(
        jnp.asarray(Xb, f32), jnp.asarray(last, f32), Wj, jnp.asarray(y, f32)))
    Wj, itj = np.asarray(Wj), np.asarray(itj)

    t = lambda a: torch.tensor(a, dtype=glm.default_dtype())  # noqa: E731
    W, _e, it, ll, stop = glm.irls(t(Xb)[None], t(last), t(y), 500)
    np.testing.assert_array_equal(it.numpy(), itj)
    np.testing.assert_allclose(ll.numpy(), llj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(W.numpy(), Wj, rtol=1e-3, atol=1e-4)
    # the singular item froze at the starting weights after one solve
    assert stop[0] == 1 and it[0] == 1 and np.all(Wj[0] == 1.0)
    assert torch.equal(W[0], torch.ones(F))
    assert (stop[1:] != 1).all()
    assert ll[1] > -1e-2  # the separable item fits its labels
    # the wrappers return the JAX package's triple
    W2, _e2, it2 = glm.batched_irls_lastcol(t(Xb), t(last), t(y))
    assert torch.equal(W2, W) and torch.equal(it2, it)
    np.testing.assert_allclose(
        glm.log_likelihood_lastcol(t(Xb), t(last), W, t(y)).numpy(),
        ll.numpy(), rtol=1e-6, atol=1e-6)


def test_null_fit_matches_jax():
    """The null fit's form: one full design, no replaced column."""
    rng = np.random.default_rng(9)
    n = 30
    y = np.concatenate([np.ones(15), np.zeros(15)])
    X = np.column_stack([np.ones(n), y + rng.normal(0, 1.5, n),
                         rng.normal(size=n), rng.uniform(5.9e6, 6.1e6, n)])
    Xc, _c, _s = _condition_design(X)
    f32 = jnp.float32
    Wj, _e, itj = jglm.batched_irls(jnp.asarray(Xc[None], f32), jnp.asarray(y, f32))
    llj = np.asarray(jglm.log_likelihood(jnp.asarray(Xc[None], f32), Wj,
                                         jnp.asarray(y, f32)))
    Xt = torch.tensor(Xc[None], dtype=torch.float32)
    yt = torch.tensor(y, dtype=torch.float32)
    W, _e, it, ll, stop = glm.irls(Xt, None, yt)
    assert int(it[0]) == int(itj[0]) > 2 and int(stop[0]) == 0
    np.testing.assert_allclose(ll.numpy(), llj, rtol=1e-5)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(glm.log_likelihood(Xt, W, yt).numpy(), ll.numpy(),
                               rtol=1e-6)
    assert torch.equal(glm.batched_irls(Xt, yt)[0], W)


def test_irls_twin_refuses_reduced_precision():
    X = torch.ones((1, 4, 2))
    y = torch.tensor([1.0, 0.0, 1.0, 0.0])
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full f32"):
            glm.irls(X, None, y)
    finally:
        torch.set_float32_matmul_precision("highest")
