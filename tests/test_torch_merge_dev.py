"""The port's device merge (kmdiff_tpu_torch.ops.merge_dev and the
PartitionProcessor merge path) against the JAX package's packed
merge_lrt_kernel, on random sorted streams. n_distinct, n_hits, the
survivor keys and their sums must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmdiff_tpu.core.model import PoissonLikelihood
from kmdiff_tpu.io.accumulator import KmerSignBlock, VectorAccumulator
from kmdiff_tpu.ops import merge_dev as jmerge
from kmdiff_tpu.ops.lrt import LrtParams
from kmdiff_tpu.pipeline.merge import PartitionProcessor as JaxProcessor
from kmdiff_tpu_torch.core.model import PoissonLikelihood as TPoissonLikelihood
from kmdiff_tpu_torch.ops import codec
from kmdiff_tpu_torch.ops import merge_dev
from kmdiff_tpu_torch.pipeline import merge as tmerge

CPU = torch.device("cpu")


def _streams(rng, S, n_pool=3000, per=1500, max_count=200):
    pool = np.unique(rng.integers(0, 2**62, n_pool, dtype=np.uint64) * 3)
    kmers, counts = [], []
    for s in range(S):
        take = np.sort(rng.choice(len(pool), per, replace=False))
        kmers.append(pool[take].reshape(-1, 1))
        c = rng.integers(1, max_count, per, dtype=np.uint32)
        # planted group differences: a shifted block of k-mers per group
        if s < S // 2:
            c[: per // 10] *= 20
        counts.append(c)
    return kmers, counts


def _jax_merge(kmers, counts, nbc, params, pack16):
    N = sum(len(k) for k in kmers)
    pad_to = 1 << max(12, (N - 1).bit_length())
    lanes, count, _ = jmerge.build_triples_packed(kmers, counts, pad_to, nbc,
                                                  pack16=pack16)
    out = jmerge.merge_lrt_kernel(
        tuple(jnp.asarray(l.copy()) for l in lanes), jnp.zeros(1, jnp.int32),
        jnp.asarray(count.copy()), nbc, jnp.float32(params.ratio_c),
        jnp.float32(params.ratio_k), jnp.float32(params.lr_min),
        jnp.uint32(0), jnp.uint32(0), pad_to, 1, False, packed_ctrl=True,
    )
    nh = int(out["n_hits"])
    blob = np.asarray(out["hit_blob"])[:nh]
    words = jmerge.lanes_to_words((blob[:, 0], blob[:, 1]))
    return int(out["n_distinct"]), words, blob[:, 2:].astype(np.int64)


@pytest.mark.parametrize("pack16", [False, True])
@pytest.mark.parametrize("S,nbc", [(2, 1), (6, 3)])
def test_merge_lrt_matches_packed_kernel(pack16, S, nbc):
    rng = np.random.default_rng(S * 10 + pack16)
    kmers, counts = _streams(rng, S)
    assert merge_dev.pack16_ok(counts)
    params = LrtParams(nbc, S - nbc, 10**6, 2 * 10**6, 1e-3)
    n_distinct, words, sums = _jax_merge(kmers, counts, nbc, params, pack16)

    keys, count, N = merge_dev.build_triples_packed(kmers, counts, nbc,
                                                    pack16=pack16)
    assert count.dtype == (np.int16 if pack16 else np.int32)
    assert N == len(keys) == sum(len(k) for k in kmers)
    nd, hit_keys, hit_sums = merge_dev.merge_lrt(
        torch.from_numpy(keys), torch.from_numpy(count), params.ratio_c,
        params.ratio_k, params.lr_min)
    assert nd == n_distinct
    assert len(hit_keys) == len(words) > 0
    np.testing.assert_array_equal(codec.keys_to_words(hit_keys.numpy()), words)
    np.testing.assert_array_equal(hit_sums.numpy(), sums)


def test_pack16_and_p32_agree_and_pack16_ok():
    rng = np.random.default_rng(3)
    kmers, counts = _streams(rng, 4)
    outs = []
    for p16 in (False, True):
        keys, count, _ = merge_dev.build_triples_packed(kmers, counts, 2,
                                                        pack16=p16)
        nd, hk, hs = merge_dev.merge_lrt(torch.from_numpy(keys),
                                         torch.from_numpy(count), 0.5, 0.5, 2.0)
        outs.append((nd, hk.tolist(), hs.tolist()))
    assert outs[0] == outs[1]
    big = [c.copy() for c in counts]
    big[1][0] = 1 << 15
    assert not merge_dev.pack16_ok(big)


def test_quantile_key_split_matches_jax():
    rng = np.random.default_rng(8)
    kmers, _ = _streams(rng, 3)
    for grow in (True, False):
        a = merge_dev.quantile_key_split(kmers, 4, lambda r: 4000 // r + 900,
                                         grow=grow, attempts=3,
                                         best_effort=True)
        b = jmerge.quantile_key_split(kmers, 4, lambda r: 4000 // r + 900,
                                      grow=grow, attempts=3, best_effort=True)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] and a[2] == b[2]


def _blocks(acc):
    return KmerSignBlock.concat(list(acc.blocks()))


@pytest.mark.parametrize("chunk_rows", [None, 1500])
def test_partition_merge_matches_jax_processor(chunk_rows, monkeypatch):
    """The group pre-sum + device merge + f64 rescore of one partition,
    single-shot and in key-range chunks, against the JAX processor."""
    rng = np.random.default_rng(11)
    S, nbc = 6, 3
    kmers, counts = _streams(rng, S)
    totals = ([300_000] * nbc, [350_000] * (S - nbc))
    model = PoissonLikelihood(nbc, S - nbc, *totals)
    threshold = 1e-4
    ref_acc = VectorAccumulator()
    ref = JaxProcessor(model, nbc, S - nbc, threshold)._process_device_merge(
        0, kmers, counts, ref_acc, 31)
    if chunk_rows:
        monkeypatch.setattr(tmerge, "MAX_DEVICE_ROWS", chunk_rows)
    acc = VectorAccumulator()
    res = tmerge.PartitionProcessor(TPoissonLikelihood(nbc, S - nbc, *totals),
                                    nbc, S - nbc, threshold, CPU
                                    )._process_device_merge(0, kmers, counts, acc)
    assert (res.total_kmers, res.nb_sign, res.sign_controls, res.sign_cases) == (
        ref.total_kmers, ref.nb_sign, ref.sign_controls, ref.sign_cases)
    assert res.nb_sign > 0
    got, want = _blocks(acc), _blocks(ref_acc)
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.pvalues, want.pvalues)
    np.testing.assert_array_equal(got.signs, want.signs)
    np.testing.assert_array_equal(got.mean_control, want.mean_control)
    np.testing.assert_array_equal(got.mean_case, want.mean_case)


def test_processor_rejects_unported_models():
    class Custom(TPoissonLikelihood):
        pass

    from kmdiff_tpu_torch.examples.plugins.fold_change_model import FoldChangeModel
    from kmdiff_tpu_torch.plugins import PluginError

    # a plugin model is accepted (it scores the host union merge, no K-LRT);
    # a model with no block ABI is refused
    plugin = tmerge.PartitionProcessor(FoldChangeModel(), 1, 1, 0.1, CPU)
    assert plugin.abi == "numpy" and plugin.params is None
    with pytest.raises(PluginError, match="process_block_torch"):
        tmerge.PartitionProcessor(object(), 1, 1, 0.1, CPU)
    # a cohort whose k-mer mass reaches 2^31 is built and merges (the wide
    # sums), as the JAX processor merges it
    totals = ([2**31], [1])
    wide = tmerge.PartitionProcessor(TPoissonLikelihood(1, 1, *totals), 1, 1,
                                     0.5, CPU)
    assert wide.params.wide_sums and wide.full
    kmers = [np.array([[3], [9]], np.uint64), np.array([[9]], np.uint64)]
    counts = [np.array([2**31 + 7, 4], np.uint32), np.array([1], np.uint32)]
    acc, ref_acc = VectorAccumulator(), VectorAccumulator()
    res = wide._process_device_merge(0, kmers, counts, acc)
    ref = JaxProcessor(PoissonLikelihood(1, 1, *totals), 1, 1, 0.5
                       )._process_device_merge(0, kmers, counts, ref_acc, 31)
    assert res.total_kmers == ref.total_kmers == 2
    assert (res.nb_sign, res.sign_controls) == (ref.nb_sign, ref.sign_controls)
    if ref.nb_sign:
        got, want = _blocks(acc), _blocks(ref_acc)
        np.testing.assert_array_equal(got.kmers, want.kmers)
        np.testing.assert_array_equal(got.pvalues, want.pvalues)
    # subclasses of the Poisson model keep the device path
    assert tmerge.PartitionProcessor(Custom(1, 1, [5], [5]), 1, 1, 0.1,
                                     CPU).params is not None
