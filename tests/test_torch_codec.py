"""The port's codec (kmdiff_tpu_torch.ops.codec, io.fasta, pipeline.count
helpers) against the JAX package's, on the same numpy-seeded inputs. Every
comparison is exact: keys, counts, indices and partition ids are integers.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmdiff_tpu.io.fasta import flat_codes as jax_flat_codes
from kmdiff_tpu.ops import codec as jcodec
from kmdiff_tpu.ops.merge_dev import _compact_indices
from kmdiff_tpu.pipeline.count import host_partition_ids as jax_partition_ids
from kmdiff_tpu_torch.io.fasta import flat_codes
from kmdiff_tpu_torch.ops import codec
from kmdiff_tpu_torch.pipeline.count import _host_code_chunks, host_partition_ids


def _codes(rng, n, invalid_rate=0.02):
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < invalid_rate] = codec.INVALID
    return codes


def _jax_words(codes, k):
    lanes, _ok = jcodec.extract_canonical_lanes(jnp.asarray(codes), k,
                                                mask_invalid=True)
    return jcodec.lanes_to_words(tuple(np.asarray(l) for l in lanes))


@pytest.mark.parametrize("k", [1, 5, 21, 31, 32])
def test_canonical_kmers_match_jax_extraction(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 3000)
    codes[100:140] = 3  # an all-G stretch: at k=32 its word is all ones
    keys = codec.canonical_kmers(torch.from_numpy(codes), k)
    assert keys.dtype == torch.int64 and keys.numel() == len(codes) - k + 1
    np.testing.assert_array_equal(codec.keys_to_words(keys.numpy()),
                                  _jax_words(codes, k))
    # sentinel <-> invalid window, and int64 order == u64 word order
    words = codec.keys_to_words(keys.numpy())[:, 0]
    valid = keys.numpy() != codec.SENTINEL
    assert (words[~valid] == np.uint64(2**64 - 1)).all()
    order = np.argsort(keys.numpy(), kind="stable")
    assert (np.diff(words[order].astype(object)) >= 0).all()


def test_canonical_kmers_short_input_and_k_range():
    assert codec.canonical_kmers(torch.zeros(3, dtype=torch.uint8), 5).numel() == 0
    with pytest.raises(ValueError, match="k=129"):
        codec.canonical_kmers(torch.zeros(200, dtype=torch.uint8), 129)


@pytest.mark.parametrize("k", [5, 31])
def test_sort_rle_matches_jax_count(k):
    rng = np.random.default_rng(10 + k)
    # a small alphabet of repeats makes long runs
    codes = _codes(rng, 5000)
    codes[1000:3000] = np.tile(codes[:40], 50)
    lanes, _ = jcodec.extract_canonical_lanes(jnp.asarray(codes), k,
                                              mask_invalid=True)
    W = len(codes) - k + 1
    stats, blob, counts = jcodec.count_sort_rle_lanes(lanes, W)
    U = int(np.asarray(stats)[0])
    blob = np.asarray(blob)[:U]
    ref_words = jcodec.lanes_to_words((blob[:, 0], blob[:, 1]))
    ref_counts = np.asarray(counts)[:U]

    keys, cnt = codec.fused_count(torch.from_numpy(codes), k)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(codec.keys_to_words(keys.numpy()), ref_words)
    np.testing.assert_array_equal(cnt.numpy().astype(np.uint32), ref_counts)
    assert int(cnt.max()) > 40  # the repeat made runs longer than the window


def test_run_kernels_plain_twins_on_sentinel_tail():
    keys = torch.tensor([-5, -5, 0, 7, 7, 7, codec.SENTINEL, codec.SENTINEL])
    flags, n_valid = codec.run_flags_plain(keys)
    assert flags.tolist() == [True, False, True, True, False, False, False, False]
    assert n_valid.tolist() == [6]
    starts, run_keys, n_valid, lengths = codec.run_encode(keys, lengths=True)
    assert starts.tolist() == [0, 2, 3] and run_keys.tolist() == [-5, 0, 7]
    assert n_valid.tolist() == [6] and lengths.tolist() == [2, 1, 3]
    assert codec.run_encode(keys)[3] is None
    no_starts = codec.run_encode(keys, lengths=True, starts=False)
    assert no_starts[0] is None and no_starts[1].tolist() == [-5, 0, 7]
    assert no_starts[3].tolist() == [2, 1, 3]
    perm = torch.tensor([7, 0, 1, 2, 3, 4, 5, 6])
    count = torch.tensor([3, -0x8000 | 4, 5, 6, -0x8000 | 1, 2, 9, 9],
                         dtype=torch.int16)
    # the sorted rows read count[perm] = 9 3 | c4 | 5 6 c1 (c: control)
    _s, _k, _n, sums = codec.run_encode(keys, perm, count)
    assert sums.tolist() == [[0, 12], [4, 0], [1, 11]]
    empty = torch.empty(0, dtype=torch.int64)
    starts, run_keys, n_valid, lengths = codec.run_encode(empty, lengths=True)
    assert starts.numel() == run_keys.numel() == lengths.numel() == 0
    assert n_valid.tolist() == [0]


@pytest.mark.parametrize("form", ["dedup", "count", "merge16", "merge32"])
def test_run_encode_forms_match_numpy(form):
    """run_encode's plain twin in every form against numpy's unique on
    sorted keys with long runs and a sentinel tail."""
    rng = np.random.default_rng(len(form))
    n = 20_000
    raw = rng.integers(0, 3000, n)
    raw[:4000] = 17  # one run far longer than any tile
    raw[-300:] = codec.SENTINEL
    order = np.argsort(raw, kind="stable")
    keys = raw[order]
    valid = keys != codec.SENTINEL
    want_keys, want_starts, want_len = np.unique(keys[valid], return_index=True,
                                                 return_counts=True)
    perm = count = None
    if form.startswith("merge"):
        dt = np.int16 if form == "merge16" else np.int32
        flag = 0x8000 if dt == np.int16 else 0x80000000
        value = rng.integers(0, 1 << 15 if dt == np.int16 else 1 << 20, n)
        ctrl = rng.random(n) < 0.5
        count = np.where(ctrl, value | flag, value).astype(dt)
        perm = order
    starts, run_keys, n_valid, third = codec.run_encode(
        torch.from_numpy(keys), None if perm is None else torch.from_numpy(perm),
        None if count is None else torch.from_numpy(count), lengths=form == "count")
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    np.testing.assert_array_equal(run_keys.numpy(), want_keys)
    assert n_valid.tolist() == [int(valid.sum())]
    if form == "dedup":
        assert third is None
    elif form == "count":
        np.testing.assert_array_equal(third.numpy(), want_len)
    else:
        rows = np.repeat(np.arange(len(want_keys)), want_len)
        c, v = ctrl[perm][: len(rows)], value[perm][: len(rows)]
        want = np.stack([np.bincount(rows, np.where(c, v, 0), len(want_keys)),
                         np.bincount(rows, np.where(c, 0, v), len(want_keys))], 1)
        np.testing.assert_array_equal(third.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("density", [0.0, 0.001, 0.3, 1.0])
def test_compact_matches_compact_indices(density):
    rng = np.random.default_rng(int(density * 1000))
    mask = rng.random(20_000) < density
    payload = rng.integers(-2**62, 2**62, len(mask))
    idx, got = codec.compact(torch.from_numpy(mask), torch.from_numpy(payload))
    n = int(mask.sum())
    ref = np.asarray(_compact_indices(jnp.asarray(mask), max(n, 1), -1))[:n]
    np.testing.assert_array_equal(idx.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), payload[ref])
    idx2, none = codec.compact(torch.from_numpy(mask))
    assert none is None and torch.equal(idx, idx2)


def test_partition_ids_match_jax():
    rng = np.random.default_rng(4)
    kmers = rng.integers(0, 2**63, (5000, 1), dtype=np.uint64) * np.uint64(2)
    for P in (1, 4, 7, 64):
        np.testing.assert_array_equal(host_partition_ids(kmers, P),
                                      jax_partition_ids(kmers, P))


def test_host_helpers_match_jax():
    rng = np.random.default_rng(5)
    ascii_ = np.frombuffer(b"ACGTNacgtxRY-" * 50, dtype=np.uint8)
    np.testing.assert_array_equal(codec.encode_ascii_block(ascii_),
                                  jcodec.encode_ascii_block(ascii_))
    # int64 keys sort as the JAX package's (hi, lo) u32 lanes sort
    words = rng.integers(0, 2**63, (1000, 1), dtype=np.uint64) * np.uint64(2)
    words[:5, 0] = [0, 1, 2**63, 2**64 - 2, 2**63 - 1]
    keys = codec.words_to_keys(words)
    hi, lo = jcodec.words_to_lanes(words)
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"),
                                  np.lexsort((lo, hi)))
    np.testing.assert_array_equal(codec.keys_to_words(keys), words)
    # multi-word k-mers round-trip through [nw, n] word-major keys
    two = np.stack([words[:, 0], words[::-1, 0]], 1)
    assert codec.words_to_keys(two).shape == (2, len(two))
    np.testing.assert_array_equal(codec.keys_to_words(codec.words_to_keys(two)), two)


def test_code_chunks_cover_every_window_once():
    rng = np.random.default_rng(6)
    files = [_codes(rng, n) for n in (500, 37, 1200)]
    k = 21
    chunks = _host_code_chunks(files, k, sort_rows=300)
    joined = np.concatenate([files[0], [codec.INVALID], files[1],
                             [codec.INVALID], files[2]]).astype(np.uint8)
    windows = sum(len(c) - k + 1 for c in chunks)
    assert windows == len(joined) - k + 1
    assert all(len(c) - k + 1 <= 300 for c in chunks)
    got = np.concatenate([_jax_words(c, k) for c in chunks])
    np.testing.assert_array_equal(got, _jax_words(joined, k))


def test_flat_codes_match_jax(tmp_path):
    fa = tmp_path / "a.fasta"
    fa.write_bytes(b">r1 desc\nACGTNNAC\nGTAC\n>r2\nTTTTGG\n")
    fq = tmp_path / "b.fastq"
    fq.write_bytes(b"@r1\nACGTAC\n+\nIIIIII\n@r2\nGGGTTA\n+\nIIIIII\n")
    bad = tmp_path / "c.fastq"
    bad.write_bytes(b"@r1\nACGT\nAC\n+\nIIIIII\n")
    gz = tmp_path / "d.fasta.gz"
    with gzip.open(gz, "wb") as f:
        f.write(b">x\nACGTACGT\n")
    for p in (fa, fq, bad, gz):
        np.testing.assert_array_equal(flat_codes(str(p)),
                                      jax_flat_codes(str(p)))
