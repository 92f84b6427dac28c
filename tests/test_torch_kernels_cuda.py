"""The CUDA kernels of kmdiff_tpu_torch against their plain PyTorch twins
on the card, at small shapes with edge cases (empty inputs, ragged tails,
runs that cross tiles, k=1 and k=32); K-EXT at k = 1, 2, 15, 21, 31, 32
from one window to the largest count chunk, with an INVALID code at every
offset of a thread's run and of a tile's halo, all INVALID, and on views at
byte offsets 1..15; K-CMP also at five densities from
none to all rows, at more tiles than the card holds resident, on
misaligned views, on reused memory and from four host threads; K-ASM with
1, 2 and 20 streams, empty slices and both packings; K-WRUN with runs of 1
to 7 rows and hard-min; K-HIST (rle_stats) on u32 and int64 counts, empty,
ragged around its block step, on views at every element offset of a 16-byte
line, all ones, all above 255, u32 at and above 2^31, from four host
threads, one launch and one device operation a call; K-LRT in each of its
output forms for B = 0 to 4099 and S = 1 to 300, on offset views; K-ASM's
sample ids; K-GENO at four rates over keys with the top bit set and clear;
K-ROWS with empty selections, runs at the end of the valid rows and sample
ids past S, and on memory the allocator hands back filled with 0xFF (no
memset), at S = 20 and 200 and for an empty selection (no launch); the
full merge on the card against the CPU; the wide sums: K-RUN's full form
(raw u32 counts with sample ids, int64 sums past 2^32) across tile edges
and on offset views, K-LRT on int64 sums (the wide pairs form and a thread
a row), K-ROWS on counts of 2^31 and 2^32 - 1, K-ASM given no control
streams; K-GRAM at 0, 1 and ragged row
counts and S from 1 to 2000, at 31-65, 2^16 + 7 and 2^20 + 5 rows (blocks
in several super-chunks), all zero and all one, on views at odd byte
offsets and a second stream, one device operation a call up to 256
samples, and its tiled form from 257 to 16,385 samples; K-IRLS with singular, separable and
max-iteration items, F up to 64 and a design above 48 KB of shared memory,
and each item's outputs bit-identical alone and among 1,023 others; the
multi-word forms (k > 32, [nw, N] word-major keys) at nw = 2, 3 and 4:
K-EXT at k = 33-128 from one window to 70,001 codes with an all-G
stretch, all INVALID and byte-offset views, at a thread's run and a tile
plus or minus one window, with an INVALID code at a run's first and last
code and at window positions 31-96 where the carries cross words, on views
at byte offsets 1 to 15, K-RUN in all five forms at N =
1 to 9,001 around its tile, with sentinel tails, all sentinel, a run
across tiles and a view of a wider buffer, K-GENO on views, K-ASM with 1,
2 and 20 streams and empty slices, the merges and the resident count on
the card against the CPU; K-FASTA against its twin on random FASTA and
FASTQ bytes from one byte to 40 tiles, on views at byte offsets 1 to 15, on
an 8 MB sequence line behind a header over twelve tiles and on 1 MB FASTQ
lines, and through io.fasta.device_codes on a bench-shaped sample file and
a malformed FASTQ (the record parser's), one launch a file, also from four
threads.
They need an NVIDIA GPU and nvcc, and skip without one; run them on the card
with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Integers must be equal. lr within rtol 1e-6 and atol 1e-6: both sides use
the card's logf on the same f32 operands, without fused multiply-adds.
K-IRLS against its twin (cuBLAS products and a batched LU, other summation
orders, both f32): stop codes equal, iters equal on 99% of the items, ll
within rtol 1e-5 and atol 1e-4.
"""

import numpy as np
import pytest
import torch

from kmdiff_tpu_torch import kernels
from kmdiff_tpu_torch.ops import codec, glm, merge_dev, pca
from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter, lrt_filter_plain
from kmdiff_tpu_torch.ops.merge_dev import build_triples_packed, merge_lrt
from kmdiff_tpu_torch.pipeline import fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kernels.lib()
    return torch.device("cuda", 0)


def _eq(a, b):
    assert a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("B,S,nbc", [(0, 2, 1), (1, 2, 1), (4099, 2, 1),
                                     (3000, 20, 10), (777, 8, 3)])
def test_lrt_filter(dev, B, S, nbc):
    rng = np.random.default_rng(B + S)
    counts = torch.from_numpy(rng.integers(0, 500, (B, S), dtype=np.int32)).to(dev)
    before = kernels.launch_counts()["lrt_filter"]
    out = lrt_filter(counts, nbc, 0.45, 0.55, 5.0)
    ref = lrt_filter_plain(counts, nbc, 0.45, 0.55, 5.0)
    assert kernels.launch_counts()["lrt_filter"] == before + (1 if B else 0)
    _eq(out[2], ref[2])
    _eq(out[3], ref[3])
    torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=1e-6)
    _eq(out[0], ref[0])


@pytest.mark.parametrize("k", [1, 5, 21, 31, 32])
@pytest.mark.parametrize("n", [10, 257, 70_001])
def test_canonical_kmers(dev, k, n):
    rng = np.random.default_rng(k * n)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.01] = codec.INVALID
    codes[: min(n, 40)] = 3
    c = torch.from_numpy(codes).to(dev)
    _eq(codec.canonical_kmers(c, k), codec.canonical_kmers_plain(c, k))


K_EDGES = [1, 2, 15, 21, 31, 32]


def _ext_check(c, k):
    _eq(codec.canonical_kmers(c, k), codec.canonical_kmers_plain(c, k))


@pytest.mark.parametrize("k", K_EDGES)
def test_canonical_kmers_ragged_sizes(dev, k):
    """N from k (one window) to the largest count chunk, around a tile."""
    tile = kernels.lib().kmd_canonical_kmers_tile_windows()
    rng = np.random.default_rng(k)
    for n in (k, k + 1, tile + k - 2, tile + k - 1, tile + k,
              (1 << 24) - 128 + k - 1):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        codes[rng.random(n) < 0.003] = codec.INVALID
        _ext_check(torch.from_numpy(codes).to(dev), k)


@pytest.mark.parametrize("k", K_EDGES)
def test_canonical_kmers_invalid_at_every_offset(dev, k):
    """One INVALID code (and a run of two) at every offset of the first
    thread's run, around the boundary between two threads' runs and around
    the tile edge and its halo, in a 3-tile stream."""
    tile = kernels.lib().kmd_canonical_kmers_tile_windows()
    n = 3 * tile + k - 1
    rng = np.random.default_rng(100 + k)
    base = rng.integers(0, 4, n).astype(np.uint8)
    span = 64 + k
    positions = sorted({*range(0, span), *range(tile - span, tile + span),
                        *range(2 * tile - 8, 2 * tile + k + 8), n - 1})
    c = torch.from_numpy(base).to(dev)
    for p in positions:
        for run in (1, 2):
            codes = c.clone()
            codes[p : p + run] = int(codec.INVALID)
            _ext_check(codes, k)


@pytest.mark.parametrize("k", K_EDGES)
def test_canonical_kmers_all_invalid(dev, k):
    tile = kernels.lib().kmd_canonical_kmers_tile_windows()
    for n in (k, tile + k + 5):
        keys = codec.canonical_kmers(
            torch.full((n,), int(codec.INVALID), dtype=torch.uint8, device=dev), k)
        assert keys.numel() == n - k + 1
        assert bool((keys == codec.SENTINEL).all())


@pytest.mark.parametrize("k", K_EDGES)
def test_canonical_kmers_misaligned_views(dev, k):
    """A codes tensor that is a view at byte offsets 1..15 of its
    allocation: the head is read by bytes, nothing is refused."""
    tile = kernels.lib().kmd_canonical_kmers_tile_windows()
    rng = np.random.default_rng(200 + k)
    codes = rng.integers(0, 4, 2 * tile + 100).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = codec.INVALID
    base = torch.from_numpy(codes).to(dev)
    assert base.data_ptr() % 16 == 0
    for lead in range(1, 16):
        for n in (k, k + 17, tile + k - 1 - lead, 2 * tile + 100 - lead):
            view = base[lead : lead + n]
            assert view.data_ptr() % 16 == lead
            _ext_check(view, k)


def _check_runs(keys, perm=None, count=None, lengths=False, starts=True,
                sample=None, nb_controls=0):
    """run_encode in one form against its plain twin on the same tensors,
    in one launch."""
    before = kernels.launch_counts()["run_bounds"]
    got = codec.run_encode(keys, perm, count, lengths, starts, sample, nb_controls)
    assert kernels.launch_counts()["run_bounds"] == before + (1 if keys.numel() else 0)
    want = codec.run_encode_plain(keys, perm, count, lengths, starts, sample,
                                  nb_controls)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _eq(g, w)
    return got


def _run_forms(keys, rng):
    """Every form of run_encode on sorted keys: dedup, count, and merge
    with int16 and int32 packed counts read through a permutation; the
    count and merge forms with and without their starts."""
    _check_runs(keys)
    n = keys.numel()
    perm = torch.from_numpy(rng.permutation(n)).to(keys.device)
    for starts in (True, False):
        _check_runs(keys, lengths=True, starts=starts)
        for dtype in (torch.int16, torch.int32):
            count = torch.from_numpy(rng.integers(-30000, 30000, n)).to(keys.device, dtype)
            _check_runs(keys, perm, count, starts=starts)


def _sorted(raw, dev):
    return torch.sort(torch.from_numpy(np.asarray(raw, np.int64)).to(dev)).values


@pytest.mark.parametrize("n", [1, 4096, 4097, 100_003])
def test_runs_and_compaction(dev, n):
    rng = np.random.default_rng(n)
    raw = rng.integers(0, max(2, n // 3), n).astype(np.int64)
    raw[rng.random(n) < 0.05] = codec.SENTINEL
    keys = _sorted(raw, dev)
    _run_forms(keys, rng)
    flags, _ = codec.run_flags_plain(keys)
    _check_compact(flags, keys)
    _check_compact(flags, None)


@pytest.mark.parametrize("form", [1, 2])
def test_run_encode_tile_edges(dev, form):
    """At the tile of the count and dedup forms (form 1) and of the merge
    forms (form 2): runs of 1 to a tile + 3 rows from row 0, so that runs
    cross, end on and start on tile edges, at N around one and three
    tiles; a sentinel tail that starts one row before, exactly at and one
    row after a tile edge."""
    tile = kernels.lib().kmd_run_encode_tile_rows(form)
    rng = np.random.default_rng(11)
    for n in (tile - 1, tile, tile + 1, 3 * tile + 5):
        for run_len in (1, 2, 7, 33, tile + 3):
            _run_forms(_sorted(np.arange(n) // run_len, dev), rng)
        for at in (tile - 1, tile, tile + 1):
            if at < n:
                raw = np.sort(rng.integers(0, n // 3, n))
                raw[at:] = codec.SENTINEL
                starts, _k, n_valid, _l = _check_runs(_sorted(raw, dev), lengths=True)
                assert int(n_valid) == at and int(starts[-1]) < at


def test_run_encode_long_run_and_degenerate_inputs(dev):
    """One run of 10^5 rows across many tiles (the count form's search for
    its end, the merge form's tail), all sentinel, N = 1, one key."""
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 1000, 300_000)
    raw[1000:101_000] = 500
    keys = _sorted(raw, dev)
    _run_forms(keys, rng)
    assert int(codec.run_encode(keys, lengths=True)[3].max()) >= 100_000
    for raw in ([codec.SENTINEL] * 5000, [codec.SENTINEL], [42], [3] * 9000,
                [-(2**63), 2**63 - 2, codec.SENTINEL]):
        _run_forms(_sorted(raw, dev), rng)
    starts, run_keys, n_valid, _ = codec.run_encode(_sorted([codec.SENTINEL] * 5000, dev))
    assert starts.numel() == run_keys.numel() == 0 and int(n_valid) == 0


def test_run_encode_misaligned_views(dev):
    """Keys that are a view at an 8-byte offset of their allocation."""
    tile = kernels.lib().kmd_run_encode_tile_rows(1)
    rng = np.random.default_rng(13)
    raw = np.sort(rng.integers(0, tile, 3 * tile + 100))
    raw[-50:] = codec.SENTINEL
    base = _sorted(raw, dev)
    for lead in (1, 3):
        view = base[lead:]
        assert view.data_ptr() % 16 == 8
        _run_forms(view, rng)


def test_run_encode_merge_runs_across_tile_edges(dev):
    """The merge form at its callers' shape: 20 sorted distinct streams, one
    row a stream in a run, so runs of 1 to 20 rows, many across tile
    edges."""
    tile = kernels.lib().kmd_run_encode_tile_rows(2)
    rng = np.random.default_rng(14)
    pool = np.unique(rng.integers(-(2**62), 2**62, 12_000))
    common = pool[:2000]
    parts = [np.union1d(common, rng.choice(pool, 4000, replace=False)) for _ in range(20)]
    keys, perm = torch.sort(torch.from_numpy(np.concatenate(parts)).to(dev))
    starts, _k, _n, lengths = _check_runs(keys, lengths=True)
    assert int(lengths.max()) == 20
    ends = starts + lengths.long() - 1
    assert bool(((starts // tile) != (ends // tile)).any())
    for dtype in (torch.int16, torch.int32):
        count = torch.from_numpy(rng.integers(-30000, 30000, keys.numel())).to(dev, dtype)
        _check_runs(keys, perm, count)


def test_run_encode_from_four_threads(dev):
    """Back-to-back calls from four host threads, as the count pipeline's
    sample threads make them, each freeing its outputs before the next, so
    the caching allocator hands back memory with earlier status words."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(15)
    cases = []
    for i in range(12):
        n = 100_000 + 4099 * i
        raw = np.sort(rng.integers(0, n // (1 + i % 4), n))
        raw[n - 37 * i :] = codec.SENTINEL
        cases.append(_sorted(raw, dev))

    def encode(keys):
        return [t.cpu() for t in codec.run_encode(keys, lengths=True)]

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(encode, cases))
    for keys, got in zip(cases, results):
        for g, w in zip(got, codec.run_encode_plain(keys, lengths=True)):
            _eq(g, w)


def test_compact_empty_and_full(dev):
    for mask in (torch.zeros(5000, dtype=torch.bool, device=dev),
                 torch.ones(5000, dtype=torch.bool, device=dev),
                 torch.zeros(0, dtype=torch.bool, device=dev)):
        idx, _ = codec.compact(mask)
        _eq(idx, codec.compact_plain(mask)[0])


# K-CMP at the densities of its callers: none, the LRT survivors (~0.1%),
# half, run starts (~98%) and all rows
DENSITIES = (0.0, 0.001, 0.5, 0.98, 1.0)


def _mask(rng, n, density, dev):
    return torch.from_numpy(rng.random(n) < density).to(dev)


def _payload(n, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-(2**62), 2**62, (n,), generator=gen, device=dev)


def _check_compact(mask, payload):
    """K-CMP's outputs against compact_plain's, element for element."""
    idx, out = codec.compact(mask, payload)
    idx_p, out_p = codec.compact_plain(mask, payload)
    _eq(idx, idx_p)
    if payload is None:
        assert out is None
    else:
        _eq(out, out_p)


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
def test_compact_sizes_around_tiles(dev, density, with_payload):
    tile = kernels.lib().kmd_compact_tile_rows()
    rng = np.random.default_rng(int(density * 1000) + with_payload)
    for n in (1, 15, 16, 17, tile - 1, tile, tile + 1, 3 * tile - 1,
              3 * tile, 3 * tile + 1):
        mask = _mask(rng, n, density, dev)
        payload = _payload(n, dev, n) if with_payload else None
        before = kernels.launch_counts()["compact"]
        _check_compact(mask, payload)
        assert kernels.launch_counts()["compact"] == before + 1


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
def test_compact_many_tiles(dev, density, with_payload):
    """More tiles than the card holds resident, so the look-back waits on
    tiles whose blocks started late."""
    n = 3 * (1 << 22) + 7
    rng = np.random.default_rng(int(density * 1000))
    mask = _mask(rng, n, density, dev)
    _check_compact(mask, _payload(n, dev, 1) if with_payload else None)


@pytest.mark.parametrize("density", DENSITIES)
def test_compact_misaligned_views(dev, density):
    tile = kernels.lib().kmd_compact_tile_rows()
    rng = np.random.default_rng(int(density * 1000) + 2)
    base = _mask(rng, 4 * tile, density, dev)
    values = _payload(4 * tile, dev, 3)
    for lead in (1, 3, 8, 15):
        for n in (1, 17, tile - lead, tile + 5, 3 * tile + 9):
            mask = base[lead : lead + n]
            assert mask.data_ptr() % 16 == lead
            _check_compact(mask, values[1 : 1 + n])
            _check_compact(mask, None)


def test_compact_back_to_back_calls(dev):
    """Consecutive calls on one stream, each freeing its outputs before the
    next: the caching allocator hands the same memory back, with the last
    call's tile status words in it, which each call must clear before its
    tiles read them."""
    rng = np.random.default_rng(5)
    n = 5 * kernels.lib().kmd_compact_tile_rows() + 3
    payload = _payload(n, dev, 5)
    masks = [_mask(rng, n, d, dev) for d in (0.98, 0.001, 1.0, 0.0, 0.5, 0.98)]
    got, ptrs = [], []
    for m in masks:
        idx, out = codec.compact(m, payload)
        ptrs.append(idx.data_ptr())
        got.append((idx.cpu(), out.cpu()))
        del idx, out
    assert len(set(ptrs)) < len(ptrs), "no call reused a freed allocation"
    for m, (idx, out) in zip(masks, got):
        idx_p, out_p = codec.compact_plain(m, payload)
        _eq(idx, idx_p)
        _eq(out, out_p)


def test_compact_from_four_threads(dev):
    """Four host threads compacting at once, as the count pipeline's sample
    threads do."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(6)
    cases = []
    for i, d in enumerate((0.98, 0.001, 0.5, 1.0) * 3):
        n = 200_000 + 4099 * i
        cases.append((_mask(rng, n, d, dev), _payload(n, dev, i)))
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda c: codec.compact(*c), cases))
    for (m, p), (idx, out) in zip(cases, results):
        idx_p, out_p = codec.compact_plain(m, p)
        _eq(idx, idx_p)
        _eq(out, out_p)


def test_merge_lrt_cuda_matches_cpu(dev):
    rng = np.random.default_rng(1)
    pool = np.unique(rng.integers(0, 2**62, 20_000, dtype=np.uint64))
    kmers, counts = [], []
    for s in range(2):
        take = np.sort(rng.choice(len(pool), 12_000, replace=False))
        kmers.append(pool[take].reshape(-1, 1))
        counts.append(rng.integers(1, 100 if s else 400, 12_000, dtype=np.uint32))
    keys, count, _ = build_triples_packed(kmers, counts, 1, pack16=True)
    args = (0.4, 0.6, 3.0)
    n_gpu, hk_gpu, hs_gpu = merge_lrt(torch.from_numpy(keys).to(dev),
                                      torch.from_numpy(count).to(dev), *args)
    n_cpu, hk_cpu, hs_cpu = merge_lrt(torch.from_numpy(keys),
                                      torch.from_numpy(count), *args)
    assert n_gpu == n_cpu
    _eq(hk_gpu, hk_cpu)
    _eq(hs_gpu, hs_cpu)


def test_wrappers_refuse_cpu_only_layouts(dev):
    with pytest.raises(TypeError):
        lrt_filter(torch.zeros((4, 2), dtype=torch.int16, device=dev), 1, 0.5, 0.5, 1.0)
    # int64 sums (the wide merge's) take keep alone
    with pytest.raises(ValueError, match="keep alone"):
        lrt_filter(torch.zeros((4, 2), dtype=torch.int64, device=dev), 1, 0.5, 0.5, 1.0)
    with pytest.raises(ValueError):
        codec.compact(torch.ones(4, dtype=torch.bool, device=dev),
                      torch.zeros(4, dtype=torch.int64))
    keys = torch.arange(4, device=dev)
    with pytest.raises(ValueError):
        codec.run_encode(keys, torch.arange(4), torch.zeros(4, dtype=torch.int16))
    with pytest.raises(TypeError):
        codec.run_encode(keys, torch.arange(4, device=dev),
                         torch.zeros(4, dtype=torch.int64, device=dev))
    # the full form takes raw int32 counts and sample ids on the card
    with pytest.raises(TypeError):
        codec.run_encode(keys, torch.arange(4, device=dev),
                         torch.zeros(4, dtype=torch.int16, device=dev),
                         sample=torch.zeros(4, dtype=torch.int16, device=dev))
    with pytest.raises(ValueError):
        codec.run_encode(keys, torch.arange(4, device=dev),
                         torch.zeros(4, dtype=torch.int32, device=dev),
                         sample=torch.zeros(4, dtype=torch.int16))


def _streams(rng, S, dev, top):
    pool = np.unique(rng.integers(-(2**62), 2**62, 60_000))
    keys, counts = [], []
    for s in range(S):
        U = int(rng.integers(0, 5000)) if s % 3 == 1 else int(rng.integers(1, 9000))
        keys.append(torch.from_numpy(np.sort(rng.choice(pool, U, replace=False))).to(dev))
        counts.append(torch.from_numpy(
            rng.integers(1, top, U, dtype=np.int64).astype(np.uint32).view(np.int32)).to(dev))
    return keys, counts


@pytest.mark.parametrize("pack16", [True, False])
@pytest.mark.parametrize("S", [1, 2, 20])
def test_assemble_chunk(dev, S, pack16):
    rng = np.random.default_rng(S * 2 + pack16)
    keys, counts = _streams(rng, S, dev, 2**15 if pack16 else 2**32)
    Us = np.array([k.numel() for k in keys])
    starts = (rng.random(S) * Us // 2).astype(np.int64)
    lens = (rng.random(S) * (Us - starts)).astype(np.int64)
    lens[S // 2] = 0
    if S > 2:
        starts[-1], lens[-1] = 0, Us[-1]  # one whole stream
    before = kernels.launch_counts()["assemble_chunk"]
    got = fused.ChunkTable(keys, counts, starts, lens, max(1, S // 2)).assemble(0, pack16)
    want = fused.assemble_chunk_plain(keys, counts, starts, lens, max(1, S // 2), pack16)
    launched = kernels.launch_counts()["assemble_chunk"] - before
    assert launched == (1 if lens.sum() else 0)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    empty = fused.ChunkTable(keys, counts, starts, np.zeros(S, np.int64), 0).assemble(0, pack16)
    assert empty[0].numel() == 0 and empty[1].numel() == 0


ASM_MODES = ((True, False), (False, False), (False, True))  # (pack16, sample ids)


def _check_assemble(keys, counts, starts, lens, nbc):
    """A one-chunk ChunkTable in p16, p32 and p32 with sample ids against
    the plain twin, one launch each (none for an empty chunk)."""
    table = fused.ChunkTable(keys, counts, starts, lens, nbc)
    for pack16, ids in ASM_MODES:
        before = kernels.launch_counts()["assemble_chunk"]
        got = table.assemble(0, pack16, ids)
        assert kernels.launch_counts()["assemble_chunk"] == before + (1 if sum(lens) else 0)
        want = fused.assemble_chunk_plain(keys, counts, starts, lens, nbc, pack16, ids)
        for g, w in zip(got, want):
            _eq(g, w)


def test_assemble_chunk_alignments_and_lengths(dev):
    """Eight streams whose slices start at rows 0-7 (every 16-byte alignment
    of a key), of lengths 0, 1, a tile - 1, a tile, a tile + 1, 5, two tiles
    and 3, rotated so that each alignment meets each length."""
    tile = kernels.lib().kmd_assemble_chunk_tile_rows()
    rng = np.random.default_rng(21)
    S, U = 8, 3 * tile
    keys = [torch.from_numpy(np.sort(rng.integers(-(2**62), 2**62, U))).to(dev)
            for _ in range(S)]
    counts = [torch.from_numpy(rng.integers(0, 2**15, U).astype(np.int32)).to(dev)
              for _ in range(S)]
    lengths = np.array([0, 1, tile - 1, tile, tile + 1, 5, 2 * tile, 3])
    for shift in range(8):
        starts = (np.arange(S) + shift) % 8
        _check_assemble(keys, counts, starts, np.roll(lengths, shift), 3)


@pytest.mark.parametrize("S", [1, 300])
def test_assemble_chunk_stream_counts(dev, S):
    rng = np.random.default_rng(S + 22)
    keys, counts = _streams(rng, S, dev, 2**15)
    Us = np.array([k.numel() for k in keys])
    starts = (rng.random(S) * Us // 2).astype(np.int64)
    lens = (rng.random(S) * (Us - starts)).astype(np.int64)
    lens[::7] = 0
    lens[0] = max(lens[0], min(1, Us[0] - starts[0]))
    _check_assemble(keys, counts, starts, lens, S // 2)


def test_assemble_chunk_table_reused_back_to_back(dev):
    """One ChunkTable for a plan of six key-range chunks over 20 streams,
    assembled back to back with no sync between, as fused_merge does; every
    chunk against the plain twin."""
    rng = np.random.default_rng(23)
    S, C = 20, 6
    keys, counts = _streams(rng, S, dev, 2**15)
    Us = np.array([k.numel() for k in keys])
    cuts = np.sort(rng.random((C - 1, S)) * Us, axis=0).astype(np.int64)
    edges = np.concatenate([np.zeros((1, S), np.int64), cuts, Us[None, :]])
    starts, lens = edges[:-1], np.diff(edges, axis=0)
    lens[2, :] = 0  # an empty chunk
    for pack16, ids in ASM_MODES:
        table = fused.ChunkTable(keys, counts, starts, lens, S // 2)
        before = kernels.launch_counts()["assemble_chunk"]
        got = [table.assemble(c, pack16, ids) for c in range(C)]
        assert kernels.launch_counts()["assemble_chunk"] == before + C - 1
        for c, g in enumerate(got):
            want = fused.assemble_chunk_plain(keys, counts, starts[c], lens[c],
                                              S // 2, pack16, ids)
            for a, b in zip(g, want):
                _eq(a, b)


@pytest.mark.parametrize("hard_min", [1, 2, 5])
def test_weighted_runs_and_dedup_sum(dev, hard_min):
    """Seven overlapping distinct streams: runs of 1 to 7 rows."""
    rng = np.random.default_rng(hard_min)
    pool = np.unique(rng.integers(-(2**62), 2**62, 30_000))
    keys = np.concatenate([rng.choice(pool, 12_000, replace=False) for _ in range(7)])
    w = rng.integers(1, 4, len(keys)).astype(np.uint32)
    w[::101] = np.uint32(2**31 + 5)  # u32 weights above the int32 range
    w[::101][1::2] = 1
    kd = torch.from_numpy(keys).to(dev)
    wd = torch.from_numpy(w.view(np.int32)).to(dev)
    keys_s, perm = torch.sort(kd)
    starts, _k, n_valid, lens = codec.run_encode(keys_s, lengths=True)
    assert int(lens.min()) == 1 and int(lens.max()) == 7
    _eq(codec.weighted_run_sums(starts, n_valid, perm, wd),
        codec.weighted_run_sums_plain(starts, n_valid, perm, wd))
    small = torch.from_numpy(rng.integers(1, 4, len(keys)).astype(np.int32)).to(dev)
    got = codec.dedup_sum(kd, small, hard_min=hard_min, with_hist=True)
    want = codec.dedup_sum(kd.cpu(), small.cpu(), hard_min=hard_min, with_hist=True)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert (got[2].n_valid, got[2].max_count) == (want[2].n_valid, want[2].max_count)
    np.testing.assert_array_equal(got[2].hist, want[2].hist)


#: K-HIST's unrolled block step: 512 threads x four 16-byte loads
HIST_STEP = {torch.int32: 8192, torch.int64: 4096}


def _stats_input(rng, n, dtype, dev):
    """n counts, mostly 1-3, every 7th from 200 to 2^32 - 1, as int32
    holding u32 or as int64."""
    c = rng.geometric(0.6, n).astype(np.int64)
    c[::7] = rng.integers(200, 2**32, len(c[::7]))
    t = torch.from_numpy(c.astype(np.uint32).view(np.int32) if dtype == torch.int32 else c)
    return t.to(dev)


def _check_stats(n_valid, counts, with_hist=True):
    """rle_stats against rle_stats_plain, in one launch."""
    before = kernels.launch_counts()["abundance_hist"]
    got = codec.rle_stats(n_valid, counts, with_hist)
    assert kernels.launch_counts()["abundance_hist"] == before + 1
    want = codec.rle_stats_plain(n_valid, counts, with_hist)
    assert (got.n_valid, got.max_count) == (want.n_valid, want.max_count)
    if with_hist:
        np.testing.assert_array_equal(got.hist, want.hist)
    else:
        assert got.hist is None
    return got


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_abundance_hist(dev, dtype):
    """rle_stats at N = 0, 1, 3, 4, 5, a block step - 1, + 0, + 1, more
    steps than the grid has blocks, with and without the histogram."""
    rng = np.random.default_rng(HIST_STEP[dtype])
    n_valid = torch.tensor([12345], dtype=torch.int64, device=dev)
    step = HIST_STEP[dtype]
    for n in (0, 1, 3, 4, 5, step - 1, step, step + 1, 300 * step + 7, 3_000_001):
        counts = _stats_input(rng, n, dtype, dev)
        for with_hist in (True, False):
            assert _check_stats(n_valid, counts, with_hist).n_valid == 12345


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_count_stats_offset_views(dev, dtype):
    """Counts that are views at every element offset of a 16-byte line
    (int32 offsets 0-3, int64 0-1), as K-RUN's buffer hands them out: a
    scalar head, then 16-byte loads."""
    rng = np.random.default_rng(31)
    step = HIST_STEP[dtype]
    base = _stats_input(rng, 3 * step + 50, dtype, dev)
    n_valid = torch.tensor([9], dtype=torch.int64, device=dev)
    size = base.element_size()
    for lead in range(16 // size):
        for n in (1, 3, 5, 2 * step + 3, base.numel() - lead):
            view = base[lead : lead + n]
            assert view.data_ptr() % 16 == lead * size
            _check_stats(n_valid, view)


def test_count_stats_extremes(dev):
    """All ones; all above 255; u32 counts at and above 2^31, whose max is
    the u32 value; int64 sums up to 2^32 - 1."""
    rng = np.random.default_rng(32)
    n = 100_003
    n_valid = torch.tensor([n], dtype=torch.int64, device=dev)
    for dtype in (torch.int32, torch.int64):
        st = _check_stats(n_valid, torch.ones(n, dtype=dtype, device=dev))
        assert st.max_count == 1 and st.hist[1] == n
    above = rng.integers(256, 2**32, n).astype(np.uint32)
    st = _check_stats(n_valid, torch.from_numpy(above.view(np.int32)).to(dev))
    assert st.hist[256] == n and st.hist[:256].sum() == 0
    assert st.max_count == int(above.max())
    big = np.full(n, 2**31, np.uint32)
    big[77] = 2**32 - 1
    assert _check_stats(n_valid, torch.from_numpy(big.view(np.int32)).to(dev)).max_count == 2**32 - 1
    wide = rng.integers(0, 2**32, n, dtype=np.int64)
    wide[5] = 2**32 - 1
    assert _check_stats(n_valid, torch.from_numpy(wide).to(dev)).max_count == 2**32 - 1


def test_count_stats_from_four_threads(dev):
    """Four host threads at once, as the count pipeline's sample threads
    call sort_rle: each thread keeps its own accumulators."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(33)
    cases = []
    for i in range(16):
        dtype = (torch.int32, torch.int64)[i % 2]
        n = (0, 5, 70_001, 1_000_003)[i % 4]
        cases.append((torch.tensor([i], dtype=torch.int64, device=dev),
                      _stats_input(rng, n, dtype, dev)))
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda c: codec.rle_stats(*c, True), cases))
    for (n_valid, counts), got in zip(cases, results):
        want = codec.rle_stats_plain(n_valid, counts, True)
        assert (got.n_valid, got.max_count) == (want.n_valid, want.max_count)
        np.testing.assert_array_equal(got.hist, want.hist)


def test_count_stats_one_launch_one_device_op(dev):
    """A call launches K-HIST once, makes no PyTorch-side sync (its one host
    sync is inside the C entry point) and runs one device operation: no
    memset, no copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = _stats_input(np.random.default_rng(34), 1 << 20, torch.int32, dev)
    n_valid = torch.tensor([1 << 20], dtype=torch.int64, device=dev)
    codec.rle_stats(n_valid, counts, True)
    torch.cuda.synchronize()
    before = kernels.launch_counts()["abundance_hist"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            codec.rle_stats(n_valid, counts, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launch_counts()["abundance_hist"] == before + 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            codec.rle_stats(n_valid, counts, True)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ops) == 5 and all("count_stats" in name for name in ops), ops


LRT_FORMS = ((True, True), (False, False), (False, True), (True, False))  # (lr, sums)


def _check_lrt(counts, nbc):
    """Every form of lrt_filter against the plain twin's full form, one
    launch a call (none for B = 0), None for each output not asked for."""
    args = (nbc, 0.45, 0.55, 5.0)
    ref = lrt_filter_plain(counts, *args)
    for want_lr, want_sums in LRT_FORMS:
        before = kernels.launch_counts()["lrt_filter"]
        keep, lr, s_c, s_k = lrt_filter(counts, *args, want_lr=want_lr, want_sums=want_sums)
        assert kernels.launch_counts()["lrt_filter"] == before + (1 if counts.shape[0] else 0)
        _eq(keep, ref[0])
        if want_lr:
            torch.testing.assert_close(lr, ref[1], rtol=1e-6, atol=1e-6)
        else:
            assert lr is None
        if want_sums:
            _eq(s_c, ref[2])
            _eq(s_k, ref[3])
        else:
            assert s_c is None and s_k is None


@pytest.mark.parametrize("B", [0, 1, 3, 4, 5, 4099])
def test_lrt_filter_narrow_forms(dev, B):
    """The merge's [B, 2] sums, fresh and as views at an 8-byte offset (the
    pairs form's lead row) and at a 4-byte one (no 8-byte pairs)."""
    rng = np.random.default_rng(B + 70)
    flat = torch.from_numpy(rng.integers(0, 500, 2 * B + 4, dtype=np.int32)).to(dev)
    for lead in (0, 2, 1):
        view = flat[lead : lead + 2 * B].view(B, 2)
        assert B == 0 or view.data_ptr() % 16 == 4 * lead
        _check_lrt(view, 1)


@pytest.mark.parametrize("S", [1, 2, 3, 7, 20, 64, 65, 300])
def test_lrt_filter_columns(dev, S):
    """S from 1 to 300 (a thread a row: every S but the pairs form's 2), nb_controls
    0, S // 2 and S, on fresh counts and on views at an 8-byte offset."""
    rng = np.random.default_rng(S + 80)
    B = 1000 + S
    flat = torch.from_numpy(rng.integers(0, 500, B * S + 2, dtype=np.int32)).to(dev)
    for lead in (0, 2):
        view = flat[lead : lead + B * S].view(B, S)
        for nbc in sorted({0, S // 2, S}):
            _check_lrt(view, nbc)


@pytest.mark.parametrize("sort_rows,hard_min", [(1 << 24, 1), (5000, 2)])
def test_count_sample_resident_cuda_matches_cpu(dev, monkeypatch, sort_rows, hard_min):
    from kmdiff_tpu_torch.pipeline import count as count_mod

    monkeypatch.setattr(count_mod, "SORT_ROWS", sort_rows)
    rng = np.random.default_rng(sort_rows)
    codes = rng.integers(0, 4, 30_000).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = codec.INVALID
    codes[5000:25000] = np.tile(codes[:100], 200)
    got = fused.count_sample_resident([codes], 31, hard_min, dev)
    want = fused.count_sample_resident([codes], 31, hard_min, torch.device("cpu"))
    _eq(got.keys, want.keys)
    _eq(got.counts, want.counts)
    assert (got.U, got.max_count, got.n_distinct_pre, got.total_mass) == (
        want.U, want.max_count, want.n_distinct_pre, want.total_mass)
    np.testing.assert_array_equal(got.hist_uvec, want.hist_uvec)


@pytest.mark.parametrize("S", [1, 2, 20])
def test_assemble_chunk_sample_ids(dev, S):
    rng = np.random.default_rng(S + 40)
    keys, counts = _streams(rng, S, dev, 2**31)
    Us = np.array([k.numel() for k in keys])
    starts = (rng.random(S) * Us // 3).astype(np.int64)
    lens = Us - starts
    lens[S // 2] = 0
    got = fused.ChunkTable(keys, counts, starts, lens, max(1, S // 2)).assemble(
        0, False, with_sample=True)
    want = fused.assemble_chunk_plain(keys, counts, starts, lens, max(1, S // 2),
                                      False, with_sample=True)
    assert len(got) == 3 and got[2].dtype == torch.int16
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("rate", [0.0, 0.001, 0.05, 1.0])
def test_geno_sample(dev, rate):
    rng = np.random.default_rng(int(rate * 1000) + 3)
    for n in (0, 1, 257, 100_003):
        w = rng.integers(0, 2**63, n, dtype=np.uint64)
        w[::2] |= np.uint64(1 << 63)
        keys = torch.from_numpy(codec.words_to_keys(w.reshape(-1, 1))).to(dev)
        thr = merge_dev.pca_threshold_u32(rate)
        for seed in (0, 9, 2**32 - 1):
            _eq(merge_dev.geno_sample(keys, thr, seed),
                merge_dev.geno_sample_plain(keys, thr, seed))


@pytest.mark.parametrize("S", [1, 3, 20])
def test_run_rows(dev, S):
    rng = np.random.default_rng(S + 7)
    pool = np.unique(rng.integers(-(2**62), 2**62, 20_000))
    parts = [np.sort(rng.choice(pool, int(rng.integers(1, 6000)), replace=False))
             for _ in range(S)]
    keys = torch.from_numpy(np.concatenate(parts)).to(dev)
    sample = torch.from_numpy(np.repeat(np.arange(S), [len(p) for p in parts])
                              .astype(np.int16)).to(dev)
    sample[::97] = S + 3  # ids past S are ignored
    count = torch.from_numpy(rng.integers(-(2**31), 2**31, keys.numel())
                             .astype(np.int32)).to(dev)
    keys_s, perm = torch.sort(keys)
    starts, _k, n_valid, _ = codec.run_encode(keys_s)
    U = starts.numel()
    for sel in (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.arange(U, device=dev),
                torch.tensor([U - 1], device=dev),
                torch.from_numpy(np.sort(rng.choice(U, U // 7, replace=False))).to(dev)):
        for presence in (False, True):
            args = (starts, n_valid, sel, perm, count, sample, S, presence)
            _eq(merge_dev.run_rows(*args), merge_dev.run_rows_plain(*args))


def test_merge_lrt_full_cuda_matches_cpu(dev):
    rng = np.random.default_rng(2)
    pool = np.unique(rng.integers(0, 2**64 - 1, 30_000, dtype=np.uint64))
    kmers, counts = [], []
    for s in range(6):
        take = np.sort(rng.choice(len(pool), 10_000, replace=False))
        kmers.append(pool[take].reshape(-1, 1))
        c = rng.integers(1, 300, 10_000, dtype=np.uint32)
        c[:1000] *= 1 + 30 * (s < 3)
        counts.append(c)
    keys, count, sample, _ = merge_dev.build_triples(kmers, counts)
    thr = merge_dev.pca_threshold_u32(0.05)
    args = (6, 3, 0.45, 0.55, 3.0, True, True, thr, 5)
    gpu = merge_dev.merge_lrt_full(torch.from_numpy(keys).to(dev),
                                   torch.from_numpy(count).to(dev),
                                   torch.from_numpy(sample).to(dev), *args)
    cpu = merge_dev.merge_lrt_full(torch.from_numpy(keys), torch.from_numpy(count),
                                   torch.from_numpy(sample), *args)
    assert gpu[0] == cpu[0] and gpu[1].numel() > 0 and gpu[4].shape[0] > 0
    for g, c in zip(gpu[1:], cpu[1:]):
        _eq(g, c)


def _full_inputs(rng, S, dev, n_pool=12_000, per=4000):
    """S sorted distinct streams of one pool merged as the full merge sees
    them: keys sorted with their permutation, raw u32 counts (int32) of
    which a tenth lie in [2^31, 2^32), sample ids as u16."""
    pool = np.unique(rng.integers(-(2**62), 2**62, n_pool))
    parts = [np.sort(rng.choice(pool, min(per, len(pool)), replace=False))
             for _ in range(S)]
    raw = rng.integers(1, 300, sum(len(p) for p in parts), dtype=np.int64)
    raw[::10] = rng.integers(2**31, 2**32, len(raw[::10]))
    sample = np.repeat(np.arange(S), [len(p) for p in parts]).astype(np.int16)
    keys, perm = torch.sort(torch.from_numpy(np.concatenate(parts)).to(dev))
    count = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(dev)
    return keys, perm, count, torch.from_numpy(sample).to(dev), raw


@pytest.mark.parametrize("S", [1, 2, 20, 300])
def test_run_encode_full_form(dev, S):
    """K-RUN's full form at S = 1 to 300 (runs across tile edges, longer than
    a warp at 300), nb_controls 0, S // 2 and S, with and without starts:
    int64 sums of raw counts past 2^32, equal to the twin's and to numpy's."""
    rng = np.random.default_rng(S + 90)
    keys, perm, count, sample, raw = _full_inputs(rng, S, dev)
    for nbc in sorted({0, S // 2, S}):
        for starts in (True, False):
            got = _check_runs(keys, perm, count, starts=starts, sample=sample,
                              nb_controls=nbc)
        sums = got[3]
        assert sums.dtype == torch.int64 and sums.shape == (got[1].numel(), 2)
        run_of = np.searchsorted(got[1].cpu().numpy(), keys.cpu().numpy())
        p = perm.cpu().numpy()
        ctrl = sample.cpu().numpy()[p] < nbc
        want = np.zeros((got[1].numel(), 2), np.int64)
        np.add.at(want, (run_of, np.where(ctrl, 0, 1)), raw[p])
        np.testing.assert_array_equal(sums.cpu().numpy(), want)
    if S >= 20:
        assert int(sums.max()) >= 2**32


def test_run_encode_full_form_views_and_edges(dev):
    """The full form on keys at an 8-byte offset of their allocation, at N
    around one tile, and one key repeated across many tiles."""
    tile = kernels.lib().kmd_run_encode_tile_rows(4)
    assert tile == kernels.lib().kmd_run_encode_tile_rows(2)
    rng = np.random.default_rng(91)
    for n in (1, tile - 1, tile, tile + 1, 5 * tile + 3):
        for run_len in (1, 20, tile + 3):
            keys = _sorted(np.arange(n) // run_len, dev)
            base = torch.cat([keys[:1], keys])
            view = base[1:]
            assert view.data_ptr() % 16 == 8
            perm = torch.from_numpy(rng.permutation(n)).to(dev)
            count = torch.from_numpy(rng.integers(-(2**31), 2**31, n)
                                     .astype(np.int32)).to(dev)
            sample = torch.from_numpy(rng.integers(0, 5, n).astype(np.int16)).to(dev)
            for k in (keys, view):
                _check_runs(k, perm, count, sample=sample, nb_controls=2)


@pytest.mark.parametrize("B", [0, 1, 7, 8, 9, 4099])
def test_lrt_filter_int64(dev, B):
    """K-LRT on int64 [B, 2] sums up to 2^40 (the wide pairs form on fresh
    tensors, a thread a row on views at an 8-byte offset) and on [B, 5]
    int64 counts, nb_controls 0 to S: keep equal to the twin's, one launch
    a call, and no other output."""
    rng = np.random.default_rng(B + 95)
    for S in (2, 5):
        flat = torch.from_numpy(rng.integers(0, 2**40, B * S + 1)).to(dev)
        flat[::3] = torch.from_numpy(rng.integers(0, 300, len(flat[::3]))).to(dev)
        if S == 2:  # near the cut: sums in the cohort's ratio, LR ~ 0
            t = rng.integers(1, 2**40, len(range(0, 2 * B, 4)))
            flat[0 : 2 * B : 4] = torch.from_numpy((0.45 * t).astype(np.int64)).to(dev)
            flat[1 : 2 * B : 4] = torch.from_numpy(t - (0.45 * t).astype(np.int64)).to(dev)
        for lead in (0, 1):
            view = flat[lead : lead + B * S].view(B, S)
            for nbc in sorted({0, 1, S // 2, S}):
                args = (nbc, 0.45, 0.55, 5.0)
                before = kernels.launch_counts()["lrt_filter"]
                keep, lr, s_c, s_k = lrt_filter(view, *args, want_lr=False,
                                                want_sums=False)
                assert kernels.launch_counts()["lrt_filter"] == before + (1 if B else 0)
                assert lr is None and s_c is None and s_k is None
                _eq(keep, lrt_filter_plain(view, *args)[0])
    with pytest.raises(ValueError, match="keep alone"):
        lrt_filter(flat[: 2 * B].view(B, 2), 1, 0.45, 0.55, 5.0)


def test_run_rows_raw_counts(dev):
    """K-ROWS on raw counts of 2^31 and 2^32 - 1 (negative as int32): the
    count rows hold them as they are and the presence rows mark them."""
    rng = np.random.default_rng(97)
    keys, perm, count, sample, raw = _full_inputs(rng, 20, dev)
    count[::7] = torch.iinfo(torch.int32).min  # 2^31
    count[3::7] = -1                           # 2^32 - 1
    starts, _k, n_valid, _ = codec.run_encode(keys)
    sel = torch.arange(starts.numel(), device=dev)
    rows = merge_dev.run_rows(starts, n_valid, sel, perm, count, sample, 20)
    _eq(rows, merge_dev.run_rows_plain(starts, n_valid, sel, perm, count, sample, 20))
    u = rows.cpu().numpy().view(np.uint32)
    assert (u == 2**31).any() and (u == 2**32 - 1).any()
    pres = merge_dev.run_rows(starts, n_valid, sel, perm, count, sample, 20,
                              presence=True)
    _eq(pres, merge_dev.run_rows_plain(starts, n_valid, sel, perm, count, sample, 20,
                                       presence=True))
    np.testing.assert_array_equal(pres.cpu().numpy(), (u != 0).astype(np.uint8))


@pytest.mark.parametrize("S", [2, 20])
def test_assemble_chunk_with_sample_ids_has_raw_counts(dev, S):
    """K-ASM with sample ids is given no control streams: its counts are the
    streams' raw u32 counts, 2^31 and above included, whatever nb_controls."""
    rng = np.random.default_rng(S + 98)
    keys, counts = _streams(rng, S, dev, 2**32)
    Us = np.array([k.numel() for k in keys])
    starts, lens = np.zeros(S, np.int64), Us.copy()
    for nbc in (0, S // 2, S):
        got = fused.ChunkTable(keys, counts, starts, lens, nbc).assemble(
            0, False, with_sample=True)
        want = fused.assemble_chunk_plain(keys, counts, starts, lens, nbc, False,
                                          with_sample=True)
        for g, w in zip(got, want):
            _eq(g, w)
        _eq(got[1], torch.cat(counts))
    assert int((got[1] < 0).sum()) > 0


@pytest.mark.parametrize("B,S", [(0, 4), (1, 1), (31, 20), (33, 20), (70_001, 20),
                                 (5000, 17), (20_000, 200)])
def test_int_gram(dev, B, S):
    rng = np.random.default_rng(B + S)
    X = torch.from_numpy((rng.random((B, S)) < 0.35).astype(np.uint8)).to(dev)
    before = kernels.launch_counts()["int_gram"]
    _eq(pca.int_gram(X), pca.int_gram_plain(X))
    assert kernels.launch_counts()["int_gram"] == before + (1 if B else 0)


GRAM_B = [31, 32, 33, 63, 64, 65, (1 << 16) + 7]
GRAM_S = [1, 16, 17, 20, 33, 200, 256, 257]


@pytest.mark.parametrize("S", GRAM_S)
def test_int_gram_edges(dev, S):
    """K-GRAM around its 32-row words, at 2^16 + 7 rows, at S around its
    8-sample micro-tiles, its 32-sample slabs and its two forms (256
    samples fused, 257 tiled), on values 0..3 (any nonzero is 1), all-zero
    and all-one blocks; one launch a call."""
    rng = np.random.default_rng(S + 900)
    blocks = [(rng.random((B, S)) < 0.35) * rng.integers(1, 4, (B, S)) for B in GRAM_B]
    blocks += [np.zeros((65, S)), np.ones((65, S)), np.ones(((1 << 16) + 7, S))]
    for X in blocks:
        X = torch.from_numpy(X.astype(np.uint8)).to(dev)
        before = kernels.launch_counts()["int_gram"]
        _eq(pca.int_gram(X), pca.int_gram_plain(X))
        assert kernels.launch_counts()["int_gram"] == before + 1


@pytest.mark.parametrize("B,S", [((1 << 20) + 5, 256), ((1 << 20) + 5, 129),
                                 (1 << 16, 2000)])
def test_int_gram_super_chunks(dev, B, S):
    """Fused blocks whose rows outgrow the packed words' shared budget
    (three super-chunks a block at 256 samples, later ones adding into
    their partial sums), and the tiled form at 2000 samples."""
    rng = np.random.default_rng(S + 902)
    X = torch.from_numpy((rng.random((B, S)) < 0.3).astype(np.uint8)).to(dev)
    _eq(pca.int_gram(X), pca.int_gram_plain(X))


@pytest.mark.parametrize("S", [4099, 12_280, 12_281, 16_384, 16_385])
def test_int_gram_many_samples(dev, S):
    """The tiled form where a 32-row word's packed samples would outgrow
    the fused form's shared budget (from 12,281 on) and past 16,384
    samples, on 77 rows (three words, the last cut)."""
    rng = np.random.default_rng(S + 903)
    X = torch.from_numpy((rng.random((77, S)) < 0.3).astype(np.uint8)).to(dev)
    before = kernels.launch_counts()["int_gram"]
    _eq(pca.int_gram(X), pca.int_gram_plain(X))
    assert kernels.launch_counts()["int_gram"] == before + 1


def test_int_gram_views_and_one_device_op(dev):
    """A row slice at an odd byte offset (X's first and last 16-byte
    chunks cut), calls on a second stream, and one device operation a call
    (no memset, no copy) in the fused form."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(901)
    big = torch.from_numpy((rng.random((70_001, 21)) < 0.5).astype(np.uint8)).to(dev)
    for lead in (1, 3, 7):
        X = big[lead : lead + 40_000]
        assert X.data_ptr() % 16 != 0
        _eq(pca.int_gram(X), pca.int_gram_plain(X))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = pca.int_gram(big)
    side.synchronize()
    _eq(got, pca.int_gram_plain(big))
    X = big[:65_543]
    pca.int_gram(X)
    torch.cuda.synchronize()
    # a torch.profiler session now and then drops a device record: up to
    # three sessions, until one records all five calls
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                pca.int_gram(X)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(ops) <= 5 and all("gram" in name for name in ops), ops
        if len(ops) == 5:
            break
    assert len(ops) == 5, ops


def _irls_inputs(rng, B, n, F, dev):
    y = np.concatenate([np.ones(n // 2), np.zeros(n - n // 2)])
    X = np.column_stack([np.ones(n), rng.normal(size=(n, F - 2))])
    X[:, 1:] -= X[:, 1:].mean(0)
    X[:, 1:] /= np.abs(X[:, 1:]).max(0)
    Xb = np.column_stack([X, np.zeros(n)])
    r = rng.normal(size=(B, n)) + 0.5 * y
    r[0] = 0.0                               # singular
    if B > 1:
        r[1] = np.where(y == 1, 1.0, -1.0)   # separable
    r = r - r.mean(1, keepdims=True)
    r = r / np.maximum(np.abs(r).max(1, keepdims=True), 1e-300)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return t(Xb)[None].contiguous(), t(r), t(y)


def _check_irls(got, want, atol=1e-4):
    w, _err, it, ll, stop = got
    _w, _err_p, it_p, ll_p, stop_p = want
    _eq(stop, stop_p)
    assert (it == it_p).float().mean() >= 0.99
    torch.testing.assert_close(ll, ll_p, rtol=1e-5, atol=atol)
    assert torch.isfinite(w).all()


# popstrat's shapes (n = 20 and 200) and two stress shapes (64 features,
# 3000 samples) at the stated tolerance, but for one quasi-separated item
# at 3000 samples (ll -0.5715 against the twin's -0.5719 on an NVIDIA H100
# 80GB HBM3 at 700 W; 1.4e-3 apart with TF32 products): 5e-4 there
@pytest.mark.parametrize("B,n,F,atol", [(1, 4, 2, 1e-4), (300, 20, 5, 1e-4),
                                        (200, 200, 12, 1e-4),
                                        (40, 150, 64, 1e-4),
                                        (20, 3000, 8, 5e-4)])
def test_irls(dev, B, n, F, atol):
    rng = np.random.default_rng(B * n + F)
    X, last, y = _irls_inputs(rng, B, n, F, dev)
    got = glm.irls(X, last, y, 500)
    _check_irls(got, glm.irls_plain(X, last, y, 500), atol)
    assert int(got[4][0]) == 1 and int(got[2][0]) == 1  # the singular item
    # the null-fit form: full designs, no replaced column
    Xf = glm._design(X, last)[: min(B, 16)].contiguous()
    _check_irls(glm.irls(Xf, None, y), glm.irls_plain(Xf, None, y), atol)


def test_irls_max_iters_and_limits(dev):
    rng = np.random.default_rng(4)
    X, last, y = _irls_inputs(rng, 64, 30, 6, dev)
    got = glm.irls(X, last, y, 3)
    _check_irls(got, glm.irls_plain(X, last, y, 3))
    assert (got[4] == 2).any() and int(got[2].max()) == 3
    with pytest.raises(ValueError):
        glm.irls(torch.zeros((1, 4, 65), device=dev), None, y[:4])


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bit_equal(got, want, rows):
    for g, w in zip(got, want):
        assert torch.equal(_bits(g[rows]).cpu(), _bits(w).cpu())


# popstrat's n = 20, the stride-emulated sums past one and four warps of
# rows (n = 33, 129), 64 features, 3000 samples (one fit a block) and 8000
# (too many to stage: the design read from device memory)
@pytest.mark.parametrize("n,F", [(20, 5), (33, 6), (129, 12), (150, 64), (3000, 8),
                                 (8000, 5)])
def test_irls_batch_independence(dev, n, F):
    B = 1024
    rng = np.random.default_rng(n + F)
    X, last, y = _irls_inputs(rng, B, n, F, dev)
    fits, staged, _ = glm.irls_layout(n, F, True, True,
                                      torch.cuda.get_device_properties(dev)
                                      .shared_memory_per_block_optin)
    assert fits >= 1 and staged == (n < 8000)
    # a max_iters that some fits reach and others converge under; then the
    # first block holds the singular item, a fit that converges and one
    # that stops at max_iters
    it0, stop0 = glm.irls(X, last, y, 500)[2:5:2]
    conv = torch.nonzero(stop0 == 0)[:, 0]
    m = int(it0[conv].max())
    fast = int(conv[it0[conv] < m][0])
    slow = int(conv[it0[conv] >= m][0])
    order = [0, fast, slow] + [b for b in range(1, B) if b not in (fast, slow)]
    last = last[order].contiguous()
    got = glm.irls(X, last, y, m)
    stops = set(got[4][: max(fits, 3)].tolist())
    assert {0, 1, 2} <= stops
    picks = sorted({0, 1, 2, fits - 1, fits, fits + 1, B // 2, B - 1})
    for b in picks:
        _bit_equal(got, glm.irls(X, last[b: b + 1], y, m), slice(b, b + 1))
    # a batch that ends inside a block
    part = B - 5 if fits > 1 else B - 1
    _bit_equal(got, glm.irls(X, last[:part], y, m), slice(0, part))


@pytest.mark.parametrize("S,H", [(20, 700), (200, 300), (20, 0)])
def test_run_rows_on_dirty_memory(dev, S, H):
    rng = np.random.default_rng(S + H)
    # a small key pool: runs of up to S rows, past one warp at S = 200
    pool = np.unique(rng.integers(-(2**62), 2**62, 2000))
    parts = [np.sort(rng.choice(pool, int(rng.integers(500, 1500)), replace=False))
             for _ in range(S)]
    keys = torch.from_numpy(np.concatenate(parts)).to(dev)
    sample = torch.from_numpy(np.repeat(np.arange(S), [len(p) for p in parts])
                              .astype(np.int16)).to(dev)
    count = torch.from_numpy(rng.integers(-(2**31), 2**31, keys.numel())
                             .astype(np.int32)).to(dev)
    keys_s, perm = torch.sort(keys)
    starts, _k, n_valid, lengths = codec.run_encode(keys_s, lengths=True)
    if S > 32:
        assert int(lengths.max()) > 32
    sel = torch.from_numpy(np.sort(rng.choice(starts.numel(), H, replace=False))).to(dev)
    for presence in (False, True):
        args = (starts, n_valid, sel, perm, count, sample, S, presence)
        want = merge_dev.run_rows_plain(*args)
        junk = torch.full((want.numel() * want.element_size(),), 0xFF,
                          dtype=torch.uint8, device=dev)
        ptr = junk.data_ptr()
        del junk
        before = kernels.launch_counts()["run_rows"]
        got = merge_dev.run_rows(*args)
        assert kernels.launch_counts()["run_rows"] == before + (1 if H else 0)
        if H:
            assert got.data_ptr() == ptr  # the 0xFF block came back
        _eq(got, want)


# -- multi-word forms (k > 32: [nw, N] word-major keys) ------------------------

K_MW = [33, 63, 64, 65, 96, 97, 127, 128]


@pytest.mark.parametrize("k", K_MW)
def test_canonical_kmers_mw(dev, k):
    """K-EXT's multi-word form at one window, at 256 and 257 windows, at an
    odd length with INVALID codes, an all-G stretch (canonical as all-C,
    never the sentinel), all INVALID, and on views at byte offsets 1 to
    3."""
    rng = np.random.default_rng(k + 300)
    before = kernels.launch_counts()["canonical_kmers_mw"]
    for n in (k, k + 255, k + 256, 70_001):
        codes = rng.integers(0, 4, n + 3).astype(np.uint8)
        codes[rng.random(n + 3) < 0.01] = codec.INVALID
        codes[: min(n, k + 40)] = 3
        c = torch.from_numpy(codes).to(dev)
        for off in (0, 1, 2, 3):
            v = c[off : off + n]
            got = codec.canonical_kmers(v, k)
            _eq(got, codec.canonical_kmers_mw_plain(v, k))
        assert not (got[:, :30] == codec.SENTINEL).all(0).any()
    bad = torch.full((k + 70,), int(codec.INVALID), dtype=torch.uint8, device=dev)
    assert (codec.canonical_kmers(bad, k) == codec.SENTINEL).all()
    assert codec.canonical_kmers(bad[: k - 1], k).shape == ((k + 31) // 32, 0)
    assert kernels.launch_counts()["canonical_kmers_mw"] == before + 17


def _mw_tile_and_run(k):
    """The multi-word kernel's windows a tile and a thread's run at k."""
    nw = (k + 31) // 32
    lib = kernels.lib()
    return lib.kmd_canonical_kmers_mw_tile_windows(nw), lib.kmd_canonical_kmers_mw_run_windows(nw)


def _ext_mw_check(c, k):
    before = kernels.launch_counts()["canonical_kmers_mw"]
    _eq(codec.canonical_kmers(c, k), codec.canonical_kmers_mw_plain(c, k))
    assert kernels.launch_counts()["canonical_kmers_mw"] == before + 1


@pytest.mark.parametrize("k", K_MW)
def test_canonical_kmers_mw_run_and_tile_lengths(dev, k):
    """Window counts at a thread's run and at a tile, each plus or minus
    one window, and at two tiles plus one."""
    tile, run = _mw_tile_and_run(k)
    rng = np.random.default_rng(k + 400)
    for w in (1, run - 1, run, run + 1, tile - 1, tile, tile + 1, 2 * tile + 1):
        codes = rng.integers(0, 4, w + k - 1).astype(np.uint8)
        codes[rng.random(len(codes)) < 0.003] = codec.INVALID
        _ext_mw_check(torch.from_numpy(codes).to(dev), k)


def _mw_invalid_positions(k, run, tile, n):
    """Code positions of the edge cases: the first and the last code of a
    thread's run, and window positions 31, 32, 63, 64, 95 and 96 of a run's
    first window (where the carries cross words), for runs at the start of
    a tile, inside it and at its end."""
    out = set()
    for r0 in (0, run, 5 * run, tile - run, tile):
        out |= {r0, r0 + run + k - 2, r0 + k - 1, r0 + run - 1}
        out |= {r0 + p for p in (31, 32, 63, 64, 95, 96)}
    return sorted(p for p in out if p < n)


@pytest.mark.parametrize("k", K_MW)
def test_canonical_kmers_mw_invalid_positions(dev, k):
    tile, run = _mw_tile_and_run(k)
    n = 2 * tile + k - 1
    rng = np.random.default_rng(k + 500)
    base = torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)).to(dev)
    for p in _mw_invalid_positions(k, run, tile, n):
        codes = base.clone()
        codes[p] = int(codec.INVALID)
        _ext_mw_check(codes, k)


@pytest.mark.parametrize("k", K_MW)
def test_canonical_kmers_mw_misaligned_views(dev, k):
    """Views at byte offsets 1 to 15 of their allocation, short and across
    tiles: the first chunk of the stream is copied byte by byte."""
    tile, _run = _mw_tile_and_run(k)
    rng = np.random.default_rng(k + 600)
    codes = rng.integers(0, 4, 2 * tile + 300).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = codec.INVALID
    base = torch.from_numpy(codes).to(dev)
    assert base.data_ptr() % 16 == 0
    for lead in range(1, 16):
        for n in (k, k + 40, tile + k - 1 - lead, 2 * tile + 300 - lead):
            view = base[lead : lead + n]
            assert view.data_ptr() % 16 == lead
            _ext_mw_check(view, k)


def _mw_sorted(rng, nw, n, n_pool, tail=0):
    """[nw, n] sorted keys from a pool whose first rows share their leading
    word, with a sentinel tail of `tail` rows."""
    pool = rng.integers(-(2**62), 2**62, (max(n_pool, 1), nw))
    pool[: n_pool // 2, 0] = pool[0, 0]
    rows = pool[rng.integers(0, len(pool), n)]
    rows[n - tail :] = codec.SENTINEL
    keys = torch.from_numpy(np.ascontiguousarray(rows.T)).to("cuda")
    return codec.sort_rows(keys)[0]


def _check_mw_runs(keys, *args, **kw):
    got = codec.run_encode(keys, *args, **kw)
    want = codec.run_encode_plain(keys, *args, **kw)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _eq(g, w)
    return got


@pytest.mark.parametrize("nw", [2, 3, 4])
def test_run_encode_mw_forms(dev, nw):
    """K-RUN's multi-word form, every form with and without starts: N = 1,
    around its 1024-row tile, odd, with a sentinel tail, a 3,000-row run
    across tiles, all sentinel; keys as a [:, 1:] view of a wider buffer
    (row stride past N, 8 bytes off 16)."""
    tile = kernels.lib().kmd_run_encode_mw_tile_rows()
    rng = np.random.default_rng(nw + 310)
    before = kernels.launch_counts()["run_bounds_mw"]
    calls = 0
    for n, n_pool, tail in ((1, 1, 0), (tile - 1, 40, 3), (tile, 2000, 0),
                            (tile + 1, 5, 1), (5 * tile + 7, 3000, 700),
                            (9001, 2, 0), (77, 5, 77)):
        keys = _mw_sorted(rng, nw, n, n_pool, tail)
        wide = torch.empty((nw, n + 1), dtype=torch.int64, device=dev)
        wide[:, 1:] = keys
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        raw = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32)).to(dev)
        p16 = torch.from_numpy(rng.integers(-(2**15), 2**15, n).astype(np.int16)).to(dev)
        p32 = torch.from_numpy((rng.integers(0, 2**20, n) | (rng.random(n) < 0.5) << 31)
                               .astype(np.uint32).view(np.int32)).to(dev)
        sample = torch.from_numpy(rng.integers(0, 7, n).astype(np.int16)).to(dev)
        for k in (keys, wide[:, 1:]):
            for starts in (True, False):
                _check_mw_runs(k, starts=starts)
                _check_mw_runs(k, lengths=True, starts=starts)
                _check_mw_runs(k, perm, p16, starts=starts)
                _check_mw_runs(k, perm, p32, starts=starts)
                _check_mw_runs(k, perm, raw, starts=starts, sample=sample,
                               nb_controls=3)
                calls += 5
    empty = codec.run_encode(torch.empty((nw, 0), dtype=torch.int64, device=dev),
                             lengths=True)
    assert empty[1].shape == (nw, 0) and int(empty[2]) == 0
    assert kernels.launch_counts()["run_bounds_mw"] == before + calls


@pytest.mark.parametrize("nw", [2, 3, 4])
def test_geno_sample_mw(dev, nw):
    rng = np.random.default_rng(nw + 320)
    for U in (0, 1, 255, 4097):
        keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, (nw, U + 5),
                                             dtype=np.int64)).to(dev)
        for rate in (0.001, 0.05, 1.0):
            thr = merge_dev.pca_threshold_u32(rate)
            for k in (keys[:, :U].contiguous(), keys[:, 5:]):
                _eq(merge_dev.geno_sample(k, thr, 3),
                    merge_dev.geno_sample_plain(k, thr, 3))


@pytest.mark.parametrize("nw", [2, 3, 4])
@pytest.mark.parametrize("S", [1, 2, 20])
def test_assemble_chunk_mw(dev, nw, S):
    """K-ASM's multi-word form: both packings and sample ids, empty slices,
    a chunk from one stream, around its 1024-row tile."""
    rng = np.random.default_rng(nw * 100 + S)
    keys, counts = [], []
    for s in range(S):
        U = int(rng.integers(0, 3000)) if s else 2100
        rows = np.sort(rng.integers(-(2**62), 2**62, (U, nw)), axis=0)
        keys.append(torch.from_numpy(np.ascontiguousarray(rows.T)).to(dev))
        counts.append(torch.from_numpy(rng.integers(1, 2**32, U, dtype=np.int64)
                                       .astype(np.uint32).view(np.int32)).to(dev))
    before = kernels.launch_counts()["assemble_chunk_mw"]
    launches = 0
    for lens_of in (lambda U: U, lambda U: min(U, 1023), lambda U: U // 2 * (U % 3 != 0)):
        lens = np.array([lens_of(k.shape[1]) for k in keys])
        starts = np.array([k.shape[1] - n for k, n in zip(keys, lens)])
        for pack16, ids in ((True, False), (False, False), (False, True)):
            c = [x & 0x7FFF for x in counts] if pack16 else counts
            table = fused.ChunkTable(keys, c, starts, lens, S // 2)
            got = table.assemble(0, pack16, ids)
            want = fused.assemble_chunk_plain(keys, c, starts, lens, S // 2, pack16, ids)
            for g, w in zip(got, want):
                _eq(g, w)
            launches += int(lens.sum() > 0)
    assert kernels.launch_counts()["assemble_chunk_mw"] == before + launches


@pytest.mark.parametrize("nw", [2, 4])
def test_merge_lrt_mw_cuda_matches_cpu(dev, nw):
    """The packed and the full merge on [nw, N] keys: survivors, sums, count
    and geno rows equal to the CPU run's."""
    rng = np.random.default_rng(nw + 330)
    pool = np.unique(rng.integers(0, 2**64 - 1, (20_000, nw), dtype=np.uint64), axis=0)
    pool[:2000, 0] = pool[0, 0]
    pool = np.unique(pool, axis=0)
    kmers, counts = [], []
    for s in range(6):
        take = np.sort(rng.choice(len(pool), 8000, replace=False))
        kmers.append(pool[take])
        c = rng.integers(1, 300, 8000, dtype=np.uint32)
        c[:800] *= 1 + 30 * (s < 3)
        counts.append(c)
    keys, count, _ = build_triples_packed(kmers, counts, 3)
    gpu = merge_lrt(torch.from_numpy(keys).to(dev), torch.from_numpy(count).to(dev),
                    0.45, 0.55, 3.0)
    cpu = merge_lrt(torch.from_numpy(keys), torch.from_numpy(count), 0.45, 0.55, 3.0)
    assert gpu[0] == cpu[0] and gpu[1].shape[1] > 0
    for g, c in zip(gpu[1:], cpu[1:]):
        _eq(g, c)
    keys, count, sample, _ = merge_dev.build_triples(kmers, counts)
    thr = merge_dev.pca_threshold_u32(0.05)
    args = (6, 3, 0.45, 0.55, 3.0, True, True, thr, 5)
    gpu = merge_dev.merge_lrt_full(torch.from_numpy(keys).to(dev),
                                   torch.from_numpy(count).to(dev),
                                   torch.from_numpy(sample).to(dev), *args)
    cpu = merge_dev.merge_lrt_full(torch.from_numpy(keys), torch.from_numpy(count),
                                   torch.from_numpy(sample), *args)
    assert gpu[0] == cpu[0] and gpu[4].shape[0] > 0
    for g, c in zip(gpu[1:], cpu[1:]):
        _eq(g, c)


@pytest.mark.parametrize("k", [63, 128])
def test_count_sample_resident_mw_cuda_matches_cpu(dev, k, monkeypatch):
    """One chunk and several (dedup_sum on [nw, N] keys) with hard-min 2."""
    from kmdiff_tpu_torch.pipeline import count as tcount

    rng = np.random.default_rng(k + 340)
    codes = [rng.integers(0, 4, 50_000).astype(np.uint8) for _ in range(2)]
    motif = rng.integers(0, 4, 200).astype(np.uint8)
    for s in range(0, 49_000, 700):
        codes[0][s : s + 200] = motif
    codes[1][::151] = codec.INVALID
    for rows in (None, 1 << 14):
        if rows:
            monkeypatch.setattr(tcount, "SORT_ROWS", rows)
        g = fused.count_sample_resident(codes, k, 2, dev)
        c = fused.count_sample_resident(codes, k, 2, torch.device("cpu"))
        assert (g.U, g.max_count, g.n_distinct_pre, g.total_mass) == (
            c.U, c.max_count, c.n_distinct_pre, c.total_mass)
        _eq(g.keys, c.keys)
        _eq(g.counts, c.counts)
        assert np.array_equal(g.hist_uvec, c.hist_uvec) and g.U > 0


# -- K-FASTA -------------------------------------------------------------------

def _fasta_bytes(size: int, seed: int, fastq: bool) -> bytes:
    """`size` bytes of a random FASTA (sequence lines of 0-300 bytes,
    letters, N, IUPAC, '\\r', '>' inside lines) or FASTQ (strict four-line
    records, cut at `size`)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTACGTacgtNnRY\r>", dtype=np.uint8)
    out = bytearray()
    while len(out) < size:
        if fastq:
            n = int(rng.integers(1, 200))
            out += (b"@r\n" + bytes(letters[rng.integers(0, 16, n)]) + b"\n+\n"
                    + b"I" * n + b"\n")
        else:
            out += b">r\n"
            for _ in range(int(rng.integers(1, 4))):
                n = int(rng.choice([0, 1, 60, 151, 300]))
                out += bytes(letters[rng.integers(0, len(letters), n)]) + b"\n"
    return bytes(out[:size])


def _fasta_check(raw, fastq):
    """K-FASTA on raw (a uint8 tensor on the card) against its twin on the
    same tensor, in one launch."""
    before = kernels.launch_counts()["fasta_codes"]
    codes, strict = codec.fasta_codes(raw, fastq)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fasta_codes"] == before + (1 if raw.numel() else 0)
    want, want_strict = codec.fasta_codes_plain(raw, fastq)
    assert strict == want_strict
    if strict:
        _eq(codes, want)
    return codes, strict


@pytest.mark.parametrize("fastq", [False, True])
def test_fasta_codes_sizes_across_tiles(dev, fastq):
    """Sizes from one byte to 40 tiles (the look-back past one warp of
    predecessors), cut anywhere, on views at byte offsets 0..15, and whole
    strict FASTQ files."""
    tile = kernels.lib().kmd_fasta_codes_tile_bytes()
    assert tile == 8192
    sizes = (1, 15, 16, 17, tile - 1, tile, tile + 1, 2 * tile + 5,
             3 * tile - 1, 40_003, 40 * tile + 7)
    for n in sizes:
        data = _fasta_bytes(n, n, fastq)
        for lead in (0, 1, 7, 15):
            base = torch.frombuffer(bytearray(b"\0" * lead + data + b"\0" * 16),
                                    dtype=torch.uint8).to(dev)
            assert base.data_ptr() % 16 == 0
            _fasta_check(base[lead : lead + n], fastq)
    if fastq:  # whole records: strict
        data = _fasta_bytes(5 * tile, 3, True)
        data = data[: data.rindex(b"\n@") + 1]
        _, strict = _fasta_check(torch.frombuffer(bytearray(data),
                                                  dtype=torch.uint8).to(dev), True)
        assert strict


def test_fasta_codes_long_lines(dev):
    """An 8 MB sequence line (a single-line assembly), a header line over
    twelve tiles before it and a FASTQ record of 1 MB lines: the state of
    a line crosses hundreds of tiles."""
    rng = np.random.default_rng(11)
    seq = np.frombuffer(b"ACGTN", dtype=np.uint8)[rng.integers(0, 5, 8 << 20)]
    header = b">" + b"h" * 100_000 + b"\n"
    raw = torch.frombuffer(bytearray(header + seq.tobytes() + b"\n>x\nAC"),
                           dtype=torch.uint8).to(dev)
    codes, _ = _fasta_check(raw, False)
    assert codes.numel() == len(header) - 1 + (8 << 20) + 2 + 2
    assert bool((codes[: len(header) - 1] == int(codec.INVALID)).all())
    line = seq[: 1 << 20].tobytes()
    fq = b"@r\n" + line + b"\n+\n" + b"I" * len(line) + b"\n"
    _, strict = _fasta_check(torch.frombuffer(bytearray(fq * 3),
                                              dtype=torch.uint8).to(dev), True)
    assert strict


def test_fasta_codes_bench_sample_file(dev, tmp_path):
    """A kbench-shaped sample file (123,777 reads of 150 bp, 8-byte name
    lines) through io.fasta.device_codes on the card: equal to the host's
    flat_codes, one launch a file, no fallback; then a malformed FASTQ,
    which the record parser takes, and the same files from four threads."""
    import threading

    from kmdiff_tpu_torch import profiling
    from kmdiff_tpu_torch.io import fasta

    rng = np.random.default_rng(12)
    n_reads, size = 123_777, 150
    rec = np.empty((n_reads, 160), dtype=np.uint8)
    rec[:, :9] = np.frombuffer(b">r000000\n", dtype=np.uint8)
    rec[:, 2:8] = np.frombuffer(b"0123456789", dtype=np.uint8)[
        rng.integers(0, 10, (n_reads, 6))]
    rec[:, 9:159] = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, (n_reads, size))]
    rec[:, 159] = ord("\n")
    paths = [tmp_path / "s.fasta", tmp_path / "bad.fq", tmp_path / "t.fasta"]
    paths[0].write_bytes(rec.tobytes())
    paths[1].write_bytes(b"@r1\nACGT\nACGT\n+\nIIII\nIIII\n")
    paths[2].write_bytes(rec[::-1].tobytes())
    timings: dict = {}
    before = kernels.launch_counts()["fasta_codes"]
    with fasta.FileStaging(dev) as staging, profiling.collect(timings):
        for p in paths:
            got = fasta.device_codes(str(p), dev, staging)
            assert got.device == dev
            np.testing.assert_array_equal(got.cpu().numpy(), fasta.flat_codes(str(p)))
    assert kernels.launch_counts()["fasta_codes"] == before + 3
    assert (timings["parse_files"], timings["parse_fallback_files"]) == (3, 1)

    want = [fasta.flat_codes(str(p)) for p in paths]
    errors = []

    def work(i):
        try:
            with fasta.FileStaging(dev) as staging:
                for r in range(3):
                    j = (i + r) % 3
                    got = fasta.device_codes(str(paths[j]), dev, staging)
                    if not np.array_equal(got.cpu().numpy(), want[j]):
                        errors.append((i, j))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
