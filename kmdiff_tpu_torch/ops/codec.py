"""k-mer codec and counting on the device (port of kmdiff_tpu/ops/codec.py).

Keys. The JAX package carries a k-mer as u32 lanes (hi, lo per u64 word)
sorted lexicographically. Here a k-mer of k <= 32 (one u64 word in the
core/kmer.py::pack_codes layout) is one int64 key: the word XORed with
1<<63, so signed int64 order equals the unsigned word order and
``torch.sort`` sorts keys as the lanes sort. The all-ones word (XORed:
INT64_MAX, ``SENTINEL``) marks invalid windows; no canonical k-mer equals
it, and it sorts last. A k-mer of 33 <= k <= 128 takes nw = 2-4 words
(word 0 holds bases 0-31, the last word is right-aligned): its keys are a
word-major int64 tensor [nw, N], row w holding word w of every k-mer, each
XORed with 1<<63; rows sort lexicographically (``sort_rows``: stable
``torch.sort`` passes from the last word to the first), and the sentinel
row has every word INT64_MAX. Every function below takes either form and
returns the same form.

Kernels, each with its plain PyTorch twin in this module (the wrapper runs
the twin for a CPU tensor and the CUDA kernel for a CUDA tensor), and each
of K-EXT and K-RUN with a multi-word form beside the one-word one:

  K-EXT canonical_kmers   codes [N] u8 -> keys [N-k+1] int64, or [nw, N-k+1]
  K-RUN run_encode        sorted keys -> run keys, run starts (unless the
                          caller needs none), valid-row
                          count, and run lengths or (through the sort's
                          permutation) [U, 2] control/case sums of packed
                          counts (int32) or of raw u32 counts with sample
                          ids (int64), in one pass
  K-CMP compact           mask (+ int64 payload) -> ascending set indices
                          (+ gathered payload)
  K-WRUN weighted_run_sums
                          run starts + permuted u32 weights -> per-run
                          int64 sums
  K-HIST rle_stats        n_valid and u32 or int64 counts -> n_valid, the
                          largest count and [257] abundance cardinalities,
                          in one launch and one host sync
  K-PART partition_targets
                          keys -> each row's owner shard ((partition hash
                          mod P) mod D, D for a sentinel) and the rows a
                          shard gets: the mesh count's bucketing
  K-FASTA fasta_codes     a FASTA or FASTQ file's bytes [L] u8 -> its codes
                          [n] u8 (io/fasta.py::flat_codes' stream) and
                          whether a FASTQ file is strict, in one launch and
                          one host sync

``sort_rle`` and ``fused_count`` chain them into the counting program
(sort_rle_core / fused_count_kernel in the JAX package), ``dedup_sum`` into
the k-way merge of counted streams (dedup_sum_lanes). The sort itself is
``torch.sort`` on int64 keys, as the JAX package leaves it to XLA's sort.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from kmdiff_tpu_torch import kernels
from kmdiff_tpu_torch.core.kmer import n_words

#: sentinel code for invalid bases and read separators (codes are 0..3)
INVALID = np.uint8(0xFF)
#: sorted-key sentinel (the all-ones word with its top bit flipped)
SENTINEL = torch.iinfo(torch.int64).max
#: 1<<63 as an int64 (the order-preserving flip between u64 words and keys)
_SIGN = torch.iinfo(torch.int64).min
MAX_K = 128
#: abundance bins: 1..255 one value each, 256 for every count above 255
HIST_BINS = 257
_U32 = 0xFFFFFFFF


# -- host helpers --------------------------------------------------------------

def encode_ascii_block(seq_bytes: np.ndarray) -> np.ndarray:
    """ascii -> codes with INVALID for non-ACGT."""
    from kmdiff_tpu_torch.core.kmer import encode_bases

    codes, valid = encode_bases(seq_bytes)
    return np.where(valid, codes, INVALID)


def words_to_keys(kmers: np.ndarray) -> np.ndarray:
    """[n, nw] u64 words -> [n] int64 sort keys (nw = 1) or [nw, n]
    int64 word-major keys (nw = 2-4)."""
    if kmers.ndim != 2 or not 1 <= kmers.shape[1] <= 4:
        raise ValueError(f"words_to_keys: expected [n, 1-4] words, got "
                         f"{kmers.shape}")
    if kmers.shape[1] == 1:
        return (kmers[:, 0] ^ np.uint64(1 << 63)).view(np.int64)
    return np.ascontiguousarray((kmers ^ np.uint64(1 << 63)).view(np.int64).T)


def keys_to_words(keys: np.ndarray) -> np.ndarray:
    """[n] int64 sort keys -> [n, 1] u64 words; [nw, n] word-major keys ->
    [n, nw] u64 words."""
    keys = np.asarray(keys, np.int64)
    if keys.ndim == 1:
        return (keys.view(np.uint64) ^ np.uint64(1 << 63)).reshape(-1, 1)
    return np.ascontiguousarray((keys.view(np.uint64) ^ np.uint64(1 << 63)).T)


def sort_rows(keys: torch.Tensor):
    """Lexicographic sort of [nw, N] word-major keys -> (sorted keys [nw,
    N], the permutation [N] int64): stable torch.sort passes from the last
    word to the first, each composing the permutation."""
    perm = None
    for w in range(keys.shape[0] - 1, -1, -1):
        col = keys[w] if perm is None else keys[w][perm]
        p = torch.sort(col, stable=True).indices
        perm = p if perm is None else perm[p]
    if perm is None:
        perm = torch.zeros(0, dtype=torch.int64, device=keys.device)
    return keys[:, perm], perm


def sort_keys(keys: torch.Tensor):
    """torch.sort of one-word keys, sort_rows of multi-word ones -> (sorted
    keys, permutation)."""
    if keys.dim() == 1:
        return torch.sort(keys)
    return sort_rows(keys)




# -- K-EXT ---------------------------------------------------------------------

def canonical_kmers_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """All k-windows as canonical int64 keys, as a k-step ladder of
    shifted ORs (the JAX extraction's form); SENTINEL where the window
    holds an INVALID code."""
    N = codes.numel()
    W = N - k + 1
    if W <= 0:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    bad = codes == int(INVALID)
    cum = torch.zeros(N + 1, dtype=torch.int64, device=codes.device)
    cum[1:] = torch.cumsum(bad.to(torch.int64), 0)
    ok = (cum[k:] - cum[:-k]) == 0
    base = torch.where(bad, 0, codes.to(torch.int64) & 3)
    fwd = torch.zeros(W, dtype=torch.int64, device=codes.device)
    rc = torch.zeros(W, dtype=torch.int64, device=codes.device)
    for j in range(k):
        cj = base[j : j + W]
        fwd |= cj << (2 * (k - 1 - j))
        rc |= (cj ^ 2) << (2 * j)
    canon = torch.minimum(fwd ^ _SIGN, rc ^ _SIGN)  # unsigned min
    return torch.where(ok, canon, SENTINEL)


def canonical_kmers_mw_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The multi-word twin (33 <= k <= 128): the k-step ladder of shifted
    ORs over nw words (kmdiff_tpu/ops/codec.py::_lane_shift's layout), the
    lexicographic min of forward and reverse complement; the sentinel row
    where the window holds an INVALID code -> [nw, N-k+1] int64."""
    nw = n_words(k)
    N = codes.numel()
    W = max(N - k + 1, 0)
    dev = codes.device
    if W == 0:
        return torch.empty((nw, 0), dtype=torch.int64, device=dev)
    bad = codes == int(INVALID)
    cum = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(bad.to(torch.int64), 0)
    ok = (cum[k:] - cum[:-k]) == 0
    base = torch.where(bad, 0, codes.to(torch.int64) & 3)
    fwd = torch.zeros((nw, W), dtype=torch.int64, device=dev)
    rc = torch.zeros((nw, W), dtype=torch.int64, device=dev)

    def at(i):  # (word, shift) of base i
        w = i // 32
        return w, 2 * (min(k, 32 * (w + 1)) - 1 - i)

    for j in range(k):
        cj = base[j : j + W]
        w, sh = at(j)
        fwd[w] |= cj << sh
        w, sh = at(k - 1 - j)
        rc[w] |= (cj ^ 2) << sh
    fwd ^= _SIGN  # signed order of the flipped words = unsigned word order
    rc ^= _SIGN
    take_rc = torch.zeros(W, dtype=torch.bool, device=dev)
    undecided = torch.ones(W, dtype=torch.bool, device=dev)
    for w in range(nw):
        take_rc |= undecided & (rc[w] < fwd[w])
        undecided &= rc[w] == fwd[w]
    return torch.where(ok & ~take_rc, fwd, torch.where(ok, rc, SENTINEL))


def canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """K-EXT: codes [N] u8 -> canonical keys [N-k+1] int64 (k <= 32), or
    [nw, N-k+1] int64 word-major (33 <= k <= 128: the multi-word form)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the port's keys cover 1 <= k <= {MAX_K}")
    if k > 32:
        return _canonical_kmers_mw(codes, k)
    if codes.device.type == "cpu":
        return canonical_kmers_plain(codes, k)
    kernels.require_cuda_tensor("canonical_kmers codes", codes, torch.uint8)
    N = codes.numel()
    W = max(N - k + 1, 0)
    keys = torch.empty(W, dtype=torch.int64, device=codes.device)
    if W:
        with torch.cuda.device(codes.device):
            kernels.launch("canonical_kmers", "kmd_canonical_kmers",
                           codes.data_ptr(), N, k, keys.data_ptr())
    return keys


def _canonical_kmers_mw(codes: torch.Tensor, k: int) -> torch.Tensor:
    if codes.device.type == "cpu":
        return canonical_kmers_mw_plain(codes, k)
    kernels.require_cuda_tensor("canonical_kmers codes", codes, torch.uint8)
    N = codes.numel()
    W = max(N - k + 1, 0)
    keys = torch.empty((n_words(k), W), dtype=torch.int64, device=codes.device)
    if W:
        with torch.cuda.device(codes.device):
            kernels.launch("canonical_kmers_mw", "kmd_canonical_kmers_mw",
                           codes.data_ptr(), N, k, keys.data_ptr())
    return keys


# -- K-RUN ---------------------------------------------------------------------
# The plain twin composes the run's steps one tensor at a time: flags, K-CMP's
# twin, then the lengths or the group sums.

def run_flags_plain(keys: torch.Tensor):
    if keys.dim() == 1:
        valid = keys != SENTINEL
        flags = valid.clone()
        flags[1:] &= keys[1:] != keys[:-1]
    else:  # a row is valid where any word is not the sentinel's
        valid = (keys != SENTINEL).any(0)
        flags = valid.clone()
        flags[1:] &= (keys[:, 1:] != keys[:, :-1]).any(0)
    n_valid = valid.sum(dtype=torch.int64).reshape(1)
    return flags, n_valid


def _run_ends(starts: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    return torch.cat([starts[1:], n_valid])


def run_lengths_plain(starts: torch.Tensor, n_valid: torch.Tensor):
    return (_run_ends(starts, n_valid) - starts).to(torch.int32)


def _unpack_ctrl(count: torch.Tensor, sample=None, nb_controls: int = 0):
    """Packed counts -> (is_control, value) as int64, for both packings
    (ops.merge_dev.build_triples_packed); with sample ids, raw u32 counts
    (int32) whose row is a control where its u16 sample id is below
    nb_controls (ops.merge_dev.build_triples)."""
    c = count.to(torch.int64)
    if sample is not None:
        return (sample.to(torch.int64) & 0xFFFF) < nb_controls, c & _U32
    if count.dtype == torch.int16:
        u = c & 0xFFFF
        return (u & 0x8000) != 0, u & 0x7FFF
    if count.dtype == torch.int32:
        return c < 0, c & 0x7FFFFFFF
    raise TypeError(f"packed counts must be int16 or int32, got {count.dtype}")


def run_group_sums_plain(starts, n_valid, perm, count, sample=None,
                         nb_controls: int = 0):
    ctrl, v = _unpack_ctrl(count[perm], None if sample is None else sample[perm],
                           nb_controls)
    ends = _run_ends(starts, n_valid)
    sums = []
    for col in (torch.where(ctrl, v, 0), torch.where(ctrl, 0, v)):
        cs = torch.zeros(col.numel() + 1, dtype=torch.int64, device=col.device)
        cs[1:] = torch.cumsum(col, 0)
        sums.append(cs[ends] - cs[starts])
    sums = torch.stack(sums, 1)
    return sums if sample is not None else sums.to(torch.int32)


def run_encode_plain(keys_s, perm=None, count=None, lengths: bool = False,
                     starts: bool = True, sample=None, nb_controls: int = 0):
    flags, n_valid = run_flags_plain(keys_s)
    run_starts = compact_plain(flags)[0]
    run_keys = keys_s[..., run_starts]
    if count is not None:
        third = run_group_sums_plain(run_starts, n_valid, perm, count, sample,
                                     nb_controls)
    elif lengths:
        third = run_lengths_plain(run_starts, n_valid)
    else:
        third = None
    return run_starts if starts else None, run_keys, n_valid, third


#: kmd_run_encode's merge forms by packed-count dtype (0 is the dedup
#: form, 1 the count form, 4 the full form: raw counts with sample ids)
_MERGE_FORMS = {torch.int16: 2, torch.int32: 3}
_FULL_FORM = 4


@functools.cache
def _run_tile_rows(form: int) -> int:
    return kernels.lib().kmd_run_encode_tile_rows(form)


def run_encode(keys_s: torch.Tensor, perm: torch.Tensor | None = None,
               count: torch.Tensor | None = None, lengths: bool = False,
               starts: bool = True, sample: torch.Tensor | None = None,
               nb_controls: int = 0):
    """K-RUN: sorted keys [N] int64 (sentinel tail allowed) -> (starts [U]
    int64, the row where each run of equal non-sentinel keys starts, or
    None unless starts; run_keys [U] int64, its key; n_valid [1] int64, the
    rows before the sentinel tail; third), third being, with count (and
    perm, the sort's permutation), [U, 2] int32 control and case sums of
    the packed counts of each run's rows (row r's count is count[perm[r]],
    int16 or int32 as merge_dev.build_triples_packed packs it); with
    sample ids too (the full form: [N] int16 holding u16, row r a control
    where sample[perm[r]] < nb_controls), [U, 2] int64 sums of the raw u32
    counts (int32, as merge_dev.build_triples builds them), exact at any
    cohort mass; with lengths, [U] int32 run lengths; else None.

    One kernel, one memset and one host sync (U sizes the results): one
    allocation holds the outputs at N rows each and the kernel's scratch,
    and the results are views of it, which hold the whole allocation until
    all are freed.

    Multi-word keys (k > 32): keys_s [nw, N] sorted lexicographically (a
    view whose rows have unit stride is taken) -> run keys [nw, U], a
    [:, :U] view of nw rows of N words, from K-RUN's multi-word form; a
    row starts a run where any word differs from the row before it."""
    if keys_s.device.type == "cpu":
        return run_encode_plain(keys_s, perm, count, lengths, starts, sample,
                                nb_controls)
    if keys_s.dim() == 1:
        kernels.require_cuda_tensor("run_encode keys", keys_s, torch.int64)
        N = keys_s.numel()
    else:
        N = keys_s.shape[1]
    if count is None:
        form = 1 if lengths else 0
    else:
        full = sample is not None
        if perm is None or count.dtype not in ((torch.int32,) if full
                                               else (torch.int16, torch.int32)):
            raise TypeError("run_encode: the merge form takes perm and int16 "
                            "or int32 packed counts, the full form perm, raw "
                            f"int32 counts and sample ids, got {count.dtype}")
        kernels.require_cuda_tensor("run_encode perm", perm, torch.int64)
        kernels.require_cuda_tensor("run_encode count", count, count.dtype)
        if full:
            kernels.require_cuda_tensor("run_encode sample", sample, torch.int16)
        if perm.numel() != N or count.numel() != N or (full and sample.numel() != N):
            raise ValueError(f"run_encode: {N} keys, {perm.numel()} perm, "
                             f"{count.numel()} counts")
        form = _FULL_FORM if full else _MERGE_FORMS[count.dtype]
    if keys_s.dim() == 2:
        return _run_encode_mw(keys_s, N, form, perm, count, starts, sample,
                              nb_controls)
    n_tiles = -(-N // _run_tile_rows(form))
    # int64 words: [run keys: N][n_valid: 1][scratch: 1 + n_tiles]
    # [starts: N, if asked for][lengths: N int32 | sums: N x 2 int32 |
    # full sums: N x 2 int64, from an even word (16-byte stores)]
    at = N + 2 + n_tiles
    third_at = at + N if starts else at
    third_words = (0, (N + 1) // 2, N, N, 2 * N)[form]
    buf = torch.empty(third_at + third_words + (form == _FULL_FORM),
                      dtype=torch.int64, device=keys_s.device)
    if form == _FULL_FORM and (buf.data_ptr() + 8 * third_at) % 16:
        third_at += 1
    n_valid = buf[N : N + 1]
    U = 0
    if N:
        n_runs = _count_slot()
        base = buf.data_ptr()
        with torch.cuda.device(keys_s.device):
            kernels.launch("run_bounds", "kmd_run_encode", keys_s.data_ptr(), N,
                           form, kernels.ptr(perm), kernels.ptr(count),
                           kernels.ptr(sample), nb_controls,
                           base + 8 * at if starts else None, base,
                           base + 8 * third_at if third_words else None,
                           base + 8 * N, base + 8 * (N + 1),
                           ctypes.addressof(n_runs))
        U = n_runs.value
    else:
        n_valid.zero_()
    third = _third(buf, form, third_at, U)
    return buf[at : at + U] if starts else None, buf[:U], n_valid, third


def _third(buf: torch.Tensor, form: int, third_at: int, U: int):
    """K-RUN's third output, a view of its buffer from word third_at: the
    lengths [U] int32 (count form), the [U, 2] int32 or int64 sums (merge
    and full forms), or None (dedup form)."""
    if form == 1:
        return buf[third_at:].view(torch.int32)[:U]
    if form == _FULL_FORM:
        return buf[third_at : third_at + 2 * U].view(U, 2)
    if form > 1:
        return buf[third_at:].view(torch.int32)[: 2 * U].view(U, 2)
    return None


def _run_encode_mw(keys_s, N: int, form: int, perm, count, starts: bool,
                   sample, nb_controls: int):
    """K-RUN's multi-word form: run_encode on [nw, N] keys -> run keys
    [nw, U], a [:, :U] view of rows of N words; the rest as run_encode's."""
    ld = kernels.require_cuda_rows("run_encode keys", keys_s)
    nw = keys_s.shape[0]
    n_tiles = -(-N // _run_mw_tile_rows())
    # int64 words: [run keys: nw x N][n_valid: 1][scratch: 1 + n_tiles]
    # [starts: N, if asked for][third, as run_encode's]
    at = nw * N + 2 + n_tiles
    third_at = at + N if starts else at
    third_words = (0, (N + 1) // 2, N, N, 2 * N)[form]
    buf = torch.empty(third_at + third_words + (form == _FULL_FORM),
                      dtype=torch.int64, device=keys_s.device)
    if form == _FULL_FORM and (buf.data_ptr() + 8 * third_at) % 16:
        third_at += 1
    n_valid = buf[nw * N : nw * N + 1]
    U = 0
    if N:
        n_runs = _count_slot()
        base = buf.data_ptr()
        with torch.cuda.device(keys_s.device):
            kernels.launch("run_bounds_mw", "kmd_run_encode_mw", keys_s.data_ptr(),
                           ld, N, nw, form, kernels.ptr(perm), kernels.ptr(count),
                           kernels.ptr(sample), nb_controls,
                           base + 8 * at if starts else None, base, N,
                           base + 8 * third_at if third_words else None,
                           base + 8 * nw * N, base + 8 * (nw * N + 1),
                           ctypes.addressof(n_runs))
        U = n_runs.value
    else:
        n_valid.zero_()
    run_keys = buf[: nw * N].view(nw, N)[:, :U]
    return (buf[at : at + U] if starts else None, run_keys, n_valid,
            _third(buf, form, third_at, U))


@functools.cache
def _run_mw_tile_rows() -> int:
    return kernels.lib().kmd_run_encode_mw_tile_rows()


# -- K-CMP ---------------------------------------------------------------------

def compact_plain(mask: torch.Tensor, payload: torch.Tensor | None = None):
    idx = torch.nonzero(mask).flatten()
    return idx, (payload[idx] if payload is not None else None)


def compact(mask: torch.Tensor, payload: torch.Tensor | None = None):
    """K-CMP: mask [N] bool -> (ascending indices of the set rows [n]
    int64, payload[indices] or None). n is exact, with no budget and no
    retry: one allocation holds both outputs at N rows each and the
    kernel's scratch, one kernel writes the n set rows, and n into this
    thread's page-locked count slot, and the C entry point waits for it.
    The results are [:n] views, which hold the whole allocation until both
    are freed."""
    if mask.device.type == "cpu":
        return compact_plain(mask, payload)
    kernels.require_cuda_tensor("compact mask", mask, torch.bool)
    N = mask.numel()
    if payload is not None:
        kernels.require_cuda_tensor("compact payload", payload, torch.int64)
        if payload.numel() != N:
            raise ValueError(f"compact: payload has {payload.numel()} rows, "
                             f"mask has {N}")
    # tiles start at the 16-byte boundary at or below the mask
    n_tiles = -(-(N + mask.data_ptr() % 16) // kernels.lib().kmd_compact_tile_rows())
    # [indices: N][payload values: N, with a payload][scratch]
    n_out = N if payload is None else 2 * N
    buf = torch.empty(n_out + 1 + n_tiles, dtype=torch.int64, device=mask.device)
    n = 0
    if N:
        n_set = _count_slot()
        base = buf.data_ptr()
        with torch.cuda.device(mask.device):
            kernels.launch("compact", "kmd_compact", mask.data_ptr(), N,
                           kernels.ptr(payload), base,
                           base + 8 * N if payload is not None else None,
                           base + 8 * n_out, ctypes.addressof(n_set))
        n = n_set.value
    return buf[:n], (buf[N : N + n] if payload is not None else None)


_thread = threading.local()


def _count_slot() -> ctypes.c_longlong:
    """This thread's page-locked int64 that K-CMP and K-RUN write their
    count into; one a thread suffices, since a call waits for its kernel."""
    slot = getattr(_thread, "compact_count", None)
    if slot is None:
        pinned = torch.empty(1, dtype=torch.int64, pin_memory=True)
        slot = (pinned, ctypes.c_longlong.from_address(pinned.data_ptr()))
        _thread.compact_count = slot
    return slot[1]


# -- K-WRUN --------------------------------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 holding u32 bit patterns -> their values as int64."""
    return t.to(torch.int64) & _U32


def weighted_run_sums_plain(starts, n_valid, perm, weights):
    w = _u32(weights[perm])
    cs = torch.zeros(w.numel() + 1, dtype=torch.int64, device=w.device)
    cs[1:] = torch.cumsum(w, 0)
    return cs[_run_ends(starts, n_valid)] - cs[starts]


def weighted_run_sums(starts: torch.Tensor, n_valid: torch.Tensor,
                      perm: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """K-WRUN: per run, the sum of the u32 weights of its rows (row r of
    the sorted order is weights[perm[r]]; weights int32 holding u32 bit
    patterns) -> [U] int64, exact."""
    if starts.device.type == "cpu":
        return weighted_run_sums_plain(starts, n_valid, perm, weights)
    kernels.require_cuda_tensor("weighted_run_sums starts", starts, torch.int64)
    kernels.require_cuda_tensor("weighted_run_sums n_valid", n_valid, torch.int64)
    kernels.require_cuda_tensor("weighted_run_sums perm", perm, torch.int64)
    kernels.require_cuda_tensor("weighted_run_sums weights", weights, torch.int32)
    U = starts.numel()
    sums = torch.empty(U, dtype=torch.int64, device=starts.device)
    if U:
        with torch.cuda.device(starts.device):
            kernels.launch("weighted_runs", "kmd_weighted_run_sums",
                           starts.data_ptr(), U, n_valid.data_ptr(),
                           perm.data_ptr(), weights.data_ptr(), sums.data_ptr())
    return sums


# -- K-HIST --------------------------------------------------------------------

@dataclasses.dataclass
class RleStats:
    """What sort_rle_core's stats read carries besides n_distinct."""

    n_valid: int      # non-sentinel input rows (counted windows for sort_rle)
    max_count: int    # largest count (0 when there is none)
    hist: np.ndarray | None  # [257] int64 abundance bins, with_hist only


def rle_stats_plain(n_valid: torch.Tensor, counts: torch.Tensor,
                    with_hist: bool) -> RleStats:
    c64 = counts if counts.dtype == torch.int64 else _u32(counts)
    hist = None
    if with_hist:
        top = HIST_BINS - 1
        bins = torch.where((c64 >= 0) & (c64 < top), c64, top)
        hist = torch.bincount(bins, minlength=HIST_BINS).cpu().numpy()
    return RleStats(int(n_valid), int(c64.max()) if c64.numel() else 0, hist)


def _stats_slots(dev: torch.device):
    """This thread's K-HIST accumulators on `dev` (zero between calls: each
    call's last block clears them) and its page-locked result row."""
    slots = getattr(_thread, "stats", None)
    if slots is None:
        slots = _thread.stats = {}
    slot = slots.get(dev.index)
    if slot is None:
        words = kernels.lib().kmd_count_stats_scratch_words()
        out = torch.empty(2 + HIST_BINS, dtype=torch.int64, pin_memory=True)
        slot = slots[dev.index] = (
            torch.zeros(words, dtype=torch.int64, device=dev), out, out.numpy())
    return slot


def rle_stats(n_valid: torch.Tensor, counts: torch.Tensor,
              with_hist: bool) -> RleStats:
    """K-HIST: n_valid [1] int64 (K-RUN's) and counts [U], int32 holding
    u32 (sort_rle's run lengths) or int64 (dedup_sum's sums) -> RleStats:
    n_valid, the largest count, and with_hist the [257] int64 histogram,
    bin b in 1..255 the number of counts equal to b, bin 256 the number
    above 255 (the JAX package's uvec[1:]; bin 0 counts zeros). One launch
    and one host sync, whatever U (0 included)."""
    if counts.device.type == "cpu":
        return rle_stats_plain(n_valid, counts, with_hist)
    if counts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"rle_stats: counts must be int32 or int64, got {counts.dtype}")
    kernels.require_cuda_tensor("rle_stats counts", counts, counts.dtype)
    kernels.require_cuda_tensor("rle_stats n_valid", n_valid, torch.int64)
    scratch, out, host = _stats_slots(counts.device)
    with torch.cuda.device(counts.device):
        kernels.launch("abundance_hist", "kmd_count_stats", counts.data_ptr(),
                       counts.numel(), int(counts.dtype == torch.int64),
                       int(with_hist), n_valid.data_ptr(), scratch.data_ptr(),
                       out.data_ptr())
    return RleStats(int(host[0]), int(host[1]),
                    host[2:].copy() if with_hist else None)


# -- K-PART --------------------------------------------------------------------
# The partition hash of pipeline/count.py::host_partition_ids (the JAX
# package's partition_ids_lanes), on int64 values below 2^32 with explicit
# masks.

_HASH_SEED = 0x9E3779B9


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h < 2^32 in int64, in 16-bit halves of c so
    that no product reaches 2^63."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 on int64 values below 2^32."""
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def partition_targets_plain(keys: torch.Tensor, nb_partitions: int,
                            n_shards: int):
    rows = keys.reshape(1, -1) if keys.dim() == 1 else keys
    h = torch.full_like(rows[0], _HASH_SEED)
    for word in rows:
        hi = ((word >> 32) & _U32) ^ 0x80000000  # the top half of key ^ 1<<63
        h = _avalanche(hi ^ h)
        h = _avalanche((word & _U32) ^ h)
    sentinel = (rows == SENTINEL).all(0)
    targets = torch.where(sentinel, n_shards,
                          h % nb_partitions % n_shards).to(torch.int32)
    counts = torch.bincount(targets.to(torch.int64), minlength=n_shards + 1)
    return targets, counts


def partition_targets(keys: torch.Tensor, nb_partitions: int, n_shards: int):
    """K-PART: keys [N] int64 or [nw, N] word-major (a view whose rows have
    unit stride is taken) -> (targets [N] int32, each row's owner shard:
    (its partition, host_partition_ids' hash mod nb_partitions) mod
    n_shards, or n_shards for a sentinel row; counts [n_shards + 1] int64,
    the rows of each target). One launch a call; the counts stay on the
    device."""
    if not 1 <= n_shards <= 1024 or nb_partitions < 1:
        raise ValueError(f"partition_targets: {n_shards} shards, "
                         f"{nb_partitions} partitions")
    if keys.device.type == "cpu":
        return partition_targets_plain(keys, nb_partitions, n_shards)
    if keys.dim() == 1:
        kernels.require_cuda_tensor("partition_targets keys", keys, torch.int64)
        nw, ld = 1, keys.numel()
    else:
        ld = kernels.require_cuda_rows("partition_targets keys", keys)
        nw = keys.shape[0]
    N = keys.shape[-1]
    targets = torch.empty(N, dtype=torch.int32, device=keys.device)
    counts = torch.empty(n_shards + 1, dtype=torch.int64, device=keys.device)
    with torch.cuda.device(keys.device):
        kernels.launch("partition_ids", "kmd_partition_ids", keys.data_ptr(),
                       ld, N, nw, nb_partitions, n_shards, targets.data_ptr(),
                       counts.data_ptr())
    return targets, counts


# -- K-FASTA -------------------------------------------------------------------

_FASTA, _FASTQ = 0x3E, 0x40  # a file's first byte: '>' or '@'


def fasta_codes_plain(raw: torch.Tensor, fastq: bool):
    """K-FASTA's twin: io/fasta.py::flat_codes' logic on a tensor, for a
    file that is not redone by the record parser."""
    L = raw.numel()
    if L == 0:
        return torch.zeros(0, dtype=torch.uint8, device=raw.device), True
    table = torch.from_numpy(encode_ascii_block(np.arange(256, dtype=np.uint8)))
    nl = raw == 0x0A
    # each byte's line: the newlines before it
    line = torch.cumsum(nl, 0) - nl.to(torch.int64)
    starts = torch.ones(L, dtype=torch.bool, device=raw.device)
    starts[1:] = nl[:-1]
    first = raw[starts]  # each line's first byte
    if fastq:
        strict = (first.numel() % 4 == 0 and bool((first[0::4] == _FASTQ).all())
                  and bool((first[2::4] == 0x2B).all()))
        masked = line % 4 != 1  # sequence lines only
    else:
        strict = True
        masked = (first == _FASTA)[line]
    codes = torch.where(masked, int(INVALID), table.to(raw.device)[raw.long()])
    return codes[~nl], strict


def _fasta_slot() -> torch.Tensor:
    """This thread's page-locked pair that K-FASTA writes its results
    into; one a thread suffices, since a call waits for its kernel."""
    slot = getattr(_thread, "fasta", None)
    if slot is None:
        slot = _thread.fasta = torch.empty(2, dtype=torch.int64, pin_memory=True)
    return slot


def fasta_codes(raw: torch.Tensor, fastq: bool):
    """K-FASTA: a FASTA (fastq False: its first byte '>') or FASTQ (its
    first byte '@') file's bytes [L] u8 -> (its 2-bit codes [n] u8, strict):
    the codes of io/fasta.py::flat_codes, byte for byte, with the header
    lines (FASTQ: every line but the sequences) INVALID and the newlines
    dropped; strict is False for a FASTQ file that is not four-line
    records, whose codes the caller must take from the record parser
    instead. One allocation holds the codes at L bytes and the kernel's
    scratch, one kernel writes n codes, and n and strict into this thread's
    page-locked pair, and the C entry point waits for it: the codes are a
    [:n] view."""
    if raw.device.type == "cpu":
        return fasta_codes_plain(raw, fastq)
    kernels.require_cuda_tensor("fasta_codes raw", raw, torch.uint8)
    L = raw.numel()
    if L == 0:
        return torch.zeros(0, dtype=torch.uint8, device=raw.device), True
    # tiles start at the 16-byte boundary at or below the bytes
    tile = kernels.lib().kmd_fasta_codes_tile_bytes()
    n_tiles = -(-(L + raw.data_ptr() % 16) // tile)
    # [codes: L, to a multiple of 16][scratch: int64, 1 + n_tiles]
    out_bytes = -(-L // 16) * 16
    buf = torch.empty(out_bytes + 8 * (1 + n_tiles), dtype=torch.uint8,
                      device=raw.device)
    slot = _fasta_slot()
    with torch.cuda.device(raw.device):
        kernels.launch("fasta_codes", "kmd_fasta_codes", raw.data_ptr(), L,
                       int(fastq), buf.data_ptr(), buf.data_ptr() + out_bytes,
                       slot.data_ptr())
    n, strict = slot.tolist()
    return buf[:n], bool(strict)


# -- counting ------------------------------------------------------------------


def sort_rle(keys: torch.Tensor, with_hist: bool = False):
    """Sort keys and run-length encode them (the JAX package's
    sort_rle_core without weights): -> (distinct keys [U] ascending, counts
    [U] int32), and with_hist also RleStats with the histogram (K-HIST).
    Sentinel keys are dropped. The keys and counts are [:U] views of
    K-RUN's buffer, which writes no run starts here."""
    _, run_keys, n_valid, counts = run_encode(sort_keys(keys)[0],
                                              lengths=True, starts=False)
    if not with_hist:
        return run_keys, counts
    return run_keys, counts, rle_stats(n_valid, counts, True)


def keep_at_least(keys: torch.Tensor, counts: torch.Tensor, hard_min: int):
    """The rows whose count (int64, or int32 holding u32) is >= hard_min,
    in order (K-CMP)."""
    c64 = counts if counts.dtype == torch.int64 else _u32(counts)
    if keys.dim() == 2:
        idx, _ = compact(c64 >= hard_min)
        return keys[:, idx], counts[idx]
    idx, kept = compact(c64 >= hard_min, keys)
    return kept, counts[idx]


def dedup_sum(keys: torch.Tensor, weights: torch.Tensor, hard_min: int = 1,
              with_hist: bool = False):
    """k-way merge of counted streams (the JAX package's dedup_sum_lanes):
    keys [N] int64 in any order, weights [N] int32 holding u32 counts ->
    (distinct keys [U] ascending, counts [U] int32 holding each key's u32
    weight sum, RleStats). Runs summing below hard_min are dropped, and the
    stats (max, histogram) describe the kept runs.

    torch.sort with its permutation, run starts (K-RUN), the per-run sums
    read through the permutation (K-WRUN), exact in int64, and their stats
    (K-HIST on the int64 sums). Each sum
    must fit the u32 of the count files (as the JAX package's wrapped-u32
    sums assume); OverflowError otherwise."""
    keys_s, perm = sort_keys(keys)
    starts, run_keys, n_valid, _ = run_encode(keys_s)
    sums = weighted_run_sums(starts, n_valid, perm, weights)
    if hard_min > 1:
        run_keys, sums = keep_at_least(run_keys, sums, hard_min)
    stats = rle_stats(n_valid, sums, with_hist)
    if stats.max_count > _U32:
        raise OverflowError(f"a k-mer's summed count {stats.max_count} "
                            "exceeds the u32 of the count files")
    return run_keys, sums.to(torch.int32), stats


def fused_count(codes: torch.Tensor, k: int):
    """One code chunk -> its distinct canonical k-mer keys and counts
    (the JAX package's fused_count_kernel): K-EXT, torch.sort and K-RUN on
    the chunk's device."""
    return sort_rle(canonical_kmers(codes, k))
