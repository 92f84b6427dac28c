"""Partition merge + LRT on the device (port of kmdiff_tpu/ops/merge_dev.py:
merge_lrt_local's packed branch and its full branch, wide sums included).

The S sorted per-sample streams of one partition (or the two group streams
after the host pre-sum) ship once as int64 keys plus one packed count per
row: the count with the row's control flag in bit 15 (int16, when every
count fits 15 bits) or in the sign bit (int32). On the device:

  torch.sort(keys)               the S-way merge; the permutation rides along
  K-RUN run_encode               distinct k-mers in one pass: their keys and
                                 [U, 2] control/case sums, read through the
                                 permutation (and their starts, for the full
                                 branch)
  K-LRT lrt_filter (S=2, nb_controls=1)
                                 f32 LR + margin keep on the [U, 2] sums
                                 (keep alone: the sums are K-RUN's)
  K-CMP compact                  survivors' keys and sums

The full branch (popstrat, --save-sk, and every cohort whose k-mer mass
reaches 2^31) ships each row's raw u32 count and its sample id; a row is a
control where its sample id is below nb_controls, as in the JAX package:

  K-RUN run_encode (full form)   [U, 2] int64 control/case sums, exact at any
                                 cohort mass
  K-LRT lrt_filter (int64)       keep on the int64 sums, each rounded to f32
                                 once

and adds per-sample rows of the selected runs:

  K-ROWS run_rows                survivors' [H, S] count rows
  K-GENO geno_sample, K-CMP      the run starts whose k-mer hash falls below
                                 the kmer_pca threshold
  K-ROWS run_rows (presence)     their [G, S] 0/1 geno rows

Only survivor-sized tensors come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch import kernels
from kmdiff_tpu_torch.ops.codec import (
    _avalanche,
    _run_ends,
    compact,
    run_encode,
    sort_keys,
    words_to_keys,
)
from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter

_U32 = 0xFFFFFFFF
_SAMPLE_SEED = 0x51ED2700


def _merge_runs(keys, count, ratio_c, ratio_k, lr_min, starts: bool,
                sample=None, nb_controls: int = 0):
    """The merge and test both branches share: sort, runs (their starts
    only if asked for), group sums (int64 with sample ids), K-LRT,
    survivors (multi-word keys: K-CMP's index form, then a gather a
    word)."""
    keys_s, perm = sort_keys(keys)
    starts, run_keys, n_valid, sums = run_encode(keys_s, perm, count,
                                                 starts=starts, sample=sample,
                                                 nb_controls=nb_controls)
    keep, _lr, _s_c, _s_k = lrt_filter(sums, 1, ratio_c, ratio_k, lr_min,
                                       want_lr=False, want_sums=False)
    if keys_s.dim() == 1:
        hit, hit_keys = compact(keep, run_keys)
    else:
        hit, _ = compact(keep)
        hit_keys = run_keys[:, hit]
    return perm, n_valid, starts, run_keys, sums, hit, hit_keys


def merge_lrt(keys: torch.Tensor, count: torch.Tensor, ratio_c, ratio_k,
              lr_min):
    """One chunk's merged test (merge_lrt_kernel's packed branch).

    keys [N] int64 or [nw, N] (any order), count [N] int16 or int32
    packed as build_triples_packed packs it. Returns (n_distinct, hit_keys
    [H] int64 or [nw, H] ascending, hit_sums [H, 2] int32) with the
    survivors on the keys' device."""
    _p, _nv, _st, run_keys, sums, hit, hit_keys = _merge_runs(
        keys, count, ratio_c, ratio_k, lr_min, starts=False)
    return run_keys.shape[-1], hit_keys, sums[hit]


def merge_lrt_full(keys: torch.Tensor, count: torch.Tensor,
                   sample: torch.Tensor, nb_samples: int, nb_controls: int,
                   ratio_c, ratio_k, lr_min, want_rows: bool, want_geno: bool,
                   pca_thr=0, pca_seed: int = 0):
    """One chunk's merged test with sample ids (merge_lrt_kernel with
    packed_ctrl=False: want_rows, want_geno, wide_sums).

    keys [N] int64 or [nw, N], count [N] int32 holding raw u32 counts and
    sample [N] int16 (u16 stream ids below nb_samples, those below nb_controls
    controls), as build_triples builds them. Returns (n_distinct, hit_keys
    [H] int64 ascending, hit_sums [H, 2] int64, hit_rows [H, S] int32
    holding u32 or None, geno_rows [G, S] uint8 or None): the survivors'
    count rows (want_rows) and the 0/1 rows of the run starts sampled at
    pca_thr (pca_threshold_u32) under pca_seed (want_geno), both in
    ascending key order."""
    perm, n_valid, starts, run_keys, sums, hit, hit_keys = _merge_runs(
        keys, count, ratio_c, ratio_k, lr_min, starts=want_rows or want_geno,
        sample=sample, nb_controls=nb_controls)
    rows = geno = None
    if want_rows:
        rows = run_rows(starts, n_valid, hit, perm, count, sample, nb_samples)
    if want_geno:
        sel, _ = compact(geno_sample(run_keys, pca_thr, pca_seed))
        geno = run_rows(starts, n_valid, sel, perm, count, sample, nb_samples,
                        presence=True)
    return run_keys.shape[-1], hit_keys, sums[hit], rows, geno


def pca_threshold_u32(rate: float) -> np.uint32:
    """The sampling threshold of kmer_pca = rate, as u32."""
    return np.uint32(min(rate, 1.0) * 4294967295.0)


# -- K-GENO --------------------------------------------------------------------

def geno_sample_plain(keys: torch.Tensor, thr, seed: int) -> torch.Tensor:
    """The hash chain over each word's hi32 then lo32, most significant
    word first (one-word keys [U] or multi-word [nw, U])."""
    rows = keys.reshape(1, -1) if keys.dim() == 1 else keys
    h = torch.full_like(rows[0], (_SAMPLE_SEED ^ int(seed)) & _U32)
    for word in rows:
        hi = ((word >> 32) & _U32) ^ 0x80000000  # the top half of key ^ 1<<63
        h = _avalanche(hi ^ h)
        h = _avalanche((word & _U32) ^ h)
    return h < int(thr)


def geno_sample(keys: torch.Tensor, thr, seed: int) -> torch.Tensor:
    """K-GENO: keys [U] int64 -> [U] bool, set where the k-mer's avalanche
    hash under seed falls below thr (u32). The mask of the JAX package's
    host sample_mask and of its device merge, for every layout.
    Multi-word keys [nw, U] (a view whose rows have unit stride is taken)
    chain over every word, K-GENO's multi-word form."""
    if keys.device.type == "cpu":
        return geno_sample_plain(keys, thr, seed)
    if keys.dim() == 2:
        ld = kernels.require_cuda_rows("geno_sample keys", keys)
        U = keys.shape[1]
        mask = torch.empty(U, dtype=torch.bool, device=keys.device)
        if U:
            with torch.cuda.device(keys.device):
                kernels.launch("geno_sample_mw", "kmd_geno_sample_mw",
                               keys.data_ptr(), ld, U, keys.shape[0], int(thr),
                               int(seed) & _U32, mask.data_ptr())
        return mask
    kernels.require_cuda_tensor("geno_sample keys", keys, torch.int64)
    U = keys.numel()
    mask = torch.empty(U, dtype=torch.bool, device=keys.device)
    if U:
        with torch.cuda.device(keys.device):
            kernels.launch("geno_sample", "kmd_geno_sample", keys.data_ptr(), U,
                           int(thr), int(seed) & _U32, mask.data_ptr())
    return mask


# -- K-ROWS --------------------------------------------------------------------

def run_rows_plain(starts, n_valid, sel, perm, count, sample, nb_samples: int,
                   presence: bool = False):
    ends = _run_ends(starts, n_valid)
    b, lens = starts[sel], ends[sel] - starts[sel]
    H = sel.numel()
    slot = torch.repeat_interleave(torch.arange(H, device=sel.device), lens)
    first = torch.cumsum(lens, 0) - lens
    r = torch.arange(slot.numel(), device=sel.device) - first[slot] + b[slot]
    p = perm[r]
    v = count[p]
    s = sample[p].to(torch.int64) & 0xFFFF
    ok = s < nb_samples
    rows = torch.zeros((H, nb_samples), dtype=torch.int32, device=sel.device)
    rows[slot[ok], s[ok]] = v[ok]
    return (rows != 0).to(torch.uint8) if presence else rows


def run_rows(starts: torch.Tensor, n_valid: torch.Tensor, sel: torch.Tensor,
             perm: torch.Tensor, count: torch.Tensor, sample: torch.Tensor,
             nb_samples: int, presence: bool = False) -> torch.Tensor:
    """K-ROWS: per selected run sel[h] (an index into starts), the
    per-sample row of its counts -> [H, S] int32 holding the raw u32
    counts (build_triples's), or with presence [H, S] uint8 (count != 0,
    so that a count of 2^31 or more is present). Row r of
    the sorted order is count[perm[r]] of sample sample[perm[r]]; a run
    ends at the next start or at n_valid. Sample ids >= S are ignored.
    One launch a call, none for an empty selection; the kernel writes
    every element, zeros included."""
    if starts.device.type == "cpu":
        return run_rows_plain(starts, n_valid, sel, perm, count, sample,
                              nb_samples, presence)
    for name, t, dt in (("starts", starts, torch.int64),
                        ("n_valid", n_valid, torch.int64),
                        ("sel", sel, torch.int64), ("perm", perm, torch.int64),
                        ("count", count, torch.int32),
                        ("sample", sample, torch.int16)):
        kernels.require_cuda_tensor(f"run_rows {name}", t, dt)
    H = sel.numel()
    rows = torch.empty((H, nb_samples),
                       dtype=torch.uint8 if presence else torch.int32,
                       device=starts.device)
    if H:
        with torch.cuda.device(starts.device):
            kernels.launch("run_rows", "kmd_run_rows", starts.data_ptr(),
                           starts.numel(), n_valid.data_ptr(), sel.data_ptr(), H,
                           perm.data_ptr(), count.data_ptr(), sample.data_ptr(),
                           nb_samples, int(presence), rows.data_ptr())
    return rows


def pack16_ok(counts_list: list[np.ndarray]) -> bool:
    """True when every count fits the 16-bit packing (value < 2^15)."""
    return all(int(c.max(initial=0)) < (1 << 15) for c in counts_list)


def build_triples_packed(kmers_list: list[np.ndarray],
                         counts_list: list[np.ndarray], nb_controls: int,
                         pack16: bool = False):
    """Host: per-stream sorted (kmers [n, nw] u64, counts [n] u32) -> (keys
    [N] int64, or [nw, N] for nw > 1, packed counts [N], N). Streams before nb_controls are
    controls: their flag is bit 15 of an int16 (pack16; counts < 2^15,
    see pack16_ok) or the sign bit of an int32. No padding: the device
    takes any N."""
    N = int(sum(len(k) for k in kmers_list))
    nw = kmers_list[0].shape[1] if kmers_list else 1
    keys = np.empty(N if nw == 1 else (nw, N), np.int64)
    count = np.empty(N, np.int16 if pack16 else np.int32)
    pos = 0
    for s, (k, c) in enumerate(zip(kmers_list, counts_list)):
        n = len(k)
        if n == 0:
            continue
        keys[..., pos : pos + n] = words_to_keys(k)
        if pack16:
            cu = c.astype(np.uint16)
            if s < nb_controls:
                cu |= np.uint16(0x8000)
            count[pos : pos + n] = cu.view(np.int16)
        else:
            ci = c.view(np.int32) if c.dtype == np.uint32 else c.astype(np.int32)
            count[pos : pos + n] = (ci | np.int32(-0x80000000)
                                    if s < nb_controls else ci)
        pos += n
    return keys, count, N


def build_triples(kmers_list: list[np.ndarray], counts_list: list[np.ndarray]):
    """Host: per-stream sorted (kmers [n, nw] u64, counts [n] u32) -> (keys
    [N] int64 or [nw, N], raw counts [N] int32 holding u32, sample ids [N] int16
    holding u16, N), the full branch's operands (merge_lrt_full): no
    control flag, which the merge reads from the sample id."""
    S = len(kmers_list)
    if S > 0xFFFF:
        raise ValueError(f"build_triples: {S} samples, at most 65535")
    keys, count, N = build_triples_packed(kmers_list, counts_list, 0)
    sample = np.repeat(np.arange(S, dtype=np.uint16),
                       [len(k) for k in kmers_list]).view(np.int16)
    return keys, count, sample, N


def quantile_key_split(kmers_list, n_ranges: int, budget_fn, *,
                       grow: bool, attempts: int, best_effort: bool = False):
    """Split per-sample SORTED streams into key-disjoint ranges at
    first-word quantile boundaries (free on sorted streams).

    budget_fn(R) gives the per-range row budget at R ranges; quantiles are
    approximate (first-word ties cap the resolution), so sizes are
    validated and R doubles (grow=True) or halves (grow=False) on
    overshoot, up to `attempts` tries.

    Returns (bounds u64 [R_eff-1], slices: per range a list of per-sample
    (a, b) index pairs, R) or None; with best_effort the last attempt's
    (possibly over-budget) split instead of None."""
    keys = np.concatenate([k[:, 0] for k in kmers_list if len(k)])
    if keys.size == 0:
        return None
    R = n_ranges
    last = None
    for _attempt in range(attempts):
        if R < 2:
            return None
        budget = budget_fn(R)
        qs = np.quantile(keys, np.linspace(0, 1, R + 1)[1:-1])
        bounds = np.unique(qs.astype(np.uint64))
        slices = []
        ok = True
        for r in range(len(bounds) + 1):
            lo_b = bounds[r - 1] if r > 0 else None
            hi_b = bounds[r] if r < len(bounds) else None
            per = []
            n = 0
            for km in kmers_list:
                a = np.searchsorted(km[:, 0], lo_b) if lo_b is not None else 0
                b = (np.searchsorted(km[:, 0], hi_b)
                     if hi_b is not None else len(km))
                per.append((a, b))
                n += b - a
            if n > budget:
                ok = False
            slices.append(per)
        if ok:
            return bounds, slices, R
        last = (bounds, slices, R)
        R = R * 2 if grow else R // 2
    return last if best_effort else None
