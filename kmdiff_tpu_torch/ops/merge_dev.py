"""Partition merge + LRT on the device (port of kmdiff_tpu/ops/merge_dev.py,
the packed narrow branch of merge_lrt_local).

The S sorted per-sample streams of one partition (or the two group streams
after the host pre-sum) ship once as int64 keys plus one packed count per
row: the count with the row's control flag in bit 15 (int16, when every
count fits 15 bits) or in the sign bit (int32). On the device:

  torch.sort(keys)               the S-way merge; the permutation rides along
  K-RUN run_flags, K-CMP         distinct k-mers: run starts and their keys
  K-RUN run_group_sums           [U, 2] control/case sums, read through the
                                 permutation
  K-LRT lrt_filter (S=2, nb_controls=1)
                                 f32 LR + margin keep on the [U, 2] sums
  K-CMP compact                  survivors' keys and sums

Only survivor-sized tensors come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch.ops.codec import (
    compact,
    run_flags,
    run_group_sums,
    words_to_keys,
)
from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter


def merge_lrt(keys: torch.Tensor, count: torch.Tensor, ratio_c, ratio_k,
              lr_min):
    """One chunk's merged test (merge_lrt_kernel's packed branch).

    keys [N] int64 (any order), count [N] int16 or int32 packed as
    build_triples_packed packs it. Returns (n_distinct, hit_keys [H]
    int64 ascending, hit_sums [H, 2] int32) with the survivors on the
    keys' device."""
    keys_s, perm = torch.sort(keys)
    flags, n_valid = run_flags(keys_s)
    starts, run_keys = compact(flags, keys_s)
    sums = run_group_sums(starts, n_valid, perm, count)
    keep, _lr, _s_c, _s_k = lrt_filter(sums, 1, ratio_c, ratio_k, lr_min)
    hit, hit_keys = compact(keep, run_keys)
    return starts.numel(), hit_keys, sums[hit]


def pack16_ok(counts_list: list[np.ndarray]) -> bool:
    """True when every count fits the 16-bit packing (value < 2^15)."""
    return all(int(c.max(initial=0)) < (1 << 15) for c in counts_list)


def build_triples_packed(kmers_list: list[np.ndarray],
                         counts_list: list[np.ndarray], nb_controls: int,
                         pack16: bool = False):
    """Host: per-stream sorted (kmers [n, 1] u64, counts [n] u32) -> (keys
    [N] int64, packed counts [N], N). Streams before nb_controls are
    controls: their flag is bit 15 of an int16 (pack16; counts < 2^15,
    see pack16_ok) or the sign bit of an int32. No padding: the device
    takes any N."""
    N = int(sum(len(k) for k in kmers_list))
    keys = np.empty(N, np.int64)
    count = np.empty(N, np.int16 if pack16 else np.int32)
    pos = 0
    for s, (k, c) in enumerate(zip(kmers_list, counts_list)):
        n = len(k)
        if n == 0:
            continue
        keys[pos : pos + n] = words_to_keys(k)
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
