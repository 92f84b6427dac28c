"""k-mer counting: reads -> kmtricks-compatible run directory (port of
kmdiff_tpu/pipeline/count.py, 8 <= k <= 128; one device, or a mesh:
count_sample_device_mesh).

Per sample:

  FASTA/FASTQ(.gz) -> 2-bit codes (files joined by one INVALID separator)
  -> chunks of <= SORT_ROWS windows with k-1 codes of overlap -> per chunk,
  on the device: canonical keys (K-EXT), torch.sort (k > 32: of [nw, N]
  word-major keys, codec.sort_rows), run lengths (K-RUN, in its
  multi-word form for k > 32) -> distinct keys and counts back to the host ->
  native k-way merge of the chunks -> host partition ids and a stable
  regroup -> abundance histogram (before hard-min) -> hard-min -> sorted
  per-partition count files (counts/partition_P/<id>.kmer.lz4).

The run directory is byte-identical to the JAX package's.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import time

import numpy as np
import torch

from kmdiff_tpu_torch import native
from kmdiff_tpu_torch.cmd.options import CountOptions
from kmdiff_tpu_torch.io.kmtricks import (
    Fof,
    count_dtype_for,
    hist_from_counts,
    write_hist,
    write_kmer_file,
)
from kmdiff_tpu_torch.parallel.distributed import barrier, is_primary, owned_samples
from kmdiff_tpu_torch.utils.exceptions import InputError
from kmdiff_tpu_torch.utils.logging import logger
from kmdiff_tpu_torch.core.kmer import n_words
from kmdiff_tpu_torch.ops.codec import INVALID, fused_count, keys_to_words

#: windows per device chunk. A chunk's int64 keys, their sorted copy and
#: the sort's scratch take ~32 bytes a window, so 2^24 windows need ~0.5 GB:
#: a typical bacterial sample counts in one chunk.
SORT_ROWS = (1 << 24) - 128

_HASH_SEED = np.uint32(0x9E3779B9)


def _avalanche_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def host_partition_ids(kmers: np.ndarray, nb_partitions: int) -> np.ndarray:
    """k-mer -> partition: a murmur3 fmix32 chain over the u32 halves of
    each word, mod P (the JAX package's partition hash)."""
    with np.errstate(over="ignore"):
        h = np.full(len(kmers), _HASH_SEED, dtype=np.uint32)
        for w in range(kmers.shape[1]):
            hi = (kmers[:, w] >> np.uint64(32)).astype(np.uint32)
            lo = (kmers[:, w] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            h = _avalanche_np(hi ^ h)
            h = _avalanche_np(lo ^ h)
    return h % np.uint32(nb_partitions)


def _host_code_chunks(all_codes: list[np.ndarray], k: int,
                      sort_rows: int) -> list[np.ndarray]:
    """Join per-file code arrays with one INVALID separator (no window
    spans two files) and cut them into chunks of <= sort_rows windows with
    k-1 codes of overlap, so every window lies in exactly one chunk. No
    padding: the device takes any length."""
    return _code_chunks(_join_codes(all_codes), k, sort_rows)


def _code_chunks(codes, k: int, sort_rows: int) -> list:
    """A joined code array (numpy, or a tensor) cut into views of <=
    sort_rows windows with k-1 codes of overlap."""
    if len(codes) < k:
        return []
    return [codes[s : s + sort_rows + k - 1]
            for s in range(0, len(codes) - k + 1, sort_rows)]


def _merge_streams(streams):
    """Merge k-mer-sorted (kmers, counts) streams, summing the counts of
    equal k-mers (native k-way merge, 64 streams a level; numpy
    sort-reduce where the native library is missing)."""
    if native.available():
        while len(streams) > 64:
            streams = [
                native.merge_counted_streams(
                    [s[0] for s in streams[i : i + 64]],
                    [s[1] for s in streams[i : i + 64]],
                )
                for i in range(0, len(streams), 64)
            ]
        return native.merge_counted_streams(
            [s[0] for s in streams], [s[1] for s in streams]
        )
    kmers = np.concatenate([s[0] for s in streams])
    counts = np.concatenate([s[1] for s in streams])
    order = np.lexsort(tuple(kmers[:, w]
                             for w in range(kmers.shape[1] - 1, -1, -1)))
    kmers, counts = kmers[order], counts[order]
    is_start = np.ones(len(kmers), dtype=bool)
    is_start[1:] = np.any(kmers[1:] != kmers[:-1], axis=1)
    starts = np.flatnonzero(is_start)
    summed = np.add.reduceat(counts.astype(np.uint64), starts).astype(np.uint32)
    return kmers[starts], summed


def _regroup_by_partition(kmers, counts, nb_partitions):
    """Partition ids from the fetched k-mers, then a STABLE regroup by id:
    stability keeps each partition's k-mers sorted, so the output is sorted
    by (partition, k-mer)."""
    parts = host_partition_ids(kmers, nb_partitions)
    if native.available():
        return native.partition_regroup(parts, kmers, counts, nb_partitions)
    order = np.argsort(parts, kind="stable")
    return kmers[order], parts[order], counts[order]


def count_sample_device(all_codes: list[np.ndarray], k: int,
                        nb_partitions: int, device: torch.device):
    """Count one sample's code arrays on `device`. Returns (kmers [U, nw]
    u64 sorted by (part, kmer), parts [U] u32, counts [U] u32)."""
    chunks = _host_code_chunks(all_codes, k, SORT_ROWS)
    if not chunks:
        return (np.zeros((0, n_words(k)), np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint32))
    streams = [fetch_stream(*fused_count(torch.from_numpy(c).to(device), k))
               for c in chunks]
    kmers, counts_h = streams[0] if len(streams) == 1 else _merge_streams(streams)
    return _regroup_by_partition(kmers, counts_h, nb_partitions)


def fetch_stream(keys: torch.Tensor, counts: torch.Tensor):
    """A counted stream on the device (int64 keys [U] or [nw, U], int32
    counts holding u32) -> (kmers [U, nw] u64, counts [U] u32) on the
    host."""
    return (keys_to_words(keys.cpu().numpy()),
            counts.cpu().numpy().view(np.uint32))


def spill_resident_sample(run_dir: str, entry_id: str, sample_idx: int,
                          kmer_size: int, nb_partitions: int, stream) -> None:
    """Write one resident stream (pipeline.fused.ResidentStream, after
    hard-min) as the sample's per-partition count files: the fused run's
    background spill, byte-identical to run_count's files."""
    kmers, counts = fetch_stream(stream.keys, stream.counts)
    kmers, parts, counts = _regroup_by_partition(kmers, counts, nb_partitions)
    write_sample_count_files(run_dir, entry_id, sample_idx, kmer_size,
                             nb_partitions, kmers, parts, counts)


def _join_codes(all_codes: list):
    """The per-file code arrays joined with one INVALID separator: numpy
    arrays on the host, or uint8 tensors on their device (one array is
    returned as it is)."""
    if all_codes and torch.is_tensor(all_codes[0]):
        sep = torch.full((1,), int(INVALID), dtype=torch.uint8,
                         device=all_codes[0].device)
        concatenate = torch.cat
    else:
        sep, concatenate = np.full(1, INVALID, dtype=np.uint8), np.concatenate
    parts = []
    for c in all_codes:
        if parts:
            parts.append(sep)
        parts.append(c)
    if not parts:
        return np.zeros(0, np.uint8)
    return parts[0] if len(parts) == 1 else concatenate(parts)


def count_sample_device_mesh(all_codes: list[np.ndarray], k: int,
                             nb_partitions: int, mesh):
    """Count one sample on a mesh (kmdiff_tpu/pipeline/count.py:379-477):
    the code stream splits into chunks with k-1 codes of overlap, D of them
    a round, each of at most SORT_ROWS windows, so a sample above D x
    SORT_ROWS windows runs in rounds. In each round shard s extracts chunk
    s's k-mers and the counting shuffle (parallel.count_step.count_shards)
    leaves every shard the counted k-mers of the partitions it owns; a
    shard's rounds merge as count_sample_device's chunks do. The shards'
    streams, concatenated in shard order, regroup stably by partition: each
    partition lives on one shard and arrives sorted, so the output, sorted
    by (partition, k-mer), equals count_sample_device's."""
    from kmdiff_tpu_torch.parallel.count_step import count_shards

    D = mesh.size
    codes = _join_codes(all_codes)
    W = len(codes) - k + 1
    if W <= 0:
        return (np.zeros((0, n_words(k)), np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint32))
    n_rounds = -(-W // (D * SORT_ROWS))
    step = -(-W // (D * n_rounds))
    chunks = [codes[s : s + step + k - 1] for s in range(0, W, step)]
    rounds = [chunks[r : r + D] for r in range(0, len(chunks), D)]
    per_shard = [[] for _ in range(D)]
    for chunks_r in rounds:
        for d, stream in enumerate(count_shards(mesh, chunks_r, k,
                                                nb_partitions)):
            per_shard[d].append(fetch_stream(*stream))
    merged = [st[0] if len(st) == 1 else _merge_streams(st)
              for st in per_shard]
    kmers = np.concatenate([m[0] for m in merged])
    counts = np.concatenate([m[1] for m in merged])
    return _regroup_by_partition(kmers, counts, nb_partitions)


def count_sample(paths: list[str], k: int, nb_partitions: int,
                 device: torch.device):
    """Count one sample's distinct canonical k-mers across its read files:
    (kmers sorted by (part, kmer), parts, counts), before hard-min. With a
    mesh (parallel.runtime) the sample's stream shards over it."""
    from kmdiff_tpu_torch.io.fasta import flat_codes
    from kmdiff_tpu_torch.parallel.runtime import get_mesh

    all_codes = [c for c in (flat_codes(p) for p in paths) if len(c)]
    mesh = get_mesh(device)
    if mesh.size > 1:  # K-PART and the exchange are waste on one shard
        return count_sample_device_mesh(all_codes, k, nb_partitions, mesh)
    return count_sample_device(all_codes, k, nb_partitions, device)


def write_sample_count_files(
    run_dir: str, entry_id: str, sample_idx: int, kmer_size: int,
    nb_partitions: int, kmers: np.ndarray, parts: np.ndarray,
    counts: np.ndarray,
) -> None:
    """One sample's per-partition .kmer.lz4 count files (after hard-min,
    sorted by (part, kmer))."""
    cbytes = count_dtype_for(int(counts.max()) if len(counts) else 1)().itemsize
    bounds = np.searchsorted(parts, np.arange(nb_partitions + 1))
    for p in range(nb_partitions):
        lo_i, hi_i = bounds[p], bounds[p + 1]
        write_kmer_file(
            os.path.join(
                run_dir, "counts", f"partition_{p}", f"{entry_id}.kmer.lz4"
            ),
            kmers[lo_i:hi_i],
            counts[lo_i:hi_i],
            kmer_size,
            sample_idx=sample_idx,
            partition=p,
            count_bytes=cbytes,
        )


def run_count(opt: CountOptions, device: torch.device) -> None:
    """Build the run directory (reference: kmtricks pipeline ... --until
    count --hist). As in the reference's count stage, --recurrence-min is
    accepted but not applied.

    Under the multi-process runtime (parallel.distributed) each rank counts
    its round-robin share of the samples into the shared run directory,
    the primary copies the fof, and every rank waits for the others
    (barrier "count_done") before it returns."""
    fof = Fof.parse(opt.fof)
    if not fof.entries:
        raise InputError(f"{opt.fof}: empty fof")
    fof_dir = os.path.dirname(os.path.abspath(opt.fof))

    nb_partitions = opt.nb_partitions or 4
    run_dir = opt.directory
    os.makedirs(os.path.join(run_dir, "histograms"), exist_ok=True)
    for p in range(nb_partitions):
        os.makedirs(
            os.path.join(run_dir, "counts", f"partition_{p}"), exist_ok=True
        )
    if is_primary():
        shutil.copyfile(opt.fof, os.path.join(run_dir, "kmtricks.fof"))

    def one_sample(i: int) -> int:
        entry = fof.entries[i]
        paths = [
            p if os.path.isabs(p) else os.path.join(fof_dir, p)
            for p in entry.paths
        ]
        t0 = time.perf_counter()
        kmers, parts, counts = count_sample(paths, opt.kmer_size,
                                            nb_partitions, device)
        t_count = time.perf_counter() - t0
        t0 = time.perf_counter()

        # histogram BEFORE hard-min: totals subtract low-abundance mass
        # downstream exactly like the reference
        hist = hist_from_counts(counts, i, opt.kmer_size)
        write_hist(
            os.path.join(run_dir, "histograms", f"{entry.id}.hist"), hist
        )

        hard_min = entry.ab_min or opt.hard_min
        if hard_min > 1:
            keep = counts >= hard_min
            kmers, parts, counts_f = kmers[keep], parts[keep], counts[keep]
        else:
            counts_f = counts
        write_sample_count_files(
            run_dir, entry.id, i, opt.kmer_size, nb_partitions,
            kmers, parts, counts_f,
        )
        logger.info(
            "[%s] %d distinct k-mers (%d after hard-min=%d; count+fetch "
            "%.1fs, hist+spill %.1fs).",
            entry.id, len(counts), len(counts_f), hard_min,
            t_count, time.perf_counter() - t0,
        )
        return len(counts_f)

    # samples on host threads: file parsing and spills overlap, the
    # device work queues on one stream
    mine = owned_samples(len(fof.entries))
    with cf.ThreadPoolExecutor(max(1, opt.nb_threads)) as pool:
        list(pool.map(one_sample, mine))
    barrier("count_done")
    logger.info(
        "Counted %d/%d samples, %d partitions, k=%d.",
        len(mine), len(fof.entries), nb_partitions, opt.kmer_size,
    )
