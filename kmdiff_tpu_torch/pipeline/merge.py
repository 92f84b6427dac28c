"""Partition merge + differential test (port of kmdiff_tpu/pipeline/merge.py:
the Poisson model's device merge, the matrix path's block filter, and the
partition thread pool).

* Count files (the default input): a partition's S sorted per-sample
  streams are pre-summed on the host into one control and one case stream
  (native k-way merge), shipped to the device as int64 keys plus packed
  counts, and merged and filtered there (ops.merge_dev.merge_lrt).
  Partitions above MAX_DEVICE_ROWS stream through in key-range chunks;
  each chunk is complete because every stream is sorted.
* Popstrat and --save-sk need each survivor's per-sample counts, and
  popstrat the sampled geno rows; a cohort whose k-mer mass reaches 2^31
  (LrtParams.wide_sums) needs group sums past int32. The S streams then
  ship unsummed, as raw u32 counts with each row's sample id, and merge
  through ops.merge_dev.merge_lrt_full, whose group sums are int64.
* Prebuilt count matrices: [B, S] row blocks go through K-LRT
  (ops.lrt.run_filter) in BLOCK_ROWS tiles; a wide cohort's are scored on
  the host, in int64 sums and f64, as the JAX package scores them.
* Chunks already on the device (the fused run's key-range chunks,
  pipeline.fused) enter at PartitionProcessor.compute_chunk, where the
  count-file path's chunks end too; push_chunk hands the survivors on.
* On a mesh (parallel.runtime, --devices N) a partition's chunks hold up
  to N x MAX_DEVICE_ROWS rows, and each chunk's N key ranges merge at
  once, one a shard (parallel.merge_step); a prebuilt matrix's tiles are
  filtered N at once, one a shard. One shard is a mesh of one.

Either way the small survivor set is rescored in exact f64 on the host
(core.model), which reproduces kmdiff's p-values.

* Custom models (plugins): no device merge and no K-LRT. Each partition's
  S streams are union-merged on the host into a dense [U, S] matrix
  (merge_sorted_streams) that the model scores whole, through the first
  ABI it has (plugins.block_abi): process_block_torch on int32 tiles of at
  most BLOCK_ROWS rows on the device, numpy process_block, or the scalar
  process in a loop. Prebuilt matrices take the same scoring.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import threading

import numpy as np
import torch

from kmdiff_tpu_torch import profiling
from kmdiff_tpu_torch.core.model import IModel, PoissonLikelihood, Significance
from kmdiff_tpu_torch.io.accumulator import IAccumulator, KmerSignBlock
from kmdiff_tpu_torch.io.kmtricks import read_kmer_file
from kmdiff_tpu_torch.pipeline.popstrat import sample_mask
from kmdiff_tpu_torch.plugins import block_abi
from kmdiff_tpu_torch.utils.logging import logger
from kmdiff_tpu_torch.ops.codec import keys_to_words
from kmdiff_tpu_torch.ops.lrt import LrtParams, run_filter

#: tile height of the matrix path and of process_block_torch
BLOCK_ROWS = 1 << 17

#: max rows per device merge; larger partitions stream through in
#: key-range chunks
MAX_DEVICE_ROWS = 1 << 23


def merge_sorted_streams(
    kmers_list: list[np.ndarray],
    counts_list: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Union-merge S sorted (kmers, counts) streams into a dense count matrix.

    Replaces the kmtricks KmerMerger heap walk (reference: merge.hpp:265-266
    with ab_mins=1, recurrence_min=1 — i.e. the plain union) with one
    vectorized pass:

      concat -> lexsort by packed words -> run-boundary flags -> row ids ->
      scatter counts into [U, S]

    Returns (kmers [U, n_words] uint64 ascending, counts [U, S] uint32).
    """
    S = len(kmers_list)
    nw = kmers_list[0].shape[1] if kmers_list else 1
    sizes = [len(k) for k in kmers_list]
    N = int(np.sum(sizes))
    if N == 0:
        return np.zeros((0, nw), dtype=np.uint64), np.zeros((0, S), dtype=np.uint32)

    all_kmers = np.concatenate(kmers_list, axis=0)
    all_counts = np.concatenate(counts_list, axis=0)
    sample_idx = np.repeat(np.arange(S, dtype=np.int32), sizes)

    # lexicographic order over words (word 0 major). Views the row bytes as
    # big-endian so a single void-dtype argsort handles any word count.
    if all_kmers.shape[1] == 1:
        order = np.argsort(all_kmers[:, 0], kind="stable")
    else:
        keys = np.ascontiguousarray(all_kmers.astype(">u8"))
        order = np.argsort(keys.view(f"V{nw * 8}").ravel(), kind="stable")

    sk = all_kmers[order]
    new_row = np.empty(N, dtype=bool)
    new_row[0] = True
    np.any(sk[1:] != sk[:-1], axis=1, out=new_row[1:])
    row_id = np.cumsum(new_row) - 1
    U = int(row_id[-1]) + 1

    counts = np.zeros((U, S), dtype=np.uint32)
    counts[row_id, sample_idx[order]] = all_counts[order]
    return sk[new_row], counts


@dataclasses.dataclass
class ChunkOut:
    """One merged chunk on the host (PartitionProcessor.compute_chunk): its
    distinct k-mers, the filter's survivors (kmers [H, nw] u64, exact int64
    group sums), their count rows [H, S] int32 holding u32 (or None) and
    the sampled geno rows [G, S] u8 (or None)."""
    n_distinct: int
    hit_kmers: np.ndarray
    s_c: np.ndarray
    s_k: np.ndarray
    rows: np.ndarray | None
    geno: np.ndarray | None

    @staticmethod
    def concat(outs: list[ChunkOut]) -> ChunkOut:
        """Key-disjoint parts of one chunk, in ascending key order, as the
        one chunk they make up (the distinct counts summed)."""
        if len(outs) == 1:
            return outs[0]

        def cat(name):
            parts = [getattr(o, name) for o in outs]
            return None if parts[0] is None else np.concatenate(parts)

        return ChunkOut(sum(o.n_distinct for o in outs), cat("hit_kmers"),
                        cat("s_c"), cat("s_k"), cat("rows"), cat("geno"))


@dataclasses.dataclass
class PartitionResult:
    partition: int
    total_kmers: int
    nb_sign: int
    sign_controls: int
    sign_cases: int


class PartitionProcessor:
    """Runs one partition: load -> merge + filter on `device` -> exact
    rescore -> accumulate (reference observer: merge.hpp:68-103); a custom
    model's partition: load -> host union merge -> the model's scores.

    Its stages are spans (profiling.span): a partition of files is
    ``kmd:partition``; in it the files' decode ``kmd:decode``, the host
    group pre-sum ``kmd:groupsum``, a chunk's keys and packed counts
    ``kmd:build``, their copy to the device ``kmd:h2d``, and the device
    merge with its survivors' way back ``kmd:device`` (a fused run's chunks
    too); a custom model's union merge ``kmd:union`` and scores
    ``kmd:score``."""

    def __init__(self, model: IModel, nb_controls: int, nb_cases: int,
                 threshold: float, device: torch.device,
                 keep_counts: bool = False, sampler=None,
                 save_matrix_path: str | None = None):
        """keep_counts: survivors carry their count rows (popstrat);
        sampler: a popstrat GenoSampler that receives each partition's
        sampled geno rows; save_matrix_path: --save-sk's directory. A model
        other than PoissonLikelihood needs a block ABI (plugins.block_abi:
        PluginError without one)."""
        self.model = model
        self.nb_controls = nb_controls
        self.nb_cases = nb_cases
        self.threshold = threshold
        self.device = device
        self.keep_counts = keep_counts
        self.sampler = sampler
        self.save_matrix_path = save_matrix_path
        self.want_rows = keep_counts or save_matrix_path is not None
        if isinstance(model, PoissonLikelihood):
            self.abi = None
            self.params = LrtParams(nb_controls, nb_cases, model.sum_controls,
                                    model.sum_cases, threshold)
            # the full merge: per-sample streams with sample ids and raw
            # counts, int64 group sums; no host group pre-sum, no packing
            self.full = (self.want_rows or sampler is not None
                         or self.params.wide_sums)
        else:
            self.abi = block_abi(model)
            self.params = None
            self.full = False
            self._warned_scalar = False

    # -- block scoring (matrix path, custom models) ---------------------------

    def _score_block(self, kmers: np.ndarray, counts: np.ndarray):
        """Score [B, S] rows; returns (survivor KmerSignBlock, survivor row
        indices, control and case tallies). Poisson: K-LRT in BLOCK_ROWS
        tiles, the kept rows rescored in f64; a wide cohort's rows, whose
        group sums may pass int32, take exact int64 sums and f64 p-values
        on the host, with no device (kmdiff_tpu/pipeline/merge.py:206-215).
        A custom model scores every row (_plugin_scores)."""
        if self.params is None:
            idx = np.arange(len(counts))
            p, sg, mc, mk = self._plugin_scores(counts)
        elif self.params.wide_sums:
            idx = np.arange(len(counts))
            s_c = counts[:, : self.nb_controls].sum(axis=1, dtype=np.int64)
            s_k = counts[:, self.nb_controls :].sum(axis=1, dtype=np.int64)
        else:
            from kmdiff_tpu_torch.parallel.runtime import get_mesh

            keep = np.zeros(len(counts), dtype=bool)
            s_c = np.zeros(len(counts), dtype=np.int64)
            s_k = np.zeros(len(counts), dtype=np.int64)
            # D tiles at once on a mesh, tile lo + d * BLOCK_ROWS on shard d
            mesh = get_mesh(self.device)
            tile = BLOCK_ROWS * mesh.size
            for lo in range(0, len(counts), tile):
                hi = min(len(counts), lo + tile)
                tiles = [(a, min(hi, a + BLOCK_ROWS))
                         for a in range(lo, hi, BLOCK_ROWS)]
                parts = mesh.map(lambda d, dev: run_filter(
                    self.params, counts[slice(*tiles[d])], dev), len(tiles))
                k, sc, sk = (np.concatenate(x) for x in zip(*parts))
                keep[lo:hi], s_c[lo:hi], s_k[lo:hi] = k, sc, sk
            idx = np.nonzero(keep)[0]
            s_c, s_k = s_c[idx], s_k[idx]
        if self.params is not None:
            p, sg, mc, mk = self.model.process_sums(s_c, s_k)
        final = p <= self.threshold
        idx = idx[final]
        block = KmerSignBlock(
            kmers[idx],
            np.asarray(p[final], dtype=np.float64),
            np.asarray(sg[final], dtype=np.int8),
            np.asarray(mc[final], dtype=np.float64),
            np.asarray(mk[final], dtype=np.float64),
            counts[idx].astype(np.float64) if self.keep_counts else None,
        )
        n_ctrl = int(np.sum(block.signs == int(Significance.CONTROL)))
        return block, idx, n_ctrl, len(block) - n_ctrl

    def _plugin_scores(self, counts: np.ndarray):
        """A custom model's (p, sign, mean_control, mean_case) for every row
        of [B, S] u32 counts, through its ABI (kmdiff_tpu/pipeline/
        merge.py:243-321)."""
        if self.abi == "torch":
            return self._torch_block_scores(counts)
        if self.abi == "numpy":
            return self.model.process_block(counts, self.nb_controls)
        if len(counts) > 1_000_000 and not self._warned_scalar:
            logger.warning(
                "custom model %s only implements the scalar process() ABI; "
                "scoring %d rows via the per-row loop. Implement "
                "process_block (numpy) or process_block_torch (device) for "
                "large cohorts.", type(self.model).__name__, len(counts),
            )
            self._warned_scalar = True
        return IModel.process_block(self.model, counts, self.nb_controls)

    def _torch_block_scores(self, counts: np.ndarray):
        """process_block_torch over int32 tiles of at most BLOCK_ROWS rows
        (the u32 counts' bit patterns, kmdiff_tpu/pipeline/merge.py:278; the
        last tile unpadded) on the processor's device. A tile's four outputs
        are stacked in the JAX package's dtype, result_type(p, mean_control,
        mean_case, float32), and read back in one copy; the rest is f64 on
        the host."""
        B = counts.shape[0]
        p, mc, mk = np.empty(B), np.empty(B), np.empty(B)
        sg = np.empty(B, dtype=np.int8)
        counts_i32 = counts.view(np.int32)
        for lo in range(0, B, BLOCK_ROWS):
            hi = min(B, lo + BLOCK_ROWS)
            tp, tsg, tmc, tmk = self.model.process_block_torch(
                self._stage(counts_i32[lo:hi]), self.nb_controls)
            dt = functools.reduce(torch.promote_types,
                                  (tmc.dtype, tmk.dtype, torch.float32), tp.dtype)
            out = torch.stack([tp.to(dt), tsg.to(dt), tmc.to(dt),
                               tmk.to(dt)]).cpu().numpy()
            p[lo:hi], mc[lo:hi], mk[lo:hi] = out[0], out[2], out[3]
            sg[lo:hi] = out[1].astype(np.int8)
        return p, sg, mc, mk

    def _stage(self, rows: np.ndarray) -> torch.Tensor:
        """One tile's rows on the processor's device. On CUDA they go
        through page-locked memory from PyTorch's caching host allocator,
        which hands a block out again only after every copy queued from it
        has ended, so threads that score partitions at once never overwrite
        a tile still in flight."""
        rows = np.ascontiguousarray(rows)
        if self.device.type != "cuda":
            return torch.from_numpy(rows)
        pinned = torch.empty(rows.shape, dtype=torch.int32, pin_memory=True)
        pinned.numpy()[...] = rows
        return pinned.to(self.device, non_blocking=True)

    def write_matrix_sink(self, partition, sink, kmer_size, S):
        """--save-sk: one partition's survivors' count matrix from its
        (kmers, count rows) parts (the reference writes only k-mers that
        pass the merge, merge.hpp:83-87)."""
        from kmdiff_tpu_torch.core.kmer import n_words
        from kmdiff_tpu_torch.io.kmtricks import write_matrix_file

        if sink:
            km = np.concatenate([m[0] for m in sink])
            ct = np.concatenate([m[1] for m in sink])
        else:
            km = np.zeros((0, n_words(kmer_size)), np.uint64)
            ct = np.zeros((0, S), np.uint32)
        write_matrix_file(
            f"{self.save_matrix_path}/matrix_{partition}.count.lz4",
            km, ct.astype(np.uint32), kmer_size, partition,
        )

    def new_sinks(self) -> tuple[list | None, list | None]:
        """One partition's empty (geno rows, --save-sk rows) sinks, None
        for what is not wanted; push_chunk fills them."""
        return ([] if self.sampler is not None else None,
                [] if self.save_matrix_path is not None else None)

    def flush_sinks(self, partition, geno_sink, matrix_sink, kmer_size, S):
        """Hand one partition's collected rows on, once: the geno rows to
        the sampler (which keeps one set of rows a partition), the
        --save-sk rows to the partition's matrix."""
        if geno_sink is not None:
            self.sampler.add_sampled(partition, (
                np.concatenate(geno_sink) if geno_sink
                else np.zeros((0, S), np.uint8)))
        if matrix_sink is not None:
            self.write_matrix_sink(partition, matrix_sink, kmer_size, S)

    # -- partition entry points ----------------------------------------------

    def process_files(self, partition: int, paths: list[str],
                      acc: IAccumulator) -> PartitionResult:
        with profiling.span("kmd:partition"):
            kmers_list, counts_list, ksize = [], [], 0
            with profiling.span("kmd:decode"):
                for path in paths:
                    info, kmers, counts = read_kmer_file(path)
                    ksize = info.kmer_size
                    kmers_list.append(kmers)
                    counts_list.append(counts)
            if self.params is not None:
                return self._process_device_merge(partition, kmers_list,
                                                  counts_list, acc, ksize)
            with profiling.span("kmd:union"):
                kmers, counts = merge_sorted_streams(kmers_list, counts_list)
            with profiling.span("kmd:score"):
                return self.process_arrays(partition, kmers, counts, acc, ksize)

    def process_arrays(self, partition: int, kmers: np.ndarray,
                       counts: np.ndarray, acc: IAccumulator,
                       kmer_size: int = 0) -> PartitionResult:
        """Score one partition's merged rows (kmers [U, nw], counts [U, S]:
        merge_sorted_streams' union) as one block."""
        return self._process_blocks(partition, [(kmers, counts)], acc,
                                    kmer_size, counts.shape[1])

    def process_matrix(self, partition: int, path: str,
                       acc: IAccumulator) -> PartitionResult:
        """Stream a prebuilt count matrix in bounded row blocks (rows are
        already merged, one distinct k-mer each)."""
        from kmdiff_tpu_torch.io.kmtricks import open_matrix_stream

        info, blocks = open_matrix_stream(path)
        return self._process_blocks(partition, blocks, acc, info.kmer_size,
                                    info.count_slots)

    def _process_blocks(self, partition, blocks, acc, kmer_size: int,
                        S: int) -> PartitionResult:
        """Score (kmers, counts) row blocks of merged rows; sampled geno
        rows and --save-sk survivors collect across blocks."""
        total = nsign = n_ctrl = n_case = 0
        geno_sink, sink = self.new_sinks()
        for kmers, counts in blocks:
            if geno_sink is not None:
                mask = sample_mask(kmers, self.sampler.rate, self.sampler.seed)
                geno_sink.append((counts[mask] > 0).astype(np.uint8))
            block, idx, nc, nk = self._score_block(kmers, counts)
            if sink is not None:
                sink.append((kmers[idx], counts[idx]))
            acc.push_block(block)
            total += len(counts)
            nsign += len(block)
            n_ctrl += nc
            n_case += nk
        self.flush_sinks(partition, geno_sink, sink if kmer_size else None,
                         kmer_size, S)
        acc.finish()
        return PartitionResult(partition, total, nsign, n_ctrl, n_case)

    def _process_device_merge(self, partition, kmers_list, counts_list,
                              acc, ksize: int = 0) -> PartitionResult:
        """Pre-sum the groups on the host (unless the merge is full), then
        merge on the device, in key-range chunks above MAX_DEVICE_ROWS."""
        nbc = self.nb_controls
        if not self.full and 1 <= nbc < len(kmers_list) and len(kmers_list) > 2:
            # the test reads only per-GROUP sums (model.hpp:145-146), so the
            # controls and the cases each merge into one stream first
            # (exact integer sums): the device then sorts ~2 rows per
            # distinct k-mer instead of one per carrying sample
            from kmdiff_tpu_torch.pipeline.count import _merge_streams

            with profiling.span("kmd:groupsum"):
                ctrl = _merge_streams(list(zip(kmers_list[:nbc], counts_list[:nbc])))
                case = _merge_streams(list(zip(kmers_list[nbc:], counts_list[nbc:])))
            kmers_list = [ctrl[0], case[0]]
            counts_list = [ctrl[1], case[1]]
            nbc = 1
        from kmdiff_tpu_torch.parallel.merge_step import merge_shards
        from kmdiff_tpu_torch.parallel.runtime import get_mesh

        mesh = get_mesh(self.device)
        # a mesh merges D key ranges of a chunk at once, one a shard
        budget = MAX_DEVICE_ROWS * mesh.size
        if sum(len(k) for k in kmers_list) > budget:
            chunks = self._key_range_chunks(kmers_list, counts_list, budget)
        else:
            chunks = [(kmers_list, counts_list)]
        # the chunks' geno and --save-sk rows go on once for the partition
        geno_sink, matrix_sink = self.new_sinks()
        results = []
        for sub_k, sub_c in chunks:
            out = merge_shards(mesh, self, sub_k, sub_c, nbc)
            results.append(self.push_chunk(partition, out, acc, geno_sink,
                                           matrix_sink))
        self.flush_sinks(partition, geno_sink, matrix_sink, ksize,
                         len(kmers_list))
        acc.finish()
        return PartitionResult(
            partition,
            sum(r.total_kmers for r in results),
            sum(r.nb_sign for r in results),
            sum(r.sign_controls for r in results),
            sum(r.sign_cases for r in results),
        )

    @staticmethod
    def _key_range_chunks(kmers_list, counts_list, budget: int):
        """Split a partition at common k-mer boundaries into chunks of
        about 7/8 of budget rows, in key order. Quantile splitters are
        approximate, so the chunk count doubles on overshoot (bounded
        retries; an over-budget chunk is still merged whole)."""
        from kmdiff_tpu_torch.ops.merge_dev import quantile_key_split

        N_real = sum(len(k) for k in kmers_list)
        n_chunks = max(2, -(-N_real // max(1, (budget * 7) // 8)))
        _bounds, chunk_slices, _R = quantile_key_split(
            kmers_list, n_chunks, lambda _r: budget,
            grow=True, attempts=4, best_effort=True,
        )
        return [([km[a:b] for (a, b), km in zip(per_sample, kmers_list)],
                 [ct[a:b] for (a, b), ct in zip(per_sample, counts_list)])
                for per_sample in chunk_slices]

    def merge_host_chunk(self, kmers_list, counts_list, nbc,
                         device: torch.device) -> ChunkOut:
        """Pack one chunk's host streams into keys and packed counts (the
        full merge: raw counts and sample ids), ship them to `device` and
        merge them there (compute_chunk)."""
        from kmdiff_tpu_torch.ops.merge_dev import (
            build_triples,
            build_triples_packed,
            pack16_ok,
        )

        sample = None
        with profiling.span("kmd:build"):
            if self.full:
                keys, count, sample, _N = build_triples(kmers_list, counts_list)
            else:
                keys, count, _N = build_triples_packed(
                    kmers_list, counts_list, nbc, pack16=pack16_ok(counts_list)
                )
        with profiling.span("kmd:h2d"):
            keys = torch.from_numpy(keys).to(device)
            count = torch.from_numpy(count).to(device)
            if sample is not None:
                sample = torch.from_numpy(sample).to(device)
        return self.compute_chunk(keys, count, sample)

    def compute_chunk(self, keys: torch.Tensor, count: torch.Tensor,
                      sample: torch.Tensor | None = None) -> ChunkOut:
        """keys [N] int64 (or [nw, N]) and packed counts [N]
        (merge_dev.build_triples_packed's packing) on one device -> merge and
        filter there (merge_dev.merge_lrt); the survivors, their sums and
        the distinct count come back to the host.

        With sample ids [N] int16 (and raw counts: merge_dev.build_triples)
        the chunk merges through merge_dev.merge_lrt_full, whose group sums
        are int64 (wide cohorts take this branch), and the survivors' count
        rows (want_rows) and the sampled geno rows (a sampler) come back
        too. Touches no accumulator or sink, so the shards of a mesh run it
        at once (parallel.merge_step)."""
        from kmdiff_tpu_torch.ops.merge_dev import (
            merge_lrt,
            merge_lrt_full,
            pca_threshold_u32,
        )

        with profiling.span("kmd:device"):
            rows = geno = None
            if sample is None:
                n_distinct, hit_keys, hit_sums = merge_lrt(
                    keys, count, self.params.ratio_c, self.params.ratio_k,
                    self.params.lr_min,
                )
            else:
                sampler = self.sampler
                n_distinct, hit_keys, hit_sums, rows, geno = merge_lrt_full(
                    keys, count, sample, self.nb_controls + self.nb_cases,
                    self.nb_controls, self.params.ratio_c, self.params.ratio_k, self.params.lr_min,
                    want_rows=self.want_rows, want_geno=sampler is not None,
                    pca_thr=pca_threshold_u32(sampler.rate) if sampler else 0,
                    pca_seed=sampler.seed if sampler else 0,
                )
            hit_kmers, s_c, s_k = self._unpack_blob(hit_keys, hit_sums)
            rows = None if rows is None else rows.cpu().numpy()
            geno = None if geno is None else geno.cpu().numpy()
        return ChunkOut(n_distinct, hit_kmers, s_c, s_k, rows, geno)

    def push_chunk(self, partition, out: ChunkOut, acc,
                   geno_sink: list | None = None,
                   matrix_sink: list | None = None) -> PartitionResult:
        """Rescore a chunk's survivors in f64 on the host and push them to
        acc; the caller finishes acc. Survivors carry their count rows when
        keep_counts, their --save-sk rows go to matrix_sink and the sampled
        geno rows to geno_sink (new_sinks; the caller hands them on with
        flush_sinks)."""
        hit_kmers, s_c, s_k = out.hit_kmers, out.s_c, out.s_k
        p, sg, mc, mk = self.model.process_sums(s_c, s_k)
        final = p <= self.threshold
        counts_rows = None
        if out.rows is not None:
            rows_i32 = out.rows[final]
            if self.keep_counts:
                # u32 bit patterns in int32 slots: view back before widening
                counts_rows = rows_i32.view(np.uint32).astype(np.float64)
            if matrix_sink is not None:
                matrix_sink.append((hit_kmers[final], rows_i32))
        if out.geno is not None:
            geno_sink.append(out.geno)
        block = KmerSignBlock(
            hit_kmers[final],
            np.asarray(p[final], dtype=np.float64),
            np.asarray(sg[final], dtype=np.int8),
            np.asarray(mc[final], dtype=np.float64),
            np.asarray(mk[final], dtype=np.float64),
            counts_rows,
        )
        acc.push_block(block)
        n_ctrl = int(np.sum(block.signs == int(Significance.CONTROL)))
        return PartitionResult(partition, out.n_distinct, len(block), n_ctrl,
                               len(block) - n_ctrl)

    # -- device dispatch -----------------------------------------------------

    @staticmethod
    def _unpack_blob(hit_keys: torch.Tensor, hit_sums: torch.Tensor):
        """Survivors on the device (keys [H] or [nw, H]) -> (kmers [H, nw]
        u64, s_c, s_k exact int64) on the host; the sums int32 (packed merge) or int64 (full
        merge)."""
        sums = hit_sums.cpu().numpy().astype(np.int64)
        return keys_to_words(hit_keys.cpu().numpy()), sums[:, 0], sums[:, 1]


class GlobalMerge:
    """All-partition merge (reference: merge.hpp:209-432 global_merge):
    partitions run on a host thread pool, so file decoding and the host
    pre-sum overlap the device work, which queues on one stream."""

    def __init__(self, processor: PartitionProcessor,
                 accumulators: list[IAccumulator], nb_threads: int = 4,
                 progress=None):
        self.processor = processor
        self.accs = accumulators
        self.nb_threads = max(1, nb_threads)
        self.progress = progress
        self.results: list[PartitionResult] = []

    def _run(self, jobs) -> list[PartitionResult]:
        results: list[PartitionResult | None] = [None] * len(jobs)
        lock = threading.Lock()

        def task(i, fn):
            r = fn()
            with lock:
                results[i] = r
                if self.progress is not None:
                    self.progress.tick()
            return r

        if self.nb_threads == 1:
            for i, fn in enumerate(jobs):
                task(i, fn)
        else:
            with cf.ThreadPoolExecutor(self.nb_threads) as pool:
                futs = [pool.submit(task, i, fn) for i, fn in enumerate(jobs)]
                for f in futs:
                    f.result()  # re-raise worker exceptions
        self.results = results  # type: ignore[assignment]
        return self.results

    def merge_partitions(self, partition_paths: list[list[str]],
                         only: list[int] | None = None) -> int:
        """Merge every partition, or the `only` ones (a rank's share under
        the multi-process runtime); results and counters cover those."""
        sel = range(len(partition_paths)) if only is None else only
        self._run([
            (lambda p=p: self.processor.process_files(
                p, partition_paths[p], self.accs[p]))
            for p in sel
        ])
        return self.total_kmers()

    def merge_matrices(self, matrix_paths: list[str],
                       only: list[int] | None = None) -> int:
        sel = range(len(matrix_paths)) if only is None else only
        self._run([
            (lambda p=p: self.processor.process_matrix(
                p, matrix_paths[p], self.accs[p]))
            for p in sel
        ])
        return self.total_kmers()

    def total_kmers(self) -> int:
        return sum(r.total_kmers for r in self.results)

    def nb_sign(self) -> int:
        return sum(r.nb_sign for r in self.results)

    def signs(self) -> tuple[int, int]:
        return (
            sum(r.sign_controls for r in self.results),
            sum(r.sign_cases for r in self.results),
        )
