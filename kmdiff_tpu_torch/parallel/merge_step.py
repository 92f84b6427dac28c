"""The mesh merge (port of kmdiff_tpu/parallel/merge_step.py).

A merge chunk's sorted per-sample streams split at k-mer key ranges, one a
shard, ascending (free on the host: every stream is sorted, and a range
bound on the first word never splits a k-mer). Each shard builds its
range's keys and packed counts, ships them to its device and runs the
whole merge there (PartitionProcessor.compute_chunk: merge_dev.merge_lrt,
or merge_lrt_full for popstrat, --save-sk and wide cohorts); only its
survivors come back. The ranges are independent, so nothing passes
between shards. The JAX package's psum of the counters becomes a host sum
over the shards, and gather_row_sharded's ascending-range gather a
concatenation in shard order: the chunk's survivors, geno rows and
--save-sk rows then reach the accumulators as one block, in the order of
one device (popstrat corrects a block at a time).

Left out, as the TPU's static shapes: the pow2 range capacity, max_hits and
max_geno with their overflow retries, and the row-sharded placement.
"""

from __future__ import annotations

import numpy as np

from kmdiff_tpu_torch.parallel.mesh import Mesh


def key_ranges(kmers_list: list[np.ndarray], counts_list: list[np.ndarray],
               n: int) -> list[tuple[list, list]]:
    """Split sorted per-sample streams into at most n ascending,
    key-disjoint ranges at first-word quantiles (merge_dev.
    quantile_key_split; equal quantiles merge, so there may be fewer):
    [(kmers per sample, counts per sample)] in key order."""
    from kmdiff_tpu_torch.ops.merge_dev import quantile_key_split

    split = (quantile_key_split(kmers_list, n, lambda _r: float("inf"),
                                grow=False, attempts=1)
             if n > 1 and any(len(k) for k in kmers_list) else None)
    if split is None:
        return [(kmers_list, counts_list)]
    return [([km[a:b] for (a, b), km in zip(per_sample, kmers_list)],
             [ct[a:b] for (a, b), ct in zip(per_sample, counts_list)])
            for per_sample in split[1]]


def merge_shards(mesh: Mesh, processor, kmers_list, counts_list, nbc: int):
    """One merge chunk over the mesh: range d on shard d, every range at
    once -> the chunk's ChunkOut (pipeline.merge), the shards' parts
    concatenated in ascending key-range order."""
    from kmdiff_tpu_torch.pipeline.merge import ChunkOut

    ranges = key_ranges(kmers_list, counts_list, mesh.size)
    return ChunkOut.concat(mesh.map(lambda d, dev: processor.merge_host_chunk(
        *ranges[d], nbc, dev), len(ranges)))
