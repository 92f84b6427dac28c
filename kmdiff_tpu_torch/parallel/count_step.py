"""The mesh counting shuffle (port of kmdiff_tpu/parallel/count_step.py).

Every shard extracts the canonical k-mers of its code chunk, and each
k-mer's count must end on the shard that owns its partition (part % D).
The JAX package buckets the rows into fixed-capacity lanes and exchanges
them with one all_to_all over the ICI; here:

  on shard s   K-PART partition_targets -> each row's owner shard d and
               the rows a shard gets; a stable torch.sort of the targets
               packs each bucket contiguously
  exchange     bucket d of shard s is copied to shard d's device
               (non_blocking; on the current streams, which PyTorch orders
               across the two cards), the buckets concatenated in shard
               order s = 0, 1, ...
  on shard d   the received rows sorted and run-length encoded
               (count_shards: torch.sort + K-RUN, codec.sort_rle) or sorted
               by (key, sample, count) (count_regroup)

Left out, as the TPU's static shapes: the bucket capacity and its overflow
counter, and the sentinel padding of the received streams (a shard keeps
exactly its rows; sentinel rows, target D, are dropped at the sender).
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch.ops.codec import (
    canonical_kmers,
    partition_targets,
    sort_keys,
    sort_rle,
)
from kmdiff_tpu_torch.parallel.mesh import Mesh


def bucket_by_shard(keys: torch.Tensor, payloads, nb_partitions: int,
                    n_shards: int):
    """One shard's rows -> per owner shard d < n_shards, (keys, *payloads)
    of the rows d owns (K-PART, then a stable sort of the targets); the
    sentinel rows go nowhere."""
    targets, counts = partition_targets(keys, nb_partitions, n_shards)
    order = torch.sort(targets, stable=True).indices
    sizes = counts.tolist()
    parts = [keys[..., order].split(sizes, -1)]
    parts += [p[order].split(sizes) for p in payloads]
    return [tuple(p[d] for p in parts) for d in range(n_shards)]


def exchange(mesh: Mesh, buckets):
    """buckets[s][d] (tensors on shard s) -> receive(d, device), which
    copies bucket d of every shard to shard d's device and concatenates
    them in shard order, each tensor along its last axis; called on shard
    d's thread (Mesh.map)."""

    def receive(d: int, dev: torch.device):
        parts = [tuple(t.to(dev, non_blocking=True) for t in buckets[s][d])
                 for s in range(mesh.size)]
        return tuple(torch.cat(col, -1) for col in zip(*parts))

    return receive


def count_regroup(mesh: Mesh, keys, sample, count, nb_partitions: int):
    """The counting shuffle on (key, sample, count) rows
    (make_sharded_count_regroup): keys [L_s] int64 or [nw, L_s], sample and
    count [L_s] int32 on each shard s (lists in shard order; sentinel keys
    are padding) -> per shard d, the rows it owns, (keys, sample, count)
    sorted by (key, sample, count), on d's device."""
    D = mesh.size
    buckets = mesh.map(lambda s, dev: bucket_by_shard(
        keys[s], (sample[s], count[s]), nb_partitions, D))
    receive = exchange(mesh, buckets)

    def regroup(d: int, dev: torch.device):
        k, sm, c = receive(d, dev)
        # stable passes from the least significant key to the most
        order = torch.sort(c, stable=True).indices
        order = order[torch.sort(sm[order], stable=True).indices]
        if k.dim() == 1:
            order = order[torch.sort(k[order], stable=True).indices]
        else:
            order = order[sort_keys(k[:, order])[1]]
        return k[..., order], sm[order], c[order]

    return mesh.map(regroup)


def count_shards(mesh: Mesh, chunks: list[np.ndarray], k: int,
                 nb_partitions: int):
    """The fused mesh count of one round (make_sharded_count_kernel):
    chunks[s] (u8 codes, k-1 codes of overlap with the next chunk; at most
    one a shard, fewer chunks than shards leave the rest without codes) ->
    per shard d, the distinct k-mers of the partitions it owns and their
    counts, (keys [U] int64 or [nw, U] ascending, counts [U] int32 holding
    u32), on d's device: K-EXT, K-PART, the exchange, then torch.sort and
    K-RUN."""
    D = mesh.size

    def extract(s: int, dev: torch.device):
        codes = chunks[s] if s < len(chunks) else np.zeros(0, np.uint8)
        keys = canonical_kmers(torch.from_numpy(codes).to(dev), k)
        return bucket_by_shard(keys, (), nb_partitions, D)

    receive = exchange(mesh, mesh.map(extract))
    return mesh.map(lambda d, dev: sort_rle(receive(d, dev)[0]))
