"""The mesh LR filter of count-matrix blocks (port of
kmdiff_tpu/parallel/diff_step.py).

A [R, S] block's rows split into contiguous blocks, one a shard of the
mesh (Mesh.blocks); each shard runs K-LRT on its rows on its device
(ops.lrt_kernel.lrt_filter, the kernel of ops.lrt.run_filter), and the four
counters (rows tested, kept, kept on the control side, kept on the case
side) are summed on the host, the JAX package's psum. The rows come back in
shard order, which is the block's row order.
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch.parallel.mesh import Mesh


def make_sharded_diff_step(mesh: Mesh, nb_controls: int):
    """step(counts [R, S] int32 or u32 (host), ratio_c, ratio_k, lr_min,
    want_lr=True) -> (keep [R] bool, lr [R] f32 or None, s_c, s_k [R]
    int32, stats [4] int64: tested, significant, sig_control, sig_case),
    numpy, in row order."""
    from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter

    def step(counts: np.ndarray, ratio_c, ratio_k, lr_min, want_lr: bool = True):
        counts = np.ascontiguousarray(counts)
        if counts.dtype == np.uint32:
            counts = counts.view(np.int32)
        blocks = mesh.blocks(len(counts))

        def shard(d: int, dev: torch.device):
            c = torch.from_numpy(counts[slice(*blocks[d])])
            keep, lr, s_c, s_k = lrt_filter(
                c.to(device=dev, dtype=torch.int32), nb_controls, ratio_c,
                ratio_k, lr_min, want_lr=want_lr)
            # the sign rule of kmdiff_tpu/parallel/diff_step.py in f32
            lhs = s_c.to(torch.float32) * float(np.float32(ratio_k))
            rhs = s_k.to(torch.float32) * float(np.float32(ratio_c))
            control = keep & (lhs > rhs)
            stats = torch.stack([keep.sum(), control.sum(), (keep & ~control).sum()])
            return (keep.cpu().numpy(), None if lr is None else lr.cpu().numpy(),
                    s_c.cpu().numpy(), s_k.cpu().numpy(), stats.cpu().numpy())

        parts = mesh.map(shard, len(blocks))
        kept = sum(p[4] for p in parts)
        stats = np.array([len(counts), *kept], dtype=np.int64)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]) if want_lr else None,
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts]), stats)

    return step
