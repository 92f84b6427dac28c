"""K-LRT: the Hopper kernel of the Poisson LR filter (port of
kmdiff_tpu/ops/lrt_pallas.py, the JAX package's one Pallas kernel).

``lrt_filter`` has the contract of ``ops.lrt.lrt_filter_block``: counts
[B, S] int32, controls first -> (keep [B] bool, lr [B] f32, s_c [B] int32,
s_k [B] int32), with None in place of lr (want_lr=False) and of the sums
(want_sums=False): the kernel writes only what its caller reads. int64
counts (the wide merge's [U, 2] group sums, K-RUN's full form) take keep
alone; each sum is rounded to f32 once (lrt_filter_block's int64 form). A CPU
tensor runs the plain twin (``lrt_filter_plain``); a CUDA tensor launches
``csrc/lrt_filter.cu``. Any B is taken, and the counts are read row-major
as they are: the Pallas kernel's transpose, its 8-row group padding and
its B % 1024 rule were Mosaic's, not the algorithm's.
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch import kernels
from kmdiff_tpu_torch.ops.lrt import lrt_filter_block as lrt_filter_plain

__all__ = ["lrt_filter", "lrt_filter_plain"]


def lrt_filter(counts: torch.Tensor, nb_controls: int, ratio_c, ratio_k,
               lr_min, want_lr: bool = True, want_sums: bool = True):
    wide = counts.dtype == torch.int64
    if wide and (want_lr or want_sums):
        raise ValueError("lrt_filter: int64 counts take keep alone")
    if counts.device.type == "cpu":
        keep, lr, s_c, s_k = lrt_filter_plain(counts, nb_controls, ratio_c,
                                              ratio_k, lr_min)
        return (keep, lr if want_lr else None,
                *((s_c, s_k) if want_sums else (None, None)))
    kernels.require_cuda_tensor("lrt_filter counts", counts,
                                torch.int64 if wide else torch.int32)
    if counts.dim() != 2 or not 0 <= nb_controls <= counts.shape[1]:
        raise ValueError(f"lrt_filter: bad shape {tuple(counts.shape)} for "
                         f"nb_controls={nb_controls}")
    B, S = counts.shape
    # The merge's form (S = 2, keep alone) stores eight rows' keep a store
    # from row `lead` on (int32: 1 when the pairs start 8 bytes past a
    # 16-byte boundary): the outputs share one allocation, keep placed so
    # that its row `lead` starts on a 16-byte boundary, the others at one.
    lead = int(S == 2 and not wide and counts.data_ptr() % 16 == 8)
    dtypes = [torch.bool] + [torch.float32] * want_lr + [torch.int32] * (2 * want_sums)
    offsets, at = [], -lead % 16
    for dt in dtypes:
        offsets.append(at)
        at += B * dt.itemsize
        at += -at % 16
    buf = torch.empty(at, dtype=torch.uint8, device=counts.device)
    outs = [buf[o : o + B * dt.itemsize].view(dt) for o, dt in zip(offsets, dtypes)]
    keep = outs.pop(0)
    lr = outs.pop(0) if want_lr else None
    s_c, s_k = outs if want_sums else (None, None)
    if B:
        with torch.cuda.device(counts.device):
            kernels.launch(
                "lrt_filter", "kmd_lrt_filter", counts.data_ptr(), B, S,
                int(wide), nb_controls, float(np.float32(ratio_c)),
                float(np.float32(ratio_k)), float(np.float32(lr_min)),
                keep.data_ptr(), kernels.ptr(lr), kernels.ptr(s_c),
                kernels.ptr(s_k),
            )
    return keep, lr, s_c, s_k
