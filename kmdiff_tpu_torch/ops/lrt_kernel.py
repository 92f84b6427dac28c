"""K-LRT: the Hopper kernel of the Poisson LR filter (port of
kmdiff_tpu/ops/lrt_pallas.py, the JAX package's one Pallas kernel).

``lrt_filter`` has the contract of ``ops.lrt.lrt_filter_block``: counts
[B, S] int32, controls first -> (keep [B] bool, lr [B] f32, s_c [B] int32,
s_k [B] int32). A CPU tensor runs the plain twin (``lrt_filter_plain``); a
CUDA tensor launches ``csrc/lrt_filter.cu``. Any B is taken, and the
counts are read row-major as they are: the Pallas kernel's transpose, its
8-row group padding and its B % 1024 rule were Mosaic's, not the
algorithm's.
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch import kernels
from kmdiff_tpu_torch.ops.lrt import lrt_filter_block as lrt_filter_plain

__all__ = ["lrt_filter", "lrt_filter_plain"]


def lrt_filter(counts: torch.Tensor, nb_controls: int, ratio_c, ratio_k,
               lr_min):
    if counts.device.type == "cpu":
        return lrt_filter_plain(counts, nb_controls, ratio_c, ratio_k, lr_min)
    kernels.require_cuda_tensor("lrt_filter counts", counts, torch.int32)
    if counts.dim() != 2 or not 0 <= nb_controls <= counts.shape[1]:
        raise ValueError(f"lrt_filter: bad shape {tuple(counts.shape)} for "
                         f"nb_controls={nb_controls}")
    B, S = counts.shape
    dev = counts.device
    keep = torch.empty(B, dtype=torch.bool, device=dev)
    lr = torch.empty(B, dtype=torch.float32, device=dev)
    s_c = torch.empty(B, dtype=torch.int32, device=dev)
    s_k = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            kernels.launch(
                "lrt_filter", "kmd_lrt_filter", counts.data_ptr(), B, S,
                nb_controls, float(np.float32(ratio_c)),
                float(np.float32(ratio_k)), float(np.float32(lr_min)),
                keep.data_ptr(), lr.data_ptr(), s_c.data_ptr(), s_k.data_ptr(),
            )
    return keep, lr, s_c, s_k
