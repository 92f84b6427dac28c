"""Device-vectorized custom model plugin (the `process_block_torch` ABI).

The pipeline feeds int32 count tiles of at most BLOCK_ROWS rows, on the
processor's device (the card, or the CPU when the caller asks for it), to
`process_block_torch` and reads its four outputs back in one copy a tile.
This is the port's twin of the JAX package's
examples/plugins/device_fold_change_model.py (its `process_block_jax`), in
plain torch on kmdiff_tpu_torch's IModel.

Decision-identical to fold_change_model.py (the host numpy version): the
fold test and the sign are computed by integer cross-multiplication, which
f32 evaluates exactly while every per-row count sum stays below 2^24. The
means are f32, as the JAX twin's are, so the FASTA equals the JAX device
plugin's byte for byte; it equals the numpy plugin's wherever the means
are exact in f32 (the headers print them as shortest round-trip f64).
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch.core.model import IModel, Significance

PLUGIN_NAME = "fold-change-device"


class DeviceFoldChangeModel(IModel):
    def __init__(self, fold: float = 2.0):
        self.fold = fold

    def process_block_torch(self, counts: torch.Tensor, nb_controls: int):
        nc = nb_controls
        nk = counts.shape[1] - nb_controls
        # int32 row sums (they wrap as the JAX twin's do), exact in f32
        # below 2^24
        sum_c = counts[:, :nc].sum(dim=1, dtype=torch.int32).to(torch.float32)
        sum_k = counts[:, nc:].sum(dim=1, dtype=torch.int32).to(torch.float32)
        # sum * f32(1/n), not sum / n: XLA folds the JAX twin's division by
        # the constant n into that product, and the means reach the FASTA
        mean_c = sum_c * float(np.float32(1) / np.float32(nc))
        mean_k = sum_k * float(np.float32(1) / np.float32(nk))
        # (mean_k+1)/(mean_c+1) >= fold  <=>  nc*(sum_k+nk) >= fold*nk*(sum_c+nc)
        lhs = nc * (sum_k + nk)
        rhs = nk * (sum_c + nc)
        sig = (lhs >= self.fold * rhs) | (self.fold * lhs <= rhs)
        p = torch.where(sig, 1e-30, 1.0)
        # mean_c > mean_k  <=>  nk*sum_c > nc*sum_k (exact)
        no = torch.full(sum_c.shape, int(Significance.NO), dtype=torch.int8,
                        device=counts.device)
        sign = torch.where(
            nk * sum_c > nc * sum_k, int(Significance.CONTROL),
            torch.where(nc * sum_k > nk * sum_c, int(Significance.CASE), no),
        )
        return p, sign, mean_c, mean_k


def create_model(config: str) -> DeviceFoldChangeModel:
    return DeviceFoldChangeModel(float(config) if config else 2.0)
