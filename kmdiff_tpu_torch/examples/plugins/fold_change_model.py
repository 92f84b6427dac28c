"""Example custom statistical model plugin (numpy ABI).

The port's twin of the JAX package's examples/plugins/fold_change_model.py,
on kmdiff_tpu_torch's IModel (a plugin of the port never imports the JAX
package). Load with

    python -m kmdiff_tpu_torch diff ... \
        --model kmdiff_tpu_torch/examples/plugins/fold_change_model.py \
        --model-config "2.0"

or `--model kmdiff_tpu_torch.examples.plugins.fold_change_model`.

The model flags a k-mer as significant when the coverage-normalized mean
count ratio between groups exceeds a fold-change threshold (taken from the
config string). `process_block` is the vectorized entry the pipeline
calls; scalar `process` is derived from it via the base class.
"""

from __future__ import annotations

import numpy as np

from kmdiff_tpu_torch.core.model import IModel, Significance

PLUGIN_NAME = "fold-change"


class FoldChangeModel(IModel):
    def __init__(self, fold: float = 2.0):
        self.fold = fold

    def process_block(self, counts: np.ndarray, nb_controls: int):
        counts = np.asarray(counts, dtype=np.float64)
        mean_c = counts[:, :nb_controls].mean(axis=1)
        mean_k = counts[:, nb_controls:].mean(axis=1)
        ratio = (mean_k + 1.0) / (mean_c + 1.0)
        sig = (ratio >= self.fold) | (ratio <= 1.0 / self.fold)
        # pseudo p-value: below threshold when significant
        p = np.where(sig, 1e-30, 1.0)
        sign = np.where(
            mean_c > mean_k,
            np.int8(Significance.CONTROL),
            np.where(mean_k > mean_c, np.int8(Significance.CASE),
                     np.int8(Significance.NO)),
        )
        return p, sign, mean_c, mean_k


def create_model(config: str) -> FoldChangeModel:
    return FoldChangeModel(float(config) if config else 2.0)
