"""kmdiff_tpu_torch: the PyTorch/CUDA port of kmdiff-tpu.

The `count`, `diff` and `run` commands of the JAX package
(``kmdiff_tpu``), with every device program rewritten in PyTorch and the
hot loops as hand-written CUDA kernels for Hopper (``csrc/``, built by
``kernels``):

  count : FASTA -> canonical k-mer keys (K-EXT) -> torch.sort -> run starts
          and lengths (K-RUN, K-CMP) -> kmtricks-compatible run directory
  diff  : per-partition merge of the count files -> torch.sort -> per-group
          run sums (K-RUN, K-CMP) -> Poisson LR filter (K-LRT) -> survivors
          (K-CMP) -> exact f64 rescore, correction and FASTA/KFF output
  run   : count with the streams kept on the device (multi-chunk samples
          merged by K-WRUN, histograms by K-HIST) -> key-range chunks
          assembled there (K-ASM) -> diff's merge, test and output; the
          run directory written by background threads

The host code the JAX package keeps free of JAX (file formats, the f64
model, correctors, writers, the native LZ4 and merge helpers) is imported
from ``kmdiff_tpu`` as it is; this package never imports JAX.
"""

import os as _os

# Importing kmdiff_tpu points JAX's persistent compile cache at a directory,
# importing JAX to do so, unless KMDIFF_NO_JAX_CACHE is "1". The port uses
# only JAX-free modules of that package, so it switches the set-up off
# before any of them is imported (this also holds for JAX code later run
# in the same process).
_os.environ["KMDIFF_NO_JAX_CACHE"] = "1"

__version__ = "0.1.0"
