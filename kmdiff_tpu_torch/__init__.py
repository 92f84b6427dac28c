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

A custom model (`--model`, ``plugins``) takes no device merge: each
partition is union-merged on the host and the model scores the rows, on
the device through its ``process_block_torch`` (``examples/plugins/``).
``call`` and ``infos`` are host-only.

The host code (file formats, the f64 model, correctors, writers, popstrat's
sampler and fits on the host, the native LZ4 and merge library) is the
port's own copy of the JAX package's, under the same module names
(``utils``, ``native``, ``io``, ``core``, ``cmd.options``,
``pipeline.aggregate``, ``pipeline.simulate``, ``pipeline.popstrat``):
this package imports neither JAX nor ``kmdiff_tpu``.
"""

__version__ = "0.1.0"


def _tune_host_allocator() -> None:
    """Keep large numpy buffers on the heap instead of per-allocation mmap.

    glibc serves allocations above M_MMAP_THRESHOLD (<= 32 MB dynamic max)
    straight from mmap and unmaps them on free, so every large temporary
    repays first-touch page faults. On sandboxed/virtualized hosts faults
    can run at ~10-20 MB/s (the JAX package measured a 37 MB astype temp at
    2-5 s per call; with the heap serving it, 10 ms after the one-time
    high-water fault-in). Raising the threshold makes the host pipeline's
    big temporaries (decode buffers, triple staging, fetch concatenates)
    reuse heap pages. Opt out with KMDIFF_NO_MALLOC_TUNE=1."""
    import os

    if os.environ.get("KMDIFF_NO_MALLOC_TUNE") == "1":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:  # glibc-specific tuning, never fatal
        pass


_tune_host_allocator()
