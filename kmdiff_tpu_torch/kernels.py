"""Build, load and launch the hand-written CUDA kernels of the port.

The kernels live in ``csrc/*.cu`` beside this file:

  lrt_filter       K-LRT   Poisson LR filter          (ops.lrt_kernel)
  canonical_kmers  K-EXT   canonical k-mer keys       (ops.codec)
  run_bounds       K-RUN   runs of sorted keys        (ops.codec)
  compact          K-CMP   ordered compaction         (ops.codec)
  assemble_chunk   K-ASM   merge chunk from resident  (pipeline.fused)
                           stream slices
  weighted_runs    K-WRUN  per-run u32 weight sums    (ops.codec)
  abundance_hist   K-HIST  count statistics and       (ops.codec)
                           abundance histogram
  run_rows         K-ROWS  per-sample rows of runs    (ops.merge_dev)
  geno_sample      K-GENO  hashed k-mer sample        (ops.merge_dev)
  int_gram         K-GRAM  exact 0/1 Gram             (ops.pca)
  irls             K-IRLS  batched logistic IRLS      (ops.glm)
  partition_ids    K-PART  owner shard of each k-mer  (ops.codec; the mesh
                           and the rows a shard gets   count, parallel.
                                                       count_step)
  fasta_codes      K-FASTA FASTA/FASTQ bytes -> codes (ops.codec; the fused
                                                       run's decode,
                                                       io.fasta.device_codes)

K-EXT, K-RUN, K-ASM and K-GENO also have a multi-word form for k > 32
(keys of 2-4 u64 words, word-major [nw, N]) in the same source, counted
under its own name: canonical_kmers_mw, run_bounds_mw, assemble_chunk_mw
and geno_sample_mw (MULTIWORD maps each to its source).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all of
them at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The build happens at the first launch
in a process, never at import, into ``build/kmdiff_tpu_torch/`` under the
checkout; the file name carries a hash of the sources, so an edited source
is rebuilt and a stale library is never loaded.

Each call of a kernel's C entry point (``launch``) adds one to that
kernel's launch count (``launch_counts``), and to its count on the device
it launched on (``launch_counts_by_device``); the counts are process-wide,
summed over every thread (the mesh runtime's shards launch from a thread
each). A caller resets the counts, drives a path and reads them to show the
path went through the kernels. A
C entry point returns ``cudaGetLastError()`` after its launches (K-CMP's,
K-RUN's, K-HIST's and K-FASTA's, which return results in page-locked host
memory, after waiting for their kernel) and
``launch`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from kmdiff_tpu_torch import profiling

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kmdiff_tpu_torch")

KERNELS = ("lrt_filter", "canonical_kmers", "run_bounds", "compact",
           "assemble_chunk", "weighted_runs", "abundance_hist", "run_rows",
           "geno_sample", "int_gram", "irls", "partition_ids", "fasta_codes")

#: the multi-word forms' launch-count names -> the kernel (source) of each
MULTIWORD = {"canonical_kmers_mw": "canonical_kmers", "run_bounds_mw": "run_bounds",
             "assemble_chunk_mw": "assemble_chunk", "geno_sample_mw": "geno_sample"}

#: -fmad=false and no --use_fast_math: the LR margin assumes IEEE logf,
#: division and unfused multiply-adds (kmdiff_tpu/ops/lrt.py:41-46);
#: -Xptxas -v reports each kernel's registers, spills and shared memory
#: (build_log)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_u = ctypes.c_uint
_f = ctypes.c_float

#: C signatures: name -> (restype, argtypes)
_SIGNATURES = {
    "kmd_lrt_filter": (_i, [_vp, _ll, _i, _i, _i, _f, _f, _f, _vp, _vp, _vp, _vp, _vp]),
    "kmd_canonical_kmers_tile_windows": (_ll, []),
    "kmd_canonical_kmers": (_i, [_vp, _ll, _i, _vp, _vp]),
    "kmd_canonical_kmers_mw_tile_windows": (_ll, [_i]),
    "kmd_canonical_kmers_mw_run_windows": (_ll, [_i]),
    "kmd_canonical_kmers_mw": (_i, [_vp, _ll, _i, _vp, _vp]),
    "kmd_run_encode_tile_rows": (_ll, [_i]),
    "kmd_run_encode": (_i, [_vp, _ll, _i, _vp, _vp, _vp, _i, _vp, _vp, _vp, _vp,
                            _vp, _vp, _vp]),
    "kmd_run_encode_mw_tile_rows": (_ll, []),
    "kmd_run_encode_mw": (_i, [_vp, _ll, _ll, _i, _i, _vp, _vp, _vp, _i, _vp, _vp,
                               _ll, _vp, _vp, _vp, _vp, _vp]),
    "kmd_compact_tile_rows": (_ll, []),
    "kmd_compact": (_i, [_vp, _ll, _vp, _vp, _vp, _vp, _vp, _vp]),
    "kmd_assemble_chunk_tile_rows": (_ll, []),
    "kmd_assemble_chunk": (_i, [_vp, _vp, _vp, _i, _i, _ll, _i, _vp, _vp, _vp, _vp]),
    "kmd_assemble_chunk_mw": (_i, [_vp, _vp, _vp, _i, _i, _ll, _i, _i, _vp, _vp, _vp,
                                   _vp]),
    "kmd_weighted_run_sums": (_i, [_vp, _ll, _vp, _vp, _vp, _vp, _vp]),
    "kmd_count_stats_scratch_words": (_ll, []),
    "kmd_count_stats": (_i, [_vp, _ll, _i, _i, _vp, _vp, _vp, _vp]),
    "kmd_run_rows": (_i, [_vp, _ll, _vp, _vp, _ll, _vp, _vp, _vp, _i, _i, _vp, _vp]),
    "kmd_geno_sample": (_i, [_vp, _ll, _u, _u, _vp, _vp]),
    "kmd_geno_sample_mw": (_i, [_vp, _ll, _ll, _i, _u, _u, _vp, _vp]),
    "kmd_int_gram_scratch_words": (_ll, [_ll, _i]),
    "kmd_int_gram": (_i, [_vp, _ll, _i, _vp, _vp, _vp]),
    "kmd_irls_max_features": (_i, []),
    "kmd_irls_layout": (_ll, [_i, _i, _i, _i, _ll, _vp, _vp]),
    "kmd_irls": (_i, [_vp, _ll, _vp, _vp, _ll, _i, _i, _i, _f, _f, _ll, _vp, _vp,
                      _vp, _vp, _vp, _vp]),
    "kmd_partition_ids": (_i, [_vp, _ll, _ll, _i, _u, _i, _vp, _vp]),
    "kmd_fasta_codes_tile_bytes": (_ll, []),
    "kmd_fasta_codes": (_i, [_vp, _ll, _i, _vp, _vp, _vp, _vp]),
    "kmd_error_string": (ctypes.c_char_p, [_i]),
}


class _Launches:
    """Per-kernel launch counts, in all and by CUDA device index, shared by
    every thread of the process (the count and diff pipelines and the mesh
    runtime's shards launch from worker threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def add(self, name: str, device: int) -> None:
        with self._lock:
            self._n[name] += 1
            by = self._by_device.setdefault(
                device, dict.fromkeys((*KERNELS, *MULTIWORD), 0))
            by[name] += 1

    def reset(self) -> None:
        with self._lock:
            self._n = dict.fromkeys((*KERNELS, *MULTIWORD), 0)
            self._by_device: dict[int, dict[str, int]] = {}

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._n)

    def snapshot_by_device(self) -> dict[int, dict[str, int]]:
        with self._lock:
            return {d: dict(n) for d, n in self._by_device.items()}


_launches = _Launches()
_lib_lock = threading.Lock()
_lib = None
#: seconds the last build took in this process (0.0 when loaded from cache)
build_seconds = 0.0
#: source name -> what nvcc printed compiling it (ptxas resource usage), from
#: the last build in this process (empty when loaded from cache)
build_log: dict[str, str] = {}


def reset_launch_counts() -> None:
    _launches.reset()


def launch_counts() -> dict[str, int]:
    return _launches.snapshot()


def launch_counts_by_device() -> dict[int, dict[str, int]]:
    """{CUDA device index: launch counts on it} since the last reset."""
    return _launches.snapshot_by_device()


def sources() -> list[str]:
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kmdiff_tpu_torch kernels")


def library_path() -> str:
    h = hashlib.sha1()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libkmdiff_kernels-{h.hexdigest()[:16]}.so")


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once and wait for all; raise on any failure.
    Returns each command's standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed, errs = [], []
    for cmd, proc in zip(cmds, procs):
        _out, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return errs


def build() -> str:
    """Compile csrc/*.cu into the hashed library unless it exists: one nvcc
    per source, all started together, then one link."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)[:-3]}.{tag}.o")
            for s in cus]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        errs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cus, objs)])
        build_log.update(zip((os.path.basename(s)[:-3] for s in cus), errs))
        tmp = f"{out}.{tag}"
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
    return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point `entry` of `kernel` on the current stream, raise
    on a CUDA error, and count one launch of `kernel`. Under --profile the
    call is a ``kmd:<kernel>`` range of the trace (profiling.span)."""
    handle = lib()
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which costs more host time than the launch itself
    device = torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    if profiling.active:
        with profiling.span(f"kmd:{kernel}", timed=False):
            rc = getattr(handle, entry)(*args, stream)
    else:
        rc = getattr(handle, entry)(*args, stream)
    if rc != 0:
        msg = handle.kmd_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
    _launches.add(kernel, device)


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def require_cuda_rows(name: str, t: torch.Tensor) -> int:
    """Check a multi-word key tensor, [nw, N] int64 on the card with
    2 <= nw <= 4 and unit stride along N (a row slice of a wider buffer is
    taken); returns its row stride."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64 or t.dim() != 2 or not 2 <= t.shape[0] <= 4:
        raise TypeError(f"{name}: expected [nw, N] int64 with 2 <= nw <= 4, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: expected unit stride along the rows and "
                         "disjoint rows")
    return t.stride(0)


def require_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
