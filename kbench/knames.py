"""The table of kernel names: a CUDA kernel's symbol in a trace -> the name
PERF.md's kernel table gives it.

The port's kernels are the ``__global__`` functions of
kmdiff_tpu_torch/csrc/*.cu; a trace names a kernel by its demangled
signature, which holds the symbol. The multi-word forms (k > 32) carry
``-mw``. Any other kernel keeps a short form of its own name: torch's sorts
(CUB radix passes) are ``torch.sort``.
"""

from __future__ import annotations

#: symbol -> name; longer symbols first where one holds another
TABLE = {
    "canonical_kmers_mw_kernel": "K-EXT-mw",
    "canonical_kmers_kernel": "K-EXT",
    "run_encode_mw_kernel": "K-RUN-mw",
    "run_encode_kernel": "K-RUN",
    "compact_kernel": "K-CMP",
    "assemble_mw_kernel": "K-ASM-mw",
    "assemble_kernel": "K-ASM",
    "weighted_run_sums_kernel": "K-WRUN",
    "count_stats_kernel": "K-HIST",
    "lrt_wide_pairs_kernel": "K-LRT",
    "lrt_pairs_kernel": "K-LRT",
    "lrt_rows_kernel": "K-LRT",
    "run_rows_kernel": "K-ROWS",
    "geno_sample_mw_kernel": "K-GENO-mw",
    "geno_sample_kernel": "K-GENO",
    "gram_kernel": "K-GRAM",
    "pack_bits_kernel": "K-GRAM",
    "irls_kernel": "K-IRLS",
    "partition_ids_kernel": "K-PART",
}

_SORT_MARKS = ("DeviceRadixSort", "RadixSort", "radixSort", "DeviceSegmentedSort",
               "DeviceMergeSort", "sort_")


def name(symbol: str) -> str:
    for key, kname in TABLE.items():
        if key in symbol:
            return kname
    if any(m in symbol for m in _SORT_MARKS):
        return "torch.sort"
    short = symbol.removeprefix("void ").replace("(anonymous namespace)::", "")
    return short.split("(")[0].split("<")[0][-60:] or symbol[:60]
