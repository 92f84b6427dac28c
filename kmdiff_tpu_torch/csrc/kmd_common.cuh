// Shared declarations of the kmdiff_tpu_torch kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// kmdiff_tpu_torch/kernels.py), launches on the stream it is given, never
// synchronises and allocates nothing: the Python wrapper allocates outputs
// with torch.empty. Each returns cudaGetLastError() right after its
// launches, so a refused launch reaches the wrapper, which raises.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KMD_API extern "C" __attribute__((visibility("default")))

namespace kmd {

// Sorted-key sentinel: the all-ones u64 k-mer with its top bit flipped.
// Invalid windows map here; no canonical k-mer does (kmdiff_tpu/ops/codec.py
// count_sort_rle_lanes explains why), so it sorts last and is masked.
constexpr int64_t kSentinel = INT64_MAX;

inline unsigned grid_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace kmd
