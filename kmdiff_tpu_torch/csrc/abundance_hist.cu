// K-HIST: the abundance histogram of a sample's distinct k-mer counts.
//
// Replaces the with_hist branch of kmdiff_tpu/ops/codec.py::sort_rle_core
// (codec.py:418-434): bin b in 1..255 counts the distinct k-mers seen b
// times, bin 256 those seen more than 255 times. Those are the cardinalities
// that kmdiff_tpu/io/kmtricks.py::hist_from_device turns into a kmtricks .hist
// file, so no O(distinct) counts array crosses to the host. Bin 0 counts
// zero counts (none in a counted stream); the JAX uvec[0] is pad junk.
//
//   kmd_abundance_hist  counts [N] u32 -> bins [257] u64 (zeroed here)
//
// The TPU form is gone: no sort of the clipped counts and no 258 binary
// searches (a TPU scatter serialises). Each block builds its 257 bins in
// shared memory and adds each non-zero bin to the global bins with one
// atomic. Counts are mostly 1 in a low-coverage sample, so the lanes of a
// warp mostly hit the same bin: __match_any_sync groups the lanes by bin and
// one lane a group adds the group's size.
//
// Bound on the H100: device memory, 4 bytes read a count; the shared-memory
// atomics are one a bin present in a warp.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 257;
// about eight blocks an SM of a 132-SM card; each thread strides over the rest
constexpr long long kMaxBlocks = 132 * 8;

__global__ void abundance_hist_kernel(const uint32_t* __restrict__ counts, long long N,
                                      unsigned long long* __restrict__ bins) {
  __shared__ unsigned int local[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) local[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // base is the same for every lane of a warp, so the whole warp takes each
  // trip of the loop and __match_any_sync sees all 32 lanes
  for (long long base = blockIdx.x * static_cast<long long>(blockDim.x) + (threadIdx.x & ~31);
       base < N; base += stride) {
    const long long i = base + lane;
    int bin = -1;
    if (i < N) {
      const uint32_t c = counts[i];
      bin = c < 256u ? static_cast<int>(c) : 256;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&local[bin], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    if (local[b]) atomicAdd(&bins[b], static_cast<unsigned long long>(local[b]));
  }
}

}  // namespace

KMD_API int kmd_abundance_hist(const uint32_t* counts, long long N,
                               unsigned long long* bins, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(bins, 0, kBins * sizeof(unsigned long long), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  abundance_hist_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      counts, N, bins);
  return static_cast<int>(cudaGetLastError());
}
