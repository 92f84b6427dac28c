// K-WRUN: per-run sums of u32 weights over sorted keys.
//
// Replaces the weighted branch of kmdiff_tpu/ops/codec.py::sort_rle_core
// (codec.py:396-408), reached through dedup_sum_lanes (codec.py:237): the
// k-way "dedup" merge of already-counted sorted streams, where the partial
// counts of one k-mer in several chunk streams add up to its count.
//
//   kmd_weighted_run_sums  per run j: sum of weights[perm[r]] for r in
//                          [starts[j], end_j), end_j the next start or n_valid,
//                          into int64
//
// The TPU form is gone: the weights no longer ride the sort as an extra key,
// and no wrapped-u32 prefix sum is differenced at run boundaries. The sort
// carries a permutation and each thread walks its run through it. The sums
// are exact int64; the wrapper checks that each fits the u32 the count files
// hold.
//
// One thread a run walks the whole run. That is bounded here: a run holds at
// most one row per input stream, because each chunk stream is already
// distinct (the same reasoning as run_bounds.cu's group sums). In the
// hard-min pass every run has one row.
//
// Bound on the H100: device memory. A run reads 16 bytes of starts and, per
// row, 8 of permutation and 4 of weight at a random place, and writes 8.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void weighted_run_sums_kernel(const int64_t* __restrict__ starts, long long U,
                                         const int64_t* __restrict__ n_valid,
                                         const int64_t* __restrict__ perm,
                                         const uint32_t* __restrict__ weights,
                                         int64_t* __restrict__ sums) {
  long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= U) return;
  const long long end = j + 1 < U ? starts[j + 1] : *n_valid;
  int64_t s = 0;
  for (long long r = starts[j]; r < end; ++r) s += weights[perm[r]];
  sums[j] = s;
}

}  // namespace

KMD_API int kmd_weighted_run_sums(const int64_t* starts, long long U,
                                  const int64_t* n_valid, const int64_t* perm,
                                  const uint32_t* weights, int64_t* sums,
                                  cudaStream_t stream) {
  weighted_run_sums_kernel<<<kmd::grid_for(U, kThreads), kThreads, 0, stream>>>(
      starts, U, n_valid, perm, weights, sums);
  return static_cast<int>(cudaGetLastError());
}
