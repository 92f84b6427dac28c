// K-RUN: run boundaries over sorted int64 keys, and per-run reductions.
//
// Replaces the run-length half of kmdiff_tpu/ops/codec.py::sort_rle_core
// (codec.py:377-395: run starts, per-run lengths) and the segment sums of
// kmdiff_tpu/ops/merge_dev.py::merge_lrt_local's packed branch
// (merge_dev.py:182-263: per-run control and case sums). Three entry points
// share this file:
//   kmd_run_flags       flags[i] = 1 where row i starts a run of equal keys
//                       and is not the sentinel; n_valid = rows before the
//                       sentinel tail
//   kmd_run_lengths     per run j: next start (or n_valid) - start
//   kmd_run_group_sums  per run j: [control sum, case sum] of the packed
//                       counts of its rows, read through the sort's
//                       permutation, into a [U, 2] int32 matrix
// The run starts themselves come from K-CMP (compact.cu) over the flags.
//
// The TPU forms are gone: no reverse cummin to carry run ends back (XLA has
// no cheap scatter on the TPU), no all-keys sort that drags the counts as
// extra keys. On the GPU the sort carries a permutation, and the sums read
// the counts through it.
//
// Long runs: a count run can hold 10^5 copies of one repeat k-mer, so no
// thread walks a count run. A length is the difference of two neighbouring
// starts, O(1) per run. The group sums do walk their run, but a merge run
// holds at most one row per input stream (2 after the host group pre-sum).
//
// Bound on the H100: device memory. Flags read 8 bytes and write 1 per row;
// lengths read 16 bytes and write 4 per run; group sums gather 8 + 2..4
// bytes per row through the permutation (random reads) and write 8 per run.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void run_flags_kernel(const int64_t* __restrict__ keys, long long N,
                                 uint8_t* __restrict__ flags,
                                 int64_t* __restrict__ n_valid) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= N) return;
  int64_t key = keys[i];
  bool valid = key != kmd::kSentinel;
  flags[i] = (valid && (i == 0 || keys[i - 1] != key)) ? 1 : 0;
  // keys are sorted, so the sentinels form the tail: the last valid row
  // is the only one whose successor is missing or a sentinel
  if (valid && (i + 1 == N || keys[i + 1] == kmd::kSentinel)) *n_valid = i + 1;
}

__device__ __forceinline__ long long run_end(const int64_t* starts, long long U,
                                             long long j, const int64_t* n_valid) {
  return j + 1 < U ? starts[j + 1] : *n_valid;
}

__global__ void run_lengths_kernel(const int64_t* __restrict__ starts, long long U,
                                   const int64_t* __restrict__ n_valid,
                                   int32_t* __restrict__ lengths) {
  long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= U) return;
  lengths[j] = static_cast<int32_t>(run_end(starts, U, j, n_valid) - starts[j]);
}

// count_bytes == 2: u16 counts, control flag in bit 15, count in bits 0..14.
// count_bytes == 4: i32 counts, control flag in the sign bit.
// (kmdiff_tpu/ops/merge_dev.py::_pack_rows is the one source of the packing.)
__global__ void run_group_sums_kernel(const int64_t* __restrict__ starts, long long U,
                                      const int64_t* __restrict__ n_valid,
                                      const int64_t* __restrict__ perm,
                                      const void* __restrict__ counts, int count_bytes,
                                      int32_t* __restrict__ sums) {
  long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= U) return;
  long long end = run_end(starts, U, j, n_valid);
  int32_t s_c = 0;
  int32_t s_k = 0;
  for (long long r = starts[j]; r < end; ++r) {
    long long p = perm[r];
    int32_t v;
    bool ctrl;
    if (count_bytes == 2) {
      uint16_t c = static_cast<const uint16_t*>(counts)[p];
      ctrl = (c & 0x8000u) != 0;
      v = static_cast<int32_t>(c & 0x7FFFu);
    } else {
      int32_t c = static_cast<const int32_t*>(counts)[p];
      ctrl = c < 0;
      v = c & 0x7FFFFFFF;
    }
    if (ctrl) s_c += v; else s_k += v;
  }
  sums[2 * j] = s_c;
  sums[2 * j + 1] = s_k;
}

}  // namespace

KMD_API int kmd_run_flags(const int64_t* keys, long long N, uint8_t* flags,
                          int64_t* n_valid, cudaStream_t stream) {
  run_flags_kernel<<<kmd::grid_for(N, kThreads), kThreads, 0, stream>>>(
      keys, N, flags, n_valid);
  return static_cast<int>(cudaGetLastError());
}

KMD_API int kmd_run_lengths(const int64_t* starts, long long U,
                            const int64_t* n_valid, int32_t* lengths,
                            cudaStream_t stream) {
  run_lengths_kernel<<<kmd::grid_for(U, kThreads), kThreads, 0, stream>>>(
      starts, U, n_valid, lengths);
  return static_cast<int>(cudaGetLastError());
}

KMD_API int kmd_run_group_sums(const int64_t* starts, long long U,
                               const int64_t* n_valid, const int64_t* perm,
                               const void* counts, int count_bytes,
                               int32_t* sums, cudaStream_t stream) {
  if (count_bytes != 2 && count_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  run_group_sums_kernel<<<kmd::grid_for(U, kThreads), kThreads, 0, stream>>>(
      starts, U, n_valid, perm, counts, count_bytes, sums);
  return static_cast<int>(cudaGetLastError());
}
