// K-ROWS: per-sample count rows of selected runs of the merge.
//
// Replaces dense_rows of kmdiff_tpu/ops/merge_dev.py::merge_lrt_local
// (merge_dev.py:302-321: the survivors' per-sample count rows, which popstrat
// and --save-sk read) and its presence form for the sampled geno rows
// (merge_dev.py:323-334).
//
// The merge sorts the chunk's keys with a permutation; a run is a k-mer's
// rows in sorted order, [starts[j], end_j), end_j the next run start or
// n_valid. For each selected run sel[h] one thread walks the run and writes
// row h of a zeroed [H, S] matrix:
//   rows[h, sample[perm[r]]] = count[perm[r]] & 0x7FFFFFFF
// counts in the p32 packing (control flag in the sign bit, the packing of
// run_bounds.cu's group sums), sample ids as u16. The presence form writes
// count > 0 as u8. A sample id >= S is ignored.
//
// The TPU form is gone: no S-wide window from each start with masks for the
// neighbouring runs and a scatter into an [n_slots, S + 1] buffer. One thread
// a run walks at most S rows, since every input stream is distinct.
//
// Bound on the H100: the H x S bytes of the output (one memset and the row
// writes) and, per run row, 8 bytes of permutation plus 4 + 2 gathered at
// random places. Survivor and sample counts are small (10^4 of 10^7 runs).
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename Out>
__global__ void run_rows_kernel(const int64_t* __restrict__ starts, long long U,
                                const int64_t* __restrict__ n_valid,
                                const int64_t* __restrict__ sel, long long H,
                                const int64_t* __restrict__ perm,
                                const int32_t* __restrict__ count,
                                const uint16_t* __restrict__ sample, int S,
                                Out* __restrict__ rows) {
  long long h = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (h >= H) return;
  const long long j = sel[h];
  const long long end = j + 1 < U ? starts[j + 1] : *n_valid;
  Out* row = rows + h * S;
  for (long long r = starts[j]; r < end; ++r) {
    const long long p = perm[r];
    const int s = sample[p];
    if (s >= S) continue;
    const int32_t v = count[p] & 0x7FFFFFFF;
    row[s] = sizeof(Out) == 1 ? static_cast<Out>(v > 0) : static_cast<Out>(v);
  }
}

}  // namespace

KMD_API int kmd_run_rows(const int64_t* starts, long long U, const int64_t* n_valid,
                         const int64_t* sel, long long H, const int64_t* perm,
                         const int32_t* count, const uint16_t* sample, int S,
                         int presence, void* rows, cudaStream_t stream) {
  if (S <= 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(H) * S * (presence ? 1 : 4);
  cudaError_t err = cudaMemsetAsync(rows, 0, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = kmd::grid_for(H, kThreads);
  if (presence) {
    run_rows_kernel<uint8_t><<<grid, kThreads, 0, stream>>>(
        starts, U, n_valid, sel, H, perm, count, sample, S,
        static_cast<uint8_t*>(rows));
  } else {
    run_rows_kernel<int32_t><<<grid, kThreads, 0, stream>>>(
        starts, U, n_valid, sel, H, perm, count, sample, S,
        static_cast<int32_t*>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}
