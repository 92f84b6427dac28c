// K-ROWS: per-sample count rows of selected runs of the merge.
//
// Replaces dense_rows of kmdiff_tpu/ops/merge_dev.py::merge_lrt_local
// (merge_dev.py:302-321: the survivors' per-sample count rows, which popstrat
// and --save-sk read) and its presence form for the sampled geno rows
// (merge_dev.py:323-334).
//
// The merge sorts the chunk's keys with a permutation; a run is a k-mer's
// rows in sorted order, [starts[j], end_j), end_j the next run start or
// n_valid. For each selected run sel[h], row h of the [H, S] output is
// zero but for its rows:
//   rows[h, sample[perm[r]]] = count[perm[r]]
// raw u32 counts (the full merge's: no control flag, which the merge reads
// from the sample id), sample ids as u16. The presence form writes
// count != 0 as u8, so that a count of 2^31 or more, negative as an int32,
// is present. A sample id >= S is ignored.
//
// The TPU form is gone: no S-wide window from each start with masks for the
// neighbouring runs and a scatter into an [n_slots, S + 1] buffer. One warp
// a selected run: its lanes gather the run's rows at once (perm, then
// sample and count; a run holds at most one row a stream, so one gather
// round but for inputs of more than 32 streams), scatter them into the row
// built in warp-private shared memory, zeros included, and store it with
// consecutive lanes on consecutive columns. No memset: a call is one
// device operation, and H = 0 launches nothing.
//
// Bound on the H100: the H x S output bytes and, per run row, 8 bytes of
// permutation plus 4 + 2 gathered at random places. Survivor and sample
// counts are small (10^4 of 10^7 runs): a call is a chain of four dependent
// gathers (sel, starts, perm, sample and count) and a store, and the count
// and sample of each row lie at a random place: two 32-byte sectors a row,
// not the 6 bytes the bound charges.
#include "kmd_common.cuh"

namespace {

constexpr int kWarps = 8;
// columns of a row a warp builds at once; wider rows take several rounds
constexpr int kTile = 512;

template <typename Out>
__global__ void __launch_bounds__(kWarps * 32)
    run_rows_kernel(const int64_t* __restrict__ starts, long long U,
                    const int64_t* __restrict__ n_valid, const int64_t* __restrict__ sel,
                    long long H, const int64_t* __restrict__ perm,
                    const int32_t* __restrict__ count, const uint16_t* __restrict__ sample,
                    int S, Out* __restrict__ rows) {
  __shared__ int32_t tiles[kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const long long h = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (h >= H) return;
  int32_t* tile = tiles[threadIdx.x >> 5];
  const long long j = sel[h];
  const long long begin = starts[j];
  const long long end = j + 1 < U ? starts[j + 1] : *n_valid;
  // the run's first 32 rows, one a lane
  int s0 = S;
  int32_t v0 = 0;
  if (begin + lane < end) {
    const long long p = perm[begin + lane];
    s0 = sample[p];
    v0 = count[p];
  }
  Out* row = rows + h * S;
  for (int c0 = 0; c0 < S; c0 += kTile) {
    const int width = min(kTile, S - c0);
    for (int c = lane; c < width; c += 32) tile[c] = 0;
    __syncwarp();
    if (s0 >= c0 && s0 < c0 + width) tile[s0 - c0] = v0;
    for (long long r = begin + 32 + lane; r < end; r += 32) {
      const long long p = perm[r];
      const int s = sample[p];
      if (s >= c0 && s < c0 + width) tile[s - c0] = count[p];
    }
    __syncwarp();
    for (int c = lane; c < width; c += 32) {
      const int32_t v = tile[c];
      row[c0 + c] = sizeof(Out) == 1 ? static_cast<Out>(v != 0) : static_cast<Out>(v);
    }
    __syncwarp();  // the tile's readers are done before the next round clears it
  }
}

}  // namespace

KMD_API int kmd_run_rows(const int64_t* starts, long long U, const int64_t* n_valid,
                         const int64_t* sel, long long H, const int64_t* perm,
                         const int32_t* count, const uint16_t* sample, int S,
                         int presence, void* rows, cudaStream_t stream) {
  if (S <= 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = kmd::grid_for(H, kWarps);
  if (presence) {
    run_rows_kernel<uint8_t><<<grid, kWarps * 32, 0, stream>>>(
        starts, U, n_valid, sel, H, perm, count, sample, S,
        static_cast<uint8_t*>(rows));
  } else {
    run_rows_kernel<int32_t><<<grid, kWarps * 32, 0, stream>>>(
        starts, U, n_valid, sel, H, perm, count, sample, S,
        static_cast<int32_t*>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}
