// K-CMP: ordered stream compaction.
//
// Given mask [N] (bool, one byte each) it writes the ascending indices of the
// set rows, and optionally gathers an int64 payload at those rows, plus the
// count. This is the contract of kmdiff_tpu/ops/merge_dev.py::
// _compact_indices (jnp.nonzero with a size) and of the compaction sort at
// kmdiff_tpu/ops/codec.py:435-454, without their TPU forms: no second
// all-keys sort, no fixed output budget. The count is known before the
// output is allocated (kmd_compact_offsets, then one 8-byte read by the
// wrapper), so the JAX package's overflow-retry loop has nothing to do.
//
// Three kernels, each a plain pass:
//   tile_counts  each block counts the set rows of its 4096-row tile
//   scan_tiles   one block turns the tile counts into exclusive offsets and
//                the total (offsets[n_tiles])
//   scatter      each block recounts its tile and writes its rows at its
//                offset, in order
// Warp w of a block owns 512 consecutive rows of the tile and walks them 32
// at a time: lane l reads row 32s + l, a ballot gives every set lane its
// rank among the set lanes, so a warp's reads and writes are contiguous.
//
// Bound on the H100: device memory. The mask is read twice (2 bytes a row)
// and a kept row writes 8 bytes (16 with a payload, whose read is a gather
// of contiguous runs). The single-block scan costs n_tiles/1024 rounds: 2
// at 2^23 rows. The wrapper's read of the count between the passes is a
// host round trip; it stays, because the output is sized by it.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;
constexpr int kWarpRows = 32 * kSteps;
constexpr int kTile = kWarps * kWarpRows;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ long long warp_first_row() {
  return blockIdx.x * static_cast<long long>(kTile) +
         static_cast<long long>(threadIdx.x >> 5) * kWarpRows;
}

__device__ __forceinline__ bool is_set(const uint8_t* __restrict__ mask,
                                       long long N, long long i) {
  return i < N && mask[i] != 0;
}

// Set rows among the warp's 512 rows (the same value in every lane).
__device__ int warp_count(const uint8_t* __restrict__ mask, long long N) {
  const long long first = warp_first_row() + (threadIdx.x & 31);
  int c = 0;
  for (int s = 0; s < kSteps; ++s) {
    c += __popc(__ballot_sync(0xffffffffu, is_set(mask, N, first + 32 * s)));
  }
  return c;
}

__global__ void tile_counts_kernel(const uint8_t* __restrict__ mask, long long N,
                                   int64_t* __restrict__ offsets) {
  __shared__ int warp_totals[kWarps];
  int c = warp_count(mask, N);
  if ((threadIdx.x & 31) == 0) warp_totals[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_totals[w];
    offsets[blockIdx.x] = total;
  }
}

// In place: offsets[0, n_tiles) counts -> exclusive prefix sums, and
// offsets[n_tiles] = the total. One block, n_tiles/1024 rounds.
__global__ void scan_tiles_kernel(int64_t* __restrict__ offsets, long long n_tiles) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < n_tiles; base += kScanThreads) {
    long long i = base + threadIdx.x;
    int64_t v = i < n_tiles ? offsets[i] : 0;
    int64_t x = v;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      int64_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp sums
      int64_t s = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        int64_t y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    int64_t before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < n_tiles) offsets[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n_tiles] = carry;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ mask, long long N,
                               const int64_t* __restrict__ offsets,
                               const int64_t* __restrict__ payload,
                               int64_t* __restrict__ out_idx,
                               int64_t* __restrict__ out_payload) {
  __shared__ int warp_totals[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int c = warp_count(mask, N);
  if (lane == 0) warp_totals[warp] = c;
  __syncthreads();
  long long pos = offsets[blockIdx.x];
  for (int w = 0; w < warp; ++w) pos += warp_totals[w];

  const unsigned below = (1u << lane) - 1u;
  const long long first = warp_first_row() + lane;
  for (int s = 0; s < kSteps; ++s) {
    long long i = first + 32 * s;
    bool set = is_set(mask, N, i);
    unsigned ballot = __ballot_sync(0xffffffffu, set);
    if (set) {
      long long p = pos + __popc(ballot & below);
      if (out_idx) out_idx[p] = i;
      if (out_payload) out_payload[p] = payload[i];
    }
    pos += __popc(ballot);
  }
}

}  // namespace

KMD_API long long kmd_compact_tile_rows(void) { return kTile; }

// offsets: [ceil(N / kTile) + 1] int64; on return offsets[t] is tile t's
// first output slot and offsets[n_tiles] the number of set rows.
KMD_API int kmd_compact_offsets(const uint8_t* mask, long long N,
                                int64_t* offsets, cudaStream_t stream) {
  long long n_tiles = (N + kTile - 1) / kTile;
  if (n_tiles > 0) {
    tile_counts_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
        mask, N, offsets);
  }
  scan_tiles_kernel<<<1, kScanThreads, 0, stream>>>(offsets, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// out_idx and out_payload may each be null; payload is read only when
// out_payload is given.
KMD_API int kmd_compact_scatter(const uint8_t* mask, long long N,
                                const int64_t* offsets, const int64_t* payload,
                                int64_t* out_idx, int64_t* out_payload,
                                cudaStream_t stream) {
  long long n_tiles = (N + kTile - 1) / kTile;
  if (n_tiles > 0) {
    scatter_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
        mask, N, offsets, payload, out_idx, out_payload);
  }
  return static_cast<int>(cudaGetLastError());
}
