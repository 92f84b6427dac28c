// K-CMP: ordered stream compaction in one pass over the mask.
//
// Given mask [N] (bool, one byte each) it writes the ascending indices of the
// set rows, optionally an int64 payload gathered at those rows, and their
// count. This is the contract of kmdiff_tpu/ops/merge_dev.py::
// _compact_indices (jnp.nonzero with a size) and of the compaction sort at
// kmdiff_tpu/ops/codec.py:435-454, without their TPU forms: no second
// all-keys sort, no fixed output budget, no overflow retry.
//
// One kernel; a block owns one tile of 8192 rows (512 threads x 16 rows):
//   1. each thread loads its 16 mask bytes as one 16-byte vector on the
//      read-only path and turns them into a bitmap of set rows in
//      registers (byte compare, then popc for its count)
//   2. a block scan (warp shuffles, then the 16 warp totals) ranks every
//      thread in the tile; the tile's set rows are staged in order in
//      shared memory as 16-bit tile offsets, and every thread issues the
//      payload loads of its first 8 outputs, which need no output offset
//   3. decoupled look-back for the tile's output offset (kmd_lookback.cuh,
//      shared with K-RUN): the block takes its tile id from an atomic
//      counter, publishes its count, and warp 0 sums its predecessors'
//      counts back to the nearest published prefix
//   4. consecutive threads write consecutive outputs, so the index and
//      payload stores are contiguous; the payload reads follow the set
//      rows (contiguous in a dense tile, only the set rows in a sparse one)
// The last tile writes the total straight into page-locked host memory.
// Tiles start at the 16-byte boundary at or below mask, so a view at any
// byte offset is read with aligned vector loads; the bytes before row 0 and
// after row N-1 that these loads take are masked off (each lies in the
// 16-byte chunk of a real row, so no load leaves the mask's pages).
//
// Scratch: int64 [1 + n_tiles], n_tiles = ceil((N + (mask & 15)) / 8192),
// zeroed here with cudaMemsetAsync: the tile counter, then one status word
// per tile. The wrapper allocates the outputs with N rows and calls
// kmd_compact once: one memset, one kernel and one host sync a call.
//
// Bound on the H100: device memory. The floor is one read of the mask (N
// bytes) plus 8 bytes a kept row for the index, and 16 more with a payload
// (its read and its write). On an H100 SXM at 700 W the kernel takes ~85 us
// for 2^23 rows, 98% set, with a payload: ~72% of the card's 3.35 TB/s over
// that floor (PERF.md).
#include "kmd_lookback.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                // rows a thread: one 16-byte load
constexpr int kTile = kThreads * kRows;  // 8192: a tile offset fits 16 bits
constexpr int kUnroll = 8;               // payload loads in flight a thread

// Bit j set where byte j of w is non-zero: the compare leaves 0x01 in each
// such byte, and the multiply gathers the four bytes' low bits into bits
// 24-27 without carries.
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned chunk_bits(uint4 v) {
  return byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
         byte_bits(v.w) << 12;
}

// chunks: the mask from its 16-byte boundary; aligned row a is mask row
// a - lead and is real for lead <= a < end (end = N + lead).
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint4* __restrict__ chunks, long long n_chunks, int lead,
               long long end, int n_tiles, const int64_t* __restrict__ payload,
               int64_t* __restrict__ out_idx, int64_t* __restrict__ out_payload,
               unsigned long long* scratch, long long* n_set) {
  __shared__ uint16_t rows[kTile];
  __shared__ int warp_total[kWarps];
  __shared__ int tile_id;
  __shared__ long long tile_offset;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) tile_id = kmd::lookback::take_tile(scratch);
  __syncthreads();
  const int t = tile_id;

  // 1. this thread's 16 rows as a bitmap
  const long long c = static_cast<long long>(t) * kThreads + threadIdx.x;
  unsigned bits = c < n_chunks ? chunk_bits(__ldg(chunks + c)) : 0u;
  const long long a0 = 16 * c;
  if (a0 < lead) bits &= ~0u << lead;
  const long long rem = end - a0;
  if (rem < kRows) bits &= rem > 0 ? (1u << rem) - 1u : 0u;

  // 2. rank in the tile, stage the rows, start the first payload loads
  const int count = __popc(bits);
  int incl = count;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int rank = incl - count;
  int aggregate = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int v = warp_total[w];
    if (w < warp) rank += v;
    aggregate += v;
  }
  if (threadIdx.x == 0) kmd::lookback::publish(scratch, t, aggregate);
  for (unsigned b = bits; b; b &= b - 1) {
    rows[rank++] = static_cast<uint16_t>(threadIdx.x * kRows + __ffs(b) - 1);
  }
  __syncthreads();

  const long long row0 = static_cast<long long>(t) * kTile - lead;
  const long long* payload_ll = reinterpret_cast<const long long*>(payload);
  long long r[kUnroll];
  long long v[kUnroll];
  auto load_batch = [&](int p0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      r[u] = p < aggregate ? row0 + rows[p] : 0;
      if (out_payload && p < aggregate) v[u] = __ldg(payload_ll + r[u]);
    }
  };
  load_batch(threadIdx.x);

  // 3. look-back (warp 0)
  if (warp == 0) {
    const long long exclusive =
        kmd::lookback::exclusive_prefix(scratch, t, aggregate, lane);
    if (lane == 0) {
      tile_offset = exclusive;
      if (t == n_tiles - 1) *n_set = exclusive + aggregate;
    }
  }
  __syncthreads();

  // 4. write the tile's rows at its offset
  int64_t* idx = out_idx + tile_offset;
  int64_t* out = out_payload ? out_payload + tile_offset : nullptr;
  for (int p0 = threadIdx.x; p0 < aggregate; p0 += kThreads * kUnroll) {
    if (p0 != threadIdx.x) load_batch(p0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads;
      if (p < aggregate) {
        idx[p] = r[u];
        if (out) out[p] = v[u];
      }
    }
  }
}

}  // namespace

KMD_API long long kmd_compact_tile_rows(void) { return kTile; }

// mask [N], N > 0, at any byte offset; payload [N] or null (then
// out_payload is null too); out_idx and out_payload with room for N rows;
// scratch as the header says; n_set: page-locked host memory
// (cudaHostAlloc, as torch's pin_memory allocates it), which the kernel
// writes through the same pointer under unified addressing. Unlike the
// other entry points this one waits for its kernel, so that *n_set holds
// the number of set rows when it returns: the one host sync of a call.
KMD_API int kmd_compact(const uint8_t* mask, long long N, const int64_t* payload,
                        int64_t* out_idx, int64_t* out_payload, int64_t* scratch,
                        long long* n_set, cudaStream_t stream) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(mask) & 15);
  const long long end = N + lead;
  const long long n_tiles = (end + kTile - 1) / kTile;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + n_tiles) * sizeof(int64_t), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  compact_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(mask - lead), (end + 15) / 16, lead, end,
      static_cast<int>(n_tiles), payload, out_idx, out_payload,
      reinterpret_cast<unsigned long long*>(scratch), n_set);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return static_cast<int>(e);
}
