// K-ASM: assemble one merge chunk from slices of the resident sample streams.
//
// Replaces kmdiff_tpu/pipeline/fused.py::_assemble_chunk_impl (fused.py:387)
// in its packed modes (p16, p32) and its "full" mode (fused.py:414-420, p32
// counts plus each row's sample id, for popstrat's count and geno rows and
// --save-sk): every stream s contributes rows [start_s, start_s + len_s) of
// its sorted int64 keys and u32 counts; the chunk is their concatenation in
// stream order, each count packed with its stream's control flag (streams
// below nb_controls are controls), the packing of run_bounds.cu's merge
// forms (and of kmdiff_tpu_torch/ops/merge_dev.py::build_triples_packed):
//   count_bytes == 2: u16, count in bits 0..14, control flag in bit 15
//   count_bytes == 4: i32, count in bits 0..30, control flag in the sign bit
// With out_sample, each row's stream index s is written beside it as u16.
//
// The TPU form is gone: no fixed [S, M] slice per stream (dynamic_slice with a
// sentinel-padded blob so it never clamps), no sentinel fill of the unused
// slots, no pad rows for the sort to carry. The chunk holds exactly the sum of
// the slice lengths; a stream with len 0 contributes nothing.
//
// Inputs, all on the device: streams [S, 2] int64 (each stream's keys and
// counts pointers), starts [S] int64 (the slice starts) and offsets [S + 1]
// int64 (the output offset of each slice, an exclusive prefix sum of the
// lengths; offsets[S] = N). pipeline/fused.py uploads them for every chunk
// of a merge at once, so a chunk's launch ships nothing.
//
// Bound on the H100: device memory. A row reads 8 + 4 bytes and writes 8 + 2
// (or 4, and 2 more with sample ids). The design:
//   - a 1-D grid over output tiles of 2048 rows, so no block idles on a
//     short stream and the output, contiguous across the stream boundaries,
//     is cut into tiles that start on 16-byte boundaries
//   - one thread of the block finds the first stream that covers the tile
//     by a binary search over the offsets; every thread then walks its 8
//     rows' streams forward (a tile is covered by one to three streams at
//     the merge's shapes) and issues all 8 key and count loads before using
//     any; consecutive threads read consecutive rows of a slice, so the
//     loads are coalesced at any slice alignment
//   - the packed rows are staged in shared memory, and the tile is stored
//     as aligned 16-byte vectors: 2 keys, 8 u16 or 4 u32 counts, 8 sample
//     ids (the last tile's ragged tail by elements)
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;                // rows a block; 16-byte aligned tiles
constexpr int kPerThread = kTile / kThreads;

struct Stream {
  const int64_t* keys;
  const uint32_t* counts;
};
static_assert(sizeof(Stream) == 16, "one table row is two int64");

// dst is 16-byte aligned; n <= kTile elements of src, staged in shared memory
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const T* src, int n) {
  constexpr int kPerVector = 16 / sizeof(T);
  const int nv = n / kPerVector;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  }
  for (int i = nv * kPerVector + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <typename Packed>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const Stream* __restrict__ streams, const int64_t* __restrict__ starts,
                const int64_t* __restrict__ offsets, int S, int nb_controls,
                long long N, int64_t* __restrict__ out_keys,
                Packed* __restrict__ out_counts, uint16_t* __restrict__ out_sample) {
  __shared__ __align__(16) int64_t keys_sm[kTile];
  __shared__ __align__(16) Packed counts_sm[kTile];
  __shared__ __align__(16) uint16_t sample_sm[kTile];
  __shared__ int first;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const int n = static_cast<int>(min(static_cast<long long>(kTile), N - t0));

  if (threadIdx.x == 0) {  // the first stream whose slice ends past t0
    int lo = 0;
    int hi = S - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (__ldg(offsets + mid + 1) > t0) hi = mid; else lo = mid + 1;
    }
    first = lo;
  }
  __syncthreads();

  int s = first;
  int sid[kPerThread];
  long long src[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    sid[k] = -1;
    if (i < n) {
      const long long r = t0 + i;
      while (__ldg(offsets + s + 1) <= r) ++s;
      sid[k] = s;
      src[k] = __ldg(starts + s) + (r - __ldg(offsets + s));
    }
  }
  int64_t key[kPerThread];
  uint32_t cnt[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (sid[k] >= 0) {
      const Stream st = streams[sid[k]];
      key[k] = __ldg(st.keys + src[k]);
      cnt[k] = __ldg(st.counts + src[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (sid[k] < 0) continue;
    const bool control = sid[k] < nb_controls;
    keys_sm[i] = key[k];
    if (sizeof(Packed) == 2) {
      counts_sm[i] = static_cast<Packed>((cnt[k] & 0xFFFFu) | (control ? 0x8000u : 0u));
    } else {
      counts_sm[i] = static_cast<Packed>(cnt[k] | (control ? 0x80000000u : 0u));
    }
    if (out_sample != nullptr) sample_sm[i] = static_cast<uint16_t>(sid[k]);
  }
  __syncthreads();

  store_tile(out_keys + t0, keys_sm, n);
  store_tile(out_counts + t0, counts_sm, n);
  if (out_sample != nullptr) store_tile(out_sample + t0, sample_sm, n);
}

}  // namespace

KMD_API long long kmd_assemble_chunk_tile_rows(void) { return kTile; }

// streams [S, 2], starts [S], offsets [S + 1] as the header says, all on
// the device; N = offsets[S] > 0 rows; out_keys, out_counts and out_sample
// (or null) with N rows each, 16-byte aligned.
KMD_API int kmd_assemble_chunk(const int64_t* streams, const int64_t* starts,
                               const int64_t* offsets, int S, int nb_controls,
                               long long N, int count_bytes, int64_t* out_keys,
                               void* out_counts, uint16_t* out_sample,
                               cudaStream_t stream) {
  if (count_bytes != 2 && count_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S > 65535 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = kmd::grid_for(N, kTile);
  const Stream* table = reinterpret_cast<const Stream*>(streams);
  if (count_bytes == 2) {
    assemble_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
        table, starts, offsets, S, nb_controls, N, out_keys,
        static_cast<uint16_t*>(out_counts), out_sample);
  } else {
    assemble_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
        table, starts, offsets, S, nb_controls, N, out_keys,
        static_cast<uint32_t*>(out_counts), out_sample);
  }
  return static_cast<int>(cudaGetLastError());
}

// K-ASM, multi-word form (k > 32): each stream's keys are [nw, U_s] int64,
// word-major with row stride U_s, and the chunk's keys [nw, N] likewise
// (row stride N); the counts, their packing and the sample ids are the
// one-word form's. The table's rows are three int64: keys and counts
// pointers and the keys' row stride. A simple form: a 1-D grid over tiles
// of 1024 output rows, 4 a thread; the block's first stream found as in the
// one-word form, then each thread walks forward to its rows' streams and
// copies the nw words, the count and the sample id of each: consecutive
// threads read consecutive rows of a slice and write consecutive rows of
// the chunk, one word row at a time (coalesced), with no staging.
namespace {

constexpr int kMwTile = 1024;
constexpr int kMwPerThread = kMwTile / kThreads;

struct StreamMw {
  const int64_t* keys;
  const uint32_t* counts;
  long long ld;
};
static_assert(sizeof(StreamMw) == 24, "one table row is three int64");

template <typename Packed, int NW>
__global__ void __launch_bounds__(kThreads)
assemble_mw_kernel(const StreamMw* __restrict__ streams, const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ offsets, int S, int nb_controls,
                   long long N, int64_t* __restrict__ out_keys,
                   Packed* __restrict__ out_counts, uint16_t* __restrict__ out_sample) {
  __shared__ int first;
  const long long t0 = static_cast<long long>(blockIdx.x) * kMwTile;
  if (threadIdx.x == 0) {
    int lo = 0;
    int hi = S - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (__ldg(offsets + mid + 1) > t0) hi = mid; else lo = mid + 1;
    }
    first = lo;
  }
  __syncthreads();
  int s = first;
#pragma unroll
  for (int j = 0; j < kMwPerThread; ++j) {
    const long long r = t0 + threadIdx.x + j * kThreads;
    if (r >= N) break;
    while (__ldg(offsets + s + 1) <= r) ++s;
    const StreamMw st = streams[s];
    const long long src = __ldg(starts + s) + (r - __ldg(offsets + s));
    int64_t key[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) key[w] = __ldg(st.keys + w * st.ld + src);
    const uint32_t cnt = __ldg(st.counts + src);
    const bool control = s < nb_controls;
#pragma unroll
    for (int w = 0; w < NW; ++w) out_keys[w * N + r] = key[w];
    if (sizeof(Packed) == 2) {
      out_counts[r] = static_cast<Packed>((cnt & 0xFFFFu) | (control ? 0x8000u : 0u));
    } else {
      out_counts[r] = static_cast<Packed>(cnt | (control ? 0x80000000u : 0u));
    }
    if (out_sample != nullptr) out_sample[r] = static_cast<uint16_t>(s);
  }
}

template <typename Packed>
void launch_mw(int nw, unsigned grid, cudaStream_t stream, const StreamMw* table,
               const int64_t* starts, const int64_t* offsets, int S, int nb_controls,
               long long N, int64_t* out_keys, void* out_counts, uint16_t* out_sample) {
  Packed* counts = static_cast<Packed*>(out_counts);
  switch (nw) {
    case 2:
      assemble_mw_kernel<Packed, 2><<<grid, kThreads, 0, stream>>>(
          table, starts, offsets, S, nb_controls, N, out_keys, counts, out_sample);
      break;
    case 3:
      assemble_mw_kernel<Packed, 3><<<grid, kThreads, 0, stream>>>(
          table, starts, offsets, S, nb_controls, N, out_keys, counts, out_sample);
      break;
    default:
      assemble_mw_kernel<Packed, 4><<<grid, kThreads, 0, stream>>>(
          table, starts, offsets, S, nb_controls, N, out_keys, counts, out_sample);
  }
}

}  // namespace

// streams [S, 3] (keys pointer, counts pointer, keys row stride), starts
// [S], offsets [S + 1] as in kmd_assemble_chunk, on the device; 2 <= nw <= 4;
// out_keys [nw, N] contiguous, out_counts [N], out_sample [N] or null.
KMD_API int kmd_assemble_chunk_mw(const int64_t* streams, const int64_t* starts,
                                  const int64_t* offsets, int S, int nb_controls,
                                  long long N, int count_bytes, int nw,
                                  int64_t* out_keys, void* out_counts,
                                  uint16_t* out_sample, cudaStream_t stream) {
  if (count_bytes != 2 && count_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S > 65535 || N <= 0 || nw < 2 || nw > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = kmd::grid_for(N, kMwTile);
  const StreamMw* table = reinterpret_cast<const StreamMw*>(streams);
  if (count_bytes == 2) {
    launch_mw<uint16_t>(nw, grid, stream, table, starts, offsets, S, nb_controls, N,
                        out_keys, out_counts, out_sample);
  } else {
    launch_mw<uint32_t>(nw, grid, stream, table, starts, offsets, S, nb_controls, N,
                        out_keys, out_counts, out_sample);
  }
  return static_cast<int>(cudaGetLastError());
}
