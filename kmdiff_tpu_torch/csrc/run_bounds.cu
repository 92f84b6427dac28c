// K-RUN: one pass from sorted int64 keys to their runs of equal keys.
//
// Replaces the run-length half of kmdiff_tpu/ops/codec.py::sort_rle_core
// (codec.py:341, :377-395: run starts, per-run lengths) and the segment sums
// of kmdiff_tpu/ops/merge_dev.py::merge_lrt_local's packed branch
// (merge_dev.py:75, :182-263: per-run control and case sums) and its full
// branch with the wide sums (merge_dev.py:230-257, :275-286). One entry
// point, kmd_run_encode, one launch, in one of four forms:
//   dedup   starts [U] int64, run_keys [U] int64, n_valid [1] int64
//           (starts only where the caller passes them: sort_rle and the
//           packed merge need none)
//   count   the same and lengths [U] int32 (next start, or the end of the
//           sentinel-free rows, minus start)
//   merge   the same and sums [U, 2] int32: each run's control and case sums
//           of the packed counts of its rows, row r's count being
//           counts[perm[r]] (the sort's permutation); the packing is
//           merge_dev.py::build_triples_packed's:
//             merge16: u16, count in bits 0..14, control flag in bit 15
//             merge32: i32, count in bits 0..30, control flag in the sign bit
//   full    the same but sums [U, 2] int64, of raw u32 counts (int32 holding
//           u32, merge_dev.py::build_triples's), a row being a control where
//           its sample id, sample[perm[r]] (u16), is below nb_controls: the
//           JAX package's full branch, exact at any cohort mass (its TPU
//           form summed each count's 16-bit halves apart; the H100 adds
//           int64 natively)
// and U, the number of runs, into page-locked host memory. n_valid is the
// number of rows before the sentinel tail (N without one).
//
// The TPU forms are gone: no reverse cummin to carry run ends back, no
// all-keys sort that drags the counts as extra keys, no second compaction
// sort. On the GPU the sort carries a permutation and the sums read the
// counts through it.
//
// Bound on the H100: device memory. The floor reads the keys once (8N
// bytes; the merge form also 8N of permutation and 2N or 4N of counts, the
// full form 4N of counts and 2N of sample ids) and writes 8 bytes a run
// (its key), 8 more where starts are asked for, and 4 (lengths), 8 (sums)
// or 16 (full sums). The design keeps
// every intermediate out of device memory:
//   1. a block owns a tile of 2048 rows, 8 rounds of 256 threads (1024
//      rows, 4 rounds, in the merge and full forms, whose permutation reads
//      and count gathers double a row's registers); round j reads rows
//      j*256 .. j*256+255 of the tile, 8 bytes a lane, so every
//      load of a warp is one contiguous 256-byte line; all the rounds'
//      loads (and the merge form's permutation reads, then their count
//      gathers) are issued before any is used. A row's predecessor comes
//      from the next lane down by a shuffle (lane 0 reads it: the key just
//      before the warp's rows, from the line its neighbour just fetched)
//   2. a row is a boundary where its key differs from its predecessor's: a
//      run start, or the first row of the sentinel tail. The boundaries
//      stay in registers as one warp ballot a round; a scan over the
//      (round, warp) counts ranks them, and their tile offsets and keys are
//      staged in order in shared memory, so a run's end is the next staged
//      boundary. The merge forms add each row's count into its run's slot
//      in shared memory (shared atomics, exact in int32; int64 in the full
//      form)
//   3. decoupled look-back (kmd_lookback.cuh, shared with K-CMP) gives the
//      tile its output offset, while a second warp finishes the tile's last
//      run if it crosses the tile's edge: the count form by one thread's
//      galloping and then binary search for the first different key (a
//      count run may hold 10^5 copies of one repeat k-mer; no thread walks
//      it), the merge form by the warp reading 32 rows a step (a merge run
//      holds at most one row a stream, so that is at most S rows). Rows
//      before a tile's first boundary belong to an earlier tile's run
//   4. consecutive threads write consecutive runs from shared memory:
//      starts, run_keys and lengths or sums are each one contiguous store
//      stream, and no store waits on a load from device memory
// The thread that holds the first sentinel row writes n_valid (without a
// sentinel tail, the one that holds row N - 1); the last tile writes U.
//
// Scratch: int64 [1 + n_tiles], n_tiles = ceil(N / tile rows), zeroed here
// with cudaMemsetAsync. One memset, one kernel and one host sync a call.
#include "kmd_lookback.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Form { kDedup = 0, kCount = 1, kMerge16 = 2, kMerge32 = 3, kFull = 4 };

// Rows a thread: 8 (a 2048-row tile) in the count and dedup forms, 4 (1024
// rows) in the merge and full forms, whose permutation reads and count gathers
// double a row's registers and whose per-run sums take shared memory.
// Smaller tiles fill the SMs with more blocks (tools/krun_tiles.py, on an
// H100 SXM at 700 W: the count form took 0.1315 ms at 4096-row tiles and
// 0.1135-0.118 ms at 2048, the merge form 0.211 ms at 2048 and 0.175-0.181
// ms at 1024). The scan needs kRounds * kWarps >= 32.
template <int F>
struct Tile {
  static constexpr bool kMerge = F == kMerge16 || F == kMerge32 || F == kFull;
  // a run's sums: int64 in the full form, else int32
  using Sum = typename std::conditional<F == kFull, long long, int32_t>::type;
  static constexpr int kRounds = kMerge ? 4 : 8;
  static constexpr int kRows = kThreads * kRounds;  // a tile offset fits 16 bits
  static constexpr int kSlots = kRounds * kWarps;   // (round, warp) boundary counts
  // The keys and the permutation are read once and the outputs written
  // once; in the merge forms they are loaded and stored evict-first, so
  // that the random count gathers, the one reuse, find the counts in L2.
  static constexpr bool kStreamHints = kMerge;
};

template <bool kHint>
__device__ __forceinline__ long long stream_load(const int64_t* p) {
  const long long* q = reinterpret_cast<const long long*>(p);
  return kHint ? __ldcs(q) : __ldg(q);
}

template <bool kHint, typename T>
__device__ __forceinline__ void stream_store(T* p, T v) {
  if (kHint) __stcs(p, v); else *p = v;
}


// row p's count and control flag: from the packing (merge forms) or raw
// with the sample id (full form)
template <int F>
__device__ __forceinline__ void unpack(const void* counts, const uint16_t* sample,
                                       int nb_controls, long long p,
                                       typename Tile<F>::Sum& v, bool& ctrl) {
  if constexpr (F == kMerge16) {
    const uint16_t c = __ldg(static_cast<const uint16_t*>(counts) + p);
    ctrl = (c & 0x8000u) != 0;
    v = static_cast<int32_t>(c & 0x7FFFu);
  } else if constexpr (F == kMerge32) {
    const int32_t c = __ldg(static_cast<const int32_t*>(counts) + p);
    ctrl = c < 0;
    v = c & 0x7FFFFFFF;
  } else {
    v = __ldg(static_cast<const uint32_t*>(counts) + p);
    ctrl = __ldg(sample + p) < nb_controls;
  }
}

// the first row r >= lo with r >= N or keys[r] != key, given that every
// row in [lo - 1, ...) up to that one holds key and the keys ascend
__device__ long long run_end(const int64_t* keys, long long N, long long lo,
                             int64_t key) {
  long long hi = N;
  for (long long step = 1;; step <<= 1) {
    const long long probe = lo + step - 1;
    if (probe >= N) break;
    if (__ldg(keys + probe) != key) {
      hi = probe;
      break;
    }
    lo = probe + 1;
  }
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) != key) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
run_encode_kernel(const int64_t* __restrict__ keys, long long N,
                  const int64_t* __restrict__ perm, const void* __restrict__ counts,
                  const uint16_t* __restrict__ sample, int nb_controls,
                  int n_tiles, int64_t* __restrict__ starts,
                  int64_t* __restrict__ run_keys, void* __restrict__ third,
                  int64_t* __restrict__ n_valid, unsigned long long* scratch,
                  long long* n_runs) {
  constexpr bool kMerge = Tile<F>::kMerge;
  constexpr int kRounds = Tile<F>::kRounds;
  constexpr int kTile = Tile<F>::kRows;
  constexpr int kSlots = Tile<F>::kSlots;
  constexpr bool kHint = Tile<F>::kStreamHints;
  using Sum = typename Tile<F>::Sum;
  __shared__ uint16_t rows[kTile];    // boundary tile offsets, ascending
  __shared__ int64_t run_key[kTile];  // the key at each boundary
  __shared__ __align__(16) Sum sums[kMerge ? 2 * kTile : 4];
  __shared__ int slot[kSlots + 1];    // counts, then exclusive prefixes
  __shared__ int tile_id;
  __shared__ int sentinel_at;       // tile offset of the first sentinel row
  __shared__ long long tile_offset;
  __shared__ long long last_end;    // count form: the end of the last run
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  if (threadIdx.x == 0) {
    tile_id = kmd::lookback::take_tile(scratch);
    sentinel_at = -1;
  }
  if (kMerge) {  // 16 bytes a store
    int4* z = reinterpret_cast<int4*>(sums);
    constexpr int kVectors = 2 * kTile * static_cast<int>(sizeof(Sum)) / 16;
    for (int i = threadIdx.x; i < kVectors; i += kThreads) z[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const int t = tile_id;
  const long long base = static_cast<long long>(t) * kTile;  // the tile's first row
  const long long row0 = base + threadIdx.x;                 // this thread's in round 0

  // 1. this thread's 16 rows (and, merging, their packed counts)
  int64_t key[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const long long i = row0 + j * kThreads;
    key[j] = i < N ? stream_load<kHint>(keys + i) : kmd::kSentinel;
  }
  Sum val[kRounds];
  unsigned ctrl_bits = 0;
  if (kMerge) {
    long long p[kRounds];
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      const long long i = row0 + j * kThreads;
      p[j] = i < N ? stream_load<kHint>(perm + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      bool c = false;
      val[j] = 0;
      if (p[j] >= 0) unpack<F>(counts, sample, nb_controls, p[j], val[j], c);
      ctrl_bits |= static_cast<unsigned>(c) << j;
    }
  }

  // 2. boundaries: one ballot a round, counted by (round, warp)
  unsigned ballot[kRounds];
  unsigned valid_bits = 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const long long i = row0 + j * kThreads;
    long long prev = __shfl_up_sync(0xffffffffu, static_cast<long long>(key[j]), 1);
    if (lane == 0 && i > 0 && i <= N) prev = __ldg(keys + i - 1);
    const bool real = i < N;
    const bool valid = real && key[j] != kmd::kSentinel;
    const bool boundary = real && (i == 0 || key[j] != prev);
    valid_bits |= static_cast<unsigned>(valid) << j;
    ballot[j] = __ballot_sync(0xffffffffu, boundary);
    if (boundary && !valid) {
      sentinel_at = static_cast<int>(i - base);
      *n_valid = i;
    } else if (valid && i == N - 1) {
      *n_valid = N;
    }
    if (lane == 0) slot[j * kWarps + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 128 slot counts, 4 a lane
    int c[kSlots / 32];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kSlots / 32; ++k) {
      c[k] = slot[lane * (kSlots / 32) + k];
      sum += c[k];
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < kSlots / 32; ++k) {
      slot[lane * (kSlots / 32) + k] = run;
      run += c[k];
    }
    if (lane == 31) slot[kSlots] = incl;
  }
  __syncthreads();
  const int n_bound = slot[kSlots];
  const int aggregate = n_bound - (sentinel_at >= 0 ? 1 : 0);  // runs started here
  if (threadIdx.x == 0) kmd::lookback::publish(scratch, t, aggregate);
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const unsigned b = ballot[j];
    const int before = slot[j * kWarps + warp] + __popc(b & lt);
    if ((b >> lane) & 1u) {
      rows[before] = static_cast<uint16_t>(j * kThreads + threadIdx.x);
      run_key[before] = key[j];
    }
    // a valid row's run is the last boundary at or before it
    const int r = before + static_cast<int>((b >> lane) & 1u) - 1;
    if (kMerge && ((valid_bits >> j) & 1u) && r >= 0) {
      Sum* slot_sum = &sums[2 * r + (((ctrl_bits >> j) & 1u) ? 0 : 1)];
      if constexpr (F == kFull) {
        atomicAdd(reinterpret_cast<unsigned long long*>(slot_sum),
                  static_cast<unsigned long long>(val[j]));
      } else {
        atomicAdd(slot_sum, val[j]);
      }
    }
  }
  __syncthreads();

  // 3. the tile's output offset (warp 0) and its last run's end (warp 1)
  if (warp == 0) {
    const long long exclusive =
        kmd::lookback::exclusive_prefix(scratch, t, aggregate, lane);
    if (lane == 0) {
      tile_offset = exclusive;
      if (t == n_tiles - 1) *n_runs = exclusive + aggregate;
    }
  } else if (warp == 1 && F != kDedup && aggregate > 0 && aggregate == n_bound) {
    // the last run ends at no boundary in this tile: it may cross the edge
    const long long edge = min(base + kTile, N);
    const int64_t last = run_key[aggregate - 1];
    if (F == kCount) {
      if (lane == 0) last_end = run_end(keys, N, edge, last);
    } else {
      Sum s_c = 0;
      Sum s_k = 0;
      for (long long r0 = edge;; r0 += 32) {
        const long long r = r0 + lane;
        const bool in = r < N && __ldg(keys + r) == last;
        if (in) {
          Sum v;
          bool c;
          unpack<F>(counts, sample, nb_controls, __ldg(perm + r), v, c);
          if (c) s_c += v; else s_k += v;
        }
        if (__ballot_sync(0xffffffffu, in) != 0xffffffffu) break;
      }
      for (int o = 16; o > 0; o >>= 1) {
        s_c += __shfl_xor_sync(0xffffffffu, s_c, o);
        s_k += __shfl_xor_sync(0xffffffffu, s_k, o);
      }
      if (lane == 0) {
        sums[2 * (aggregate - 1)] += s_c;
        sums[2 * (aggregate - 1) + 1] += s_k;
      }
    }
  }
  __syncthreads();

  // 4. the tile's runs at its offset, all from shared memory
#pragma unroll 4
  for (int p = threadIdx.x; p < aggregate; p += kThreads) {
    const long long r = base + rows[p];
    const long long o = tile_offset + p;
    if (starts != nullptr) stream_store<kHint>(reinterpret_cast<long long*>(starts) + o, r);
    stream_store<kHint>(reinterpret_cast<long long*>(run_keys) + o,
                 static_cast<long long>(run_key[p]));
    if (F == kCount) {
      stream_store<kHint>(static_cast<int32_t*>(third) + o, static_cast<int32_t>(
                                  (p + 1 < n_bound ? base + rows[p + 1] : last_end) - r));
    } else if (F == kFull) {  // 16-byte aligned (the entry point checks)
      stream_store<kHint>(static_cast<longlong2*>(third) + o,
                          reinterpret_cast<const longlong2*>(sums)[p]);
    } else if (kMerge) {
      stream_store<kHint>(static_cast<int2*>(third) + o, reinterpret_cast<const int2*>(sums)[p]);
    }
  }
}

struct Args {
  const int64_t* keys;
  long long N;
  const int64_t* perm;
  const void* counts;
  const uint16_t* sample;
  int nb_controls;
  int n_tiles;
  int64_t* starts;
  int64_t* run_keys;
  void* third;
  int64_t* n_valid;
  int64_t* scratch;
  long long* n_runs;
};

template <int F>
void launch(const Args& a, cudaStream_t stream) {
  run_encode_kernel<F><<<static_cast<unsigned>(a.n_tiles), kThreads, 0, stream>>>(
      a.keys, a.N, a.perm, a.counts, a.sample, a.nb_controls, a.n_tiles, a.starts,
      a.run_keys, a.third, a.n_valid, reinterpret_cast<unsigned long long*>(a.scratch),
      a.n_runs);
}

}  // namespace

// rows a tile in the given form
KMD_API long long kmd_run_encode_tile_rows(int form) {
  return form == kDedup || form == kCount ? Tile<kCount>::kRows : Tile<kMerge16>::kRows;
}

// keys [N] int64 ascending, N > 0, 8-byte aligned; form 0 dedup, 1 count,
// 2 merge16, 3 merge32, 4 full; perm [N] and counts [N] for the merge and
// full forms (else null); sample [N] (u16) and nb_controls for the full form
// (else null and 0); starts (or null, to write none) and run_keys with room
// for N rows; third: lengths [N] int32 (count), sums [N, 2] int32 (merge),
// sums [N, 2] int64, 16-byte aligned (full), or null (dedup); n_valid [1];
// scratch as the header says; n_runs: page-locked host memory, written by the
// kernel through the same pointer under unified addressing. Like K-CMP's
// entry point this one waits for its kernel, so that *n_runs holds U when
// it returns: the one host sync of a call.
KMD_API int kmd_run_encode(const int64_t* keys, long long N, int form,
                           const int64_t* perm, const void* counts,
                           const uint16_t* sample, int nb_controls,
                           int64_t* starts, int64_t* run_keys, void* third,
                           int64_t* n_valid, int64_t* scratch, long long* n_runs,
                           cudaStream_t stream) {
  if (N <= 0 || form < kDedup || form > kFull ||
      (form == kFull && (sample == nullptr ||
                         reinterpret_cast<unsigned long long>(third) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tile = kmd_run_encode_tile_rows(form);
  const long long n_tiles = (N + tile - 1) / tile;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + n_tiles) * sizeof(int64_t), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{keys, N, perm, counts, sample, nb_controls, static_cast<int>(n_tiles),
               starts, run_keys, third, n_valid, scratch, n_runs};
  switch (form) {
    case kDedup: launch<kDedup>(a, stream); break;
    case kCount: launch<kCount>(a, stream); break;
    case kMerge16: launch<kMerge16>(a, stream); break;
    case kMerge32: launch<kMerge32>(a, stream); break;
    default: launch<kFull>(a, stream);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// K-RUN, multi-word form (k > 32): sorted keys [nw, N] int64, word-major
// (row w holds word w of every row, row stride ld), rows in lexicographic
// order over the words; a sentinel row has every word INT64_MAX. A row starts
// a run where any word differs from the previous row's. The five forms, their
// outputs and the one memset, one launch and one host sync a call are the
// one-word kernel's; the run keys come out as [nw, U], row w at run_keys +
// w * out_ld (out_ld >= U: the wrapper's buffer has room for N runs).
//
// A simple form of the one-word design: a block owns a tile of 1024 rows (4
// rounds of 256 threads) in every form, each row's nw words in registers
// and its predecessor's by shuffles (lane 0 reads them); one ballot a round;
// the (round, warp) counts scanned by one warp; the boundaries' tile offsets
// staged in shared memory, not their keys: a run's key words are read back
// from device memory (L2) where the run is written. The last run of a tile
// is finished past the tile's edge as in the one-word kernel, its key read
// at its start row.
namespace {

constexpr int kMwRounds = 4;
constexpr int kMwTile = kThreads * kMwRounds;
constexpr int kMwSlots = kMwRounds * kWarps;
static_assert(kMwSlots == 32, "one slot a lane in the scan");

template <int NW>
__device__ __forceinline__ bool row_is(const int64_t* keys, long long ld, long long r,
                                       const int64_t (&key)[NW]) {
  bool same = true;
#pragma unroll
  for (int w = 0; w < NW; ++w) same = same && __ldg(keys + w * ld + r) == key[w];
  return same;
}

// run_end over rows of nw words
template <int NW>
__device__ long long run_end_mw(const int64_t* keys, long long ld, long long N,
                                long long lo, const int64_t (&key)[NW]) {
  long long hi = N;
  for (long long step = 1;; step <<= 1) {
    const long long probe = lo + step - 1;
    if (probe >= N) break;
    if (!row_is<NW>(keys, ld, probe, key)) {
      hi = probe;
      break;
    }
    lo = probe + 1;
  }
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (!row_is<NW>(keys, ld, mid, key)) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <int F, int NW>
__global__ void __launch_bounds__(kThreads)
run_encode_mw_kernel(const int64_t* __restrict__ keys, long long ld, long long N,
                     const int64_t* __restrict__ perm, const void* __restrict__ counts,
                     const uint16_t* __restrict__ sample, int nb_controls, int n_tiles,
                     int64_t* __restrict__ starts, int64_t* __restrict__ run_keys,
                     long long out_ld, void* __restrict__ third,
                     int64_t* __restrict__ n_valid, unsigned long long* scratch,
                     long long* n_runs) {
  constexpr bool kMerge = Tile<F>::kMerge;
  using Sum = typename Tile<F>::Sum;
  __shared__ uint16_t rows[kMwTile];  // boundary tile offsets, ascending
  __shared__ __align__(16) Sum sums[kMerge ? 2 * kMwTile : 4];
  __shared__ int slot[kMwSlots + 1];
  __shared__ int tile_id;
  __shared__ int sentinel_at;
  __shared__ long long tile_offset;
  __shared__ long long last_end;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  if (threadIdx.x == 0) {
    tile_id = kmd::lookback::take_tile(scratch);
    sentinel_at = -1;
  }
  if (kMerge) {
    int4* z = reinterpret_cast<int4*>(sums);
    constexpr int kVectors = 2 * kMwTile * static_cast<int>(sizeof(Sum)) / 16;
    for (int i = threadIdx.x; i < kVectors; i += kThreads) z[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const int t = tile_id;
  const long long base = static_cast<long long>(t) * kMwTile;
  const long long row0 = base + threadIdx.x;

  // 1. this thread's rows (and, merging, their counts)
  int64_t key[kMwRounds][NW];
#pragma unroll
  for (int j = 0; j < kMwRounds; ++j) {
    const long long i = row0 + j * kThreads;
#pragma unroll
    for (int w = 0; w < NW; ++w) key[j][w] = i < N ? __ldg(keys + w * ld + i) : kmd::kSentinel;
  }
  Sum val[kMwRounds];
  unsigned ctrl_bits = 0;
  if (kMerge) {
    long long p[kMwRounds];
#pragma unroll
    for (int j = 0; j < kMwRounds; ++j) {
      const long long i = row0 + j * kThreads;
      p[j] = i < N ? __ldg(perm + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < kMwRounds; ++j) {
      bool c = false;
      val[j] = 0;
      if (p[j] >= 0) unpack<F>(counts, sample, nb_controls, p[j], val[j], c);
      ctrl_bits |= static_cast<unsigned>(c) << j;
    }
  }

  // 2. boundaries: a row differs from its predecessor in any word
  unsigned ballot[kMwRounds];
  unsigned valid_bits = 0;
#pragma unroll
  for (int j = 0; j < kMwRounds; ++j) {
    const long long i = row0 + j * kThreads;
    bool differs = false;
    bool sentinel = true;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      long long prev = __shfl_up_sync(0xffffffffu, static_cast<long long>(key[j][w]), 1);
      if (lane == 0 && i > 0 && i <= N) prev = __ldg(keys + w * ld + i - 1);
      differs = differs || key[j][w] != prev;
      sentinel = sentinel && key[j][w] == kmd::kSentinel;
    }
    const bool real = i < N;
    const bool valid = real && !sentinel;
    const bool boundary = real && (i == 0 || differs);
    valid_bits |= static_cast<unsigned>(valid) << j;
    ballot[j] = __ballot_sync(0xffffffffu, boundary);
    if (boundary && !valid) {
      sentinel_at = static_cast<int>(i - base);
      *n_valid = i;
    } else if (valid && i == N - 1) {
      *n_valid = N;
    }
    if (lane == 0) slot[j * kWarps + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 slot counts, one a lane
    const int c = slot[lane];
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    slot[lane] = incl - c;
    if (lane == 31) slot[kMwSlots] = incl;
  }
  __syncthreads();
  const int n_bound = slot[kMwSlots];
  const int aggregate = n_bound - (sentinel_at >= 0 ? 1 : 0);
  if (threadIdx.x == 0) kmd::lookback::publish(scratch, t, aggregate);
#pragma unroll
  for (int j = 0; j < kMwRounds; ++j) {
    const unsigned b = ballot[j];
    const int before = slot[j * kWarps + warp] + __popc(b & lt);
    if ((b >> lane) & 1u) rows[before] = static_cast<uint16_t>(j * kThreads + threadIdx.x);
    const int r = before + static_cast<int>((b >> lane) & 1u) - 1;
    if (kMerge && ((valid_bits >> j) & 1u) && r >= 0) {
      Sum* slot_sum = &sums[2 * r + (((ctrl_bits >> j) & 1u) ? 0 : 1)];
      if constexpr (F == kFull) {
        atomicAdd(reinterpret_cast<unsigned long long*>(slot_sum),
                  static_cast<unsigned long long>(val[j]));
      } else {
        atomicAdd(slot_sum, val[j]);
      }
    }
  }
  __syncthreads();

  // 3. the tile's output offset (warp 0) and its last run's end (warp 1)
  if (warp == 0) {
    const long long exclusive =
        kmd::lookback::exclusive_prefix(scratch, t, aggregate, lane);
    if (lane == 0) {
      tile_offset = exclusive;
      if (t == n_tiles - 1) *n_runs = exclusive + aggregate;
    }
  } else if (warp == 1 && F != kDedup && aggregate > 0 && aggregate == n_bound) {
    const long long edge = min(base + kMwTile, N);
    const long long at = base + rows[aggregate - 1];
    int64_t last[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) last[w] = __ldg(keys + w * ld + at);
    if (F == kCount) {
      if (lane == 0) last_end = run_end_mw<NW>(keys, ld, N, edge, last);
    } else {
      Sum s_c = 0;
      Sum s_k = 0;
      for (long long r0 = edge;; r0 += 32) {
        const long long r = r0 + lane;
        const bool in = r < N && row_is<NW>(keys, ld, r, last);
        if (in) {
          Sum v;
          bool c;
          unpack<F>(counts, sample, nb_controls, __ldg(perm + r), v, c);
          if (c) s_c += v; else s_k += v;
        }
        if (__ballot_sync(0xffffffffu, in) != 0xffffffffu) break;
      }
      for (int o = 16; o > 0; o >>= 1) {
        s_c += __shfl_xor_sync(0xffffffffu, s_c, o);
        s_k += __shfl_xor_sync(0xffffffffu, s_k, o);
      }
      if (lane == 0) {
        sums[2 * (aggregate - 1)] += s_c;
        sums[2 * (aggregate - 1) + 1] += s_k;
      }
    }
  }
  __syncthreads();

  // 4. the tile's runs at its offset; their key words read at their starts
  for (int p = threadIdx.x; p < aggregate; p += kThreads) {
    const long long r = base + rows[p];
    const long long o = tile_offset + p;
    if (starts != nullptr) starts[o] = r;
#pragma unroll
    for (int w = 0; w < NW; ++w) run_keys[w * out_ld + o] = __ldg(keys + w * ld + r);
    if (F == kCount) {
      static_cast<int32_t*>(third)[o] = static_cast<int32_t>(
          (p + 1 < n_bound ? base + rows[p + 1] : last_end) - r);
    } else if (F == kFull) {
      static_cast<longlong2*>(third)[o] = reinterpret_cast<const longlong2*>(sums)[p];
    } else if (kMerge) {
      static_cast<int2*>(third)[o] = reinterpret_cast<const int2*>(sums)[p];
    }
  }
}

template <int F>
void launch_mw(int nw, const Args& a, long long ld, long long out_ld, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(a.n_tiles);
  auto* sc = reinterpret_cast<unsigned long long*>(a.scratch);
  switch (nw) {
    case 2:
      run_encode_mw_kernel<F, 2><<<grid, kThreads, 0, stream>>>(
          a.keys, ld, a.N, a.perm, a.counts, a.sample, a.nb_controls, a.n_tiles, a.starts,
          a.run_keys, out_ld, a.third, a.n_valid, sc, a.n_runs);
      break;
    case 3:
      run_encode_mw_kernel<F, 3><<<grid, kThreads, 0, stream>>>(
          a.keys, ld, a.N, a.perm, a.counts, a.sample, a.nb_controls, a.n_tiles, a.starts,
          a.run_keys, out_ld, a.third, a.n_valid, sc, a.n_runs);
      break;
    default:
      run_encode_mw_kernel<F, 4><<<grid, kThreads, 0, stream>>>(
          a.keys, ld, a.N, a.perm, a.counts, a.sample, a.nb_controls, a.n_tiles, a.starts,
          a.run_keys, out_ld, a.third, a.n_valid, sc, a.n_runs);
  }
}

}  // namespace

KMD_API long long kmd_run_encode_mw_tile_rows(void) { return kMwTile; }

// keys [nw, N] with row stride ld >= N, 2 <= nw <= 4, rows ascending
// lexicographically; run_keys [nw, out_ld] with out_ld >= N; every other
// argument as kmd_run_encode's (scratch: 1 + ceil(N / 1024) words).
KMD_API int kmd_run_encode_mw(const int64_t* keys, long long ld, long long N, int nw,
                              int form, const int64_t* perm, const void* counts,
                              const uint16_t* sample, int nb_controls, int64_t* starts,
                              int64_t* run_keys, long long out_ld, void* third,
                              int64_t* n_valid, int64_t* scratch, long long* n_runs,
                              cudaStream_t stream) {
  if (N <= 0 || nw < 2 || nw > 4 || ld < N || out_ld < N || form < kDedup ||
      form > kFull ||
      (form == kFull && (sample == nullptr ||
                         reinterpret_cast<unsigned long long>(third) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = (N + kMwTile - 1) / kMwTile;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + n_tiles) * sizeof(int64_t), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{keys, N, perm, counts, sample, nb_controls, static_cast<int>(n_tiles),
               starts, run_keys, third, n_valid, scratch, n_runs};
  switch (form) {
    case kDedup: launch_mw<kDedup>(nw, a, ld, out_ld, stream); break;
    case kCount: launch_mw<kCount>(nw, a, ld, out_ld, stream); break;
    case kMerge16: launch_mw<kMerge16>(nw, a, ld, out_ld, stream); break;
    case kMerge32: launch_mw<kMerge32>(nw, a, ld, out_ld, stream); break;
    default: launch_mw<kFull>(nw, a, ld, out_ld, stream);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return static_cast<int>(e);
}
