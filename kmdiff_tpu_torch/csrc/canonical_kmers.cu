// K-EXT: canonical k-mer keys of every k-window of a 2-bit code stream.
//
// Replaces kmdiff_tpu/ops/codec.py::extract_canonical_lanes (mask_invalid=
// True), the extraction half of fused_count_kernel. Input: codes [N] u8 with
// 0..3 for A,C,T,G and 0xFF (INVALID) between reads and files. Output: keys
// [N-k+1] int64, one per window:
//   * the canonical k-mer (the unsigned min of the forward and the
//     reverse-complement words) packed as core/kmer.py::pack_codes packs it:
//     first base in the highest bits, right-aligned, one u64 word (1 <= k <=
//     32; k=32 fills all 64 bits);
//   * XORed with 1<<63, so that signed int64 order equals the unsigned word
//     order and torch.sort on int64 sorts k-mers as the JAX lanes sort them;
//   * INT64_MAX (the all-ones sentinel) for a window that holds an INVALID
//     code; it sorts last.
//
// The JAX version builds each window as a k-step ladder of shifted vector
// ORs (O(k) passes over the block, fused by XLA). Here the work is O(1) a
// window, and the kernel is built to move its bytes at the card's rate:
//   * rolling windows: a thread owns kRuns consecutive windows. It walks
//     their kRuns + k - 1 codes once, rolling both words a code at a time
//     (fwd = (fwd << 2 | b) & mask, rc = rc >> 2 | (b ^ 2) << 2(k-1)) and
//     keeping the position of the last INVALID code it saw; a window is valid
//     iff that position lies before it. The first window's k steps and the
//     rolling steps are one loop, so an INVALID run that straddles a thread's
//     run, a tile edge or the halo needs no special case: every code of every
//     window a thread emits passes through its own loop. An INVALID code's
//     bits stay in the words until they are shifted out, only in windows that
//     are masked anyway. A full run of a 16-byte-aligned tile (every run but
//     the last, unless the codes are a misaligned view) takes its codes in
//     16-byte shared loads and unrolls its steps; other runs read 32-bit
//     words with bounds checks. kRuns = 32 with 128 threads: on an H100 SXM
//     (kmdiff_tpu_torch/tools/kext_tiles.py, PERF.md section 6) it ties
//     (64, 32) within 2% of device time, while (threads, kRuns) = (256, 16)
//     and (128, 16) take ~20% more and (64, 64) ~5-10% more.
//   * codes in through shared memory with asynchronous copies: a block owns
//     a tile of kTile windows (kThreads x kRuns) and needs kTile + k - 1
//     codes. A persistent grid (a few blocks an SM) walks the tiles; each
//     block double-buffers, issuing the next tile's 16-byte cp.async copies
//     before it computes this one. A codes pointer at any byte offset is
//     taken: the bytes before the first 16-byte boundary of a tile's range
//     and after the last are copied by plain byte loads, so no load leaves
//     [codes, codes + N).
//   * keys out coalesced: a thread's keys are contiguous, so direct stores
//     from a warp would land 8 * kRuns bytes apart. They are staged in shared
//     memory (row stride kRuns + 1 keys, which keeps a half-warp's 8-byte
//     stores on distinct banks) and written back as 16-byte stores by
//     consecutive threads.
//   * no tensor cores: there is no product here.
//
// Bound on the H100: device memory. A window reads 1 byte and writes 8: at
// 2^24 codes, 16.8 MB in and 134.2 MB out, 151 MB at 3.35 TB/s = 45 us. The
// integer work is ~20 operations a window (~20 us at the int32 rate). The
// first form of this kernel rebuilt every window in k steps (~6k integer
// operations a window) and took 0.46-0.50 ms a call, ~10% of the bound; this
// one takes ~0.07 ms of device time at k = 31, ~2/3 of it (PERF.md).
#include <algorithm>

#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRuns = 32;                  // windows a thread
constexpr int kTile = kThreads * kRuns;    // windows a tile
constexpr int kMaxK = 32;
constexpr int kCodeBuf = kTile + 64;       // 15 bytes of alignment pad + halo
constexpr int kKeyStride = kRuns + 1;      // staged keys of one thread
constexpr int kBlocksPerSm = 5;
constexpr uint8_t kInvalid = 0xFF;
constexpr int kSpan = kRuns + kMaxK - 1;    // codes of a full run at k = 32
constexpr int kVecs = (kSpan + 15) / 16;   // its 16-byte loads

static_assert(kTile % 2 == 0, "16-byte key stores take two windows");
static_assert(kCodeBuf % 16 == 0, "cp.async targets 16-byte slots");
static_assert(kTile - kRuns + 16 * kVecs <= kCodeBuf, "a full run's loads stay in the buffer");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared-memory slot of code i of the tile whose codes start at lo: the
// slot keeps code i's address modulo 16, so the 16-byte chunks land on
// 16-byte slots.
__device__ __forceinline__ long long slot_base(const uint8_t* codes, long long lo) {
  return static_cast<long long>((reinterpret_cast<uintptr_t>(codes) + lo) & 15) - lo;
}

// Issue the copies of the codes of the tile starting at window lo into buf.
__device__ void load_tile(uint8_t* buf, const uint8_t* __restrict__ codes,
                          long long N, int k, long long lo) {
  const long long hi = min(N, lo + kTile + k - 1);
  const long long base = slot_base(codes, lo);  // slot of code i: base + i
  const uintptr_t addr = reinterpret_cast<uintptr_t>(codes);
  long long a0 = lo + static_cast<long long>((16 - ((addr + lo) & 15)) & 15);
  long long a1 = hi - static_cast<long long>((addr + hi) & 15);
  if (a0 > hi) a0 = hi;
  if (a1 < a0) a1 = a0;
  for (long long i = lo + threadIdx.x; i < a0; i += kThreads) buf[base + i] = codes[i];
  for (long long i = a1 + threadIdx.x; i < hi; i += kThreads) buf[base + i] = codes[i];
  const long long chunks = (a1 - a0) >> 4;
  for (long long c = threadIdx.x; c < chunks; c += kThreads) {
    const long long i = a0 + (c << 4);
    cp_async16(buf + base + i, codes + i);
  }
}

// The rolling state of one thread: the forward and reverse-complement words
// of the last k codes and the step of the last INVALID code.
struct Roll {
  uint64_t fwd = 0;
  uint64_t rc = 0;
  int last_bad = -kMaxK - 1;

  __device__ __forceinline__ void step(uint32_t c, int s, uint64_t mask, int rc_shift) {
    if (c == kInvalid) last_bad = s;
    const uint64_t v = c & 3u;
    fwd = ((fwd << 2) | v) & mask;
    rc = (rc >> 2) | ((v ^ 2u) << rc_shift);
  }

  // key of the window that ends at step s (the unsigned min, then the flip)
  __device__ __forceinline__ int64_t key(int s, int k) const {
    const uint64_t canon = rc < fwd ? rc : fwd;
    return s - last_bad >= k ? static_cast<int64_t>(canon ^ (1ull << 63))
                             : kmd::kSentinel;
  }
};

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
canonical_kmers_kernel(const uint8_t* __restrict__ codes, long long N, int k,
                       int64_t* __restrict__ keys, long long n_tiles) {
  __shared__ __align__(16) uint8_t code_buf[2][kCodeBuf];
  __shared__ __align__(16) int64_t key_buf[kThreads * kKeyStride];

  const long long W = N - k + 1;
  const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int rc_shift = 2 * (k - 1);
  const bool vec_out = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;

  long long tile = blockIdx.x;
  if (tile < n_tiles) load_tile(code_buf[0], codes, N, k, tile * kTile);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles) load_tile(code_buf[(it + 1) & 1], codes, N, k, next * kTile);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const long long lo = tile * kTile;
    const int n_tile = static_cast<int>(min(static_cast<long long>(kTile), W - lo));
    const uint8_t* buf = code_buf[it & 1];
    const int r0 = threadIdx.x * kRuns;  // first window of this thread, in the tile
    const int n_win = min(kRuns, n_tile - r0);
    if (n_win > 0) {
      // this thread's codes, r0 .. r0 + n_win + k - 2 of the tile
      const int first = static_cast<int>(slot_base(codes, lo) + lo) + r0;
      const int n_steps = n_win + k - 1;
      int64_t* out = key_buf + threadIdx.x * kKeyStride;
      Roll st;
      if (n_win == kRuns && (first & 15) == 0) {
        // a full run of a 16-byte-aligned tile: kVecs 16-byte loads, then
        // kSpan steps unrolled (the ones past n_steps, for k < 32, idle)
        uint4 q[kVecs];
#pragma unroll
        for (int i = 0; i < kVecs; ++i)
          q[i] = reinterpret_cast<const uint4*>(buf + first)[i];
        int64_t* out_m = out - (k - 1);  // key of the window ending at step s
#pragma unroll
        for (int s = 0; s < kSpan; ++s) {
          const uint32_t c = (word_of(q[s / 16], (s % 16) / 4) >> (8 * (s % 4))) & 0xFFu;
          if (s < n_steps) {
            st.step(c, s, mask, rc_shift);
            if (s >= k - 1) out_m[s] = st.key(s, k);
          }
        }
      } else {
        // a ragged run or a misaligned tile: aligned 32-bit words
        const uint32_t* words = reinterpret_cast<const uint32_t*>(buf + (first & ~3));
        int j = -(first & 3);  // step of byte 0 of the current word
        for (int w = 0; j < n_steps; ++w, j += 4) {
          const uint32_t word = words[w];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int s = j + b;
            if (s < 0 || s >= n_steps) continue;
            st.step((word >> (8 * b)) & 0xFFu, s, mask, rc_shift);
            if (s >= k - 1) out[s - (k - 1)] = st.key(s, k);
          }
        }
      }
    }
    __syncthreads();

    int64_t* dst = keys + lo;
    if (vec_out) {
      for (int v = threadIdx.x; v < n_tile / 2; v += kThreads) {
        const int e = 2 * v;  // e and e + 1 belong to one thread (kRuns even)
        const int at = (e / kRuns) * kKeyStride + e % kRuns;
        longlong2 pair;
        pair.x = key_buf[at];
        pair.y = key_buf[at + 1];
        __stcs(reinterpret_cast<longlong2*>(dst) + v, pair);
      }
      if ((n_tile & 1) && threadIdx.x == 0) {
        const int e = n_tile - 1;
        dst[e] = key_buf[(e / kRuns) * kKeyStride + e % kRuns];
      }
    } else {
      for (int e = threadIdx.x; e < n_tile; e += kThreads)
        dst[e] = key_buf[(e / kRuns) * kKeyStride + e % kRuns];
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

KMD_API long long kmd_canonical_kmers_tile_windows() { return kTile; }

KMD_API int kmd_canonical_kmers(const uint8_t* codes, long long N, int k,
                                int64_t* keys, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || N < k) return static_cast<int>(cudaErrorInvalidValue);
  static int n_sms = 0;
  if (n_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long W = N - k + 1;
  const long long n_tiles = (W + kTile - 1) / kTile;
  const long long grid =
      std::min(n_tiles, static_cast<long long>(n_sms) * kBlocksPerSm);
  canonical_kmers_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      codes, N, k, keys, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K-EXT, multi-word form (33 <= k <= 128): the canonical k-mer of every
// window as nw = ceil(k / 32) u64 words, word-major: keys [nw, N-k+1] int64,
// row w holding word w of every window (core/kmer.py::pack_codes: word w
// holds bases 32w .. min(k, 32w + 32) - 1, its first base highest, the last
// word right-aligned in its low bits; kmdiff_tpu/ops/codec.py::_lane_shift),
// each word XORed with 1<<63. The canonical form is the lexicographic min
// over the words (most significant word first) of the forward and the
// reverse-complement k-mer, whose base p is the complement of the window's
// base k-1-p. A window that holds an INVALID code is the sentinel row: every
// word INT64_MAX (no canonical k-mer equals it: it is an all-G k-mer, whose
// reverse complement all-C is smaller; it sorts last).
//
// A simple form: a block of 256 threads owns 256 consecutive windows, copies
// their 256 + k - 1 codes into shared memory, and each thread builds its
// window's forward and reverse-complement words in registers from there,
// k shared-memory reads each, word by word; the words are stored row by row,
// consecutive threads writing consecutive windows (coalesced). Templated on
// nw, so that every word lives in a register.
namespace {

constexpr int kMwThreads = 256;
constexpr int kMwMaxK = 128;

template <int NW>
__global__ void __launch_bounds__(kMwThreads)
canonical_kmers_mw_kernel(const uint8_t* __restrict__ codes, long long N, int k,
                          int64_t* __restrict__ keys) {
  __shared__ uint8_t sm[kMwThreads + kMwMaxK - 1];
  const long long W = N - k + 1;
  const long long lo = static_cast<long long>(blockIdx.x) * kMwThreads;
  const long long hi = min(N, lo + kMwThreads + k - 1);
  for (long long i = lo + threadIdx.x; i < hi; i += kMwThreads) sm[i - lo] = codes[i];
  __syncthreads();
  const long long win = lo + threadIdx.x;
  if (win >= W) return;
  const uint8_t* c = sm + threadIdx.x;
  uint64_t fwd[NW];
  uint64_t rc[NW];
  unsigned bad = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int p1 = min(k, 32 * w + 32);
    uint64_t f = 0;
    uint64_t r = 0;
    for (int p = 32 * w; p < p1; ++p) {
      const unsigned b = c[p];
      bad |= b;
      f = (f << 2) | (b & 3u);
      r = (r << 2) | ((c[k - 1 - p] & 3u) ^ 2u);
    }
    fwd[w] = f;
    rc[w] = r;
  }
  // lexicographic min: the first word that differs decides
  bool take_rc = false;
  bool undecided = true;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    take_rc = take_rc || (undecided && rc[w] < fwd[w]);
    undecided = undecided && rc[w] == fwd[w];
  }
  const bool invalid = (bad & 0x80u) != 0;  // INVALID is 0xFF, codes are 0..3
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint64_t v = take_rc ? rc[w] : fwd[w];
    keys[w * W + win] = invalid ? kmd::kSentinel : static_cast<int64_t>(v ^ (1ull << 63));
  }
}

}  // namespace

// codes [N] u8 at any byte offset, N >= k, 33 <= k <= 128; keys [nw, N-k+1]
// int64, contiguous (row w at keys + w * (N-k+1)).
KMD_API int kmd_canonical_kmers_mw(const uint8_t* codes, long long N, int k,
                                   int64_t* keys, cudaStream_t stream) {
  if (k <= 32 || k > kMwMaxK || N < k) return static_cast<int>(cudaErrorInvalidValue);
  const long long W = N - k + 1;
  const unsigned grid = kmd::grid_for(W, kMwThreads);
  switch ((k + 31) / 32) {
    case 2:
      canonical_kmers_mw_kernel<2><<<grid, kMwThreads, 0, stream>>>(codes, N, k, keys);
      break;
    case 3:
      canonical_kmers_mw_kernel<3><<<grid, kMwThreads, 0, stream>>>(codes, N, k, keys);
      break;
    default:
      canonical_kmers_mw_kernel<4><<<grid, kMwThreads, 0, stream>>>(codes, N, k, keys);
  }
  return static_cast<int>(cudaGetLastError());
}
