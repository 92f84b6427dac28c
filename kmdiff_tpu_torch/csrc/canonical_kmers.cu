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
  static kmd::PerDevice<int> sms_of;  // SMs of each card
  int n_sms = 0;
  const int rc = sms_of.get(
      [](int dev, int* n) {
        return static_cast<int>(
            cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev));
      },
      &n_sms);
  if (rc != 0) return rc;
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
// reverse complement all-C is smaller; it sorts last). Codes are taken at
// any byte offset.
//
// Replaces extract_canonical_lanes (kmdiff_tpu/ops/codec.py:73) at 2-4
// words. The one-word kernel's design, carried over to nw words:
//   * rolling windows: a thread owns kRuns consecutive windows of a tile and
//     keeps its window in registers as nw forward words and nw
//     reverse-complement words in the output layout (the last word
//     right-aligned, r = k - 32(nw-1) bases). A code b rolls in as
//       forward:  word w < nw-1 shifts left by 2 and takes the next word's
//                 first base (word nw-2 takes the last word's, at bit 2r-2);
//                 the last word shifts left, takes b and keeps its 2r bits;
//       reverse:  word 0 shifts right by 2 and takes (b ^ 2) << 62, word
//                 w > 0 takes word w-1's last base (the last word at bit
//                 2r-2),
//     so a window costs one roll, a lexicographic compare (one borrow
//     chain of 32-bit subtractions, least significant word first), a select
//     and the flip. Invalid codes: the position of the last INVALID code,
//     as in the one-word kernel; a window is valid iff it lies before it.
//   * the first window's k - 1 codes roll in four at a time, in a layout
//     whose shifts are all constant: the last 32 nw codes as nw u64 words
//     with the oldest code highest, and their reverse complement with the
//     newest highest (four codes pack into a byte with one multiply each).
//     One conversion then gives the output layout (two-word shifts by
//     2(32 nw - k)). At k = 128 that is 32 steps instead of 127 ahead of a
//     thread's windows. Codes before the thread's first window that roll in
//     with its first 16-byte chunk (and a misaligned tile's leading slots)
//     fall out of the window before it is read, and an INVALID code among
//     them lies before it, so neither needs a special case.
//   * codes in through shared memory: a block owns a tile of kRuns x
//     kMwThreads windows and its tile + k - 1 codes. A persistent grid walks
//     the tiles; each block issues the next tile's 16-byte cp.async copies
//     before it computes this one. A codes pointer at any byte offset is
//     taken: the copies are the aligned 16-byte chunks that meet the tile's
//     span, and only the chunks that the stream's own ends cut are copied
//     byte by byte, so no load leaves [codes, codes + N) and no thread waits
//     on a plain load between tiles. A thread reads its codes as 16-byte
//     shared loads (kRuns is a multiple of 16, so all threads share one
//     alignment and every branch on it is uniform).
//   * keys out coalesced: a thread stages its windows' keys in shared
//     memory, a row per word (stride kRuns + 1 keys, so that 8-byte stores
//     of a half-warp fall on distinct banks); then the block writes each
//     word row of the tile as one contiguous run of 16-byte streaming
//     stores. The tile scales with nw so that the staged keys (nw x 8 bytes
//     a window) stay near 68 KB: kRuns = 32 at nw = 2 (4,096 windows), 16
//     at nw = 3 and 4 (2,048), in dynamic shared memory, three or four
//     blocks an SM. (Writing 8 windows a thread at a time, 64-byte pieces
//     256 bytes apart, cost more than the computing on the card.)
//   * templated on nw, so every word stays in a register.
//
// Bound on the H100: device memory. A window reads 1 code and writes 8 nw
// bytes: at 2^24 codes 285 MB at k = 63 (0.085 ms at 3.35 TB/s) and 554 MB
// at k = 128 (0.165 ms). The integer work is ~15 nw 32-bit instructions a
// window and ~7 a code of the warm-up, below the bytes at every k;
// ptxas's register and spill lines are printed by chip_smoke.py and
// tools/kext_tiles.py.
namespace {

constexpr int kMwThreads = 128;
// windows a thread at nw = 2, 3, 4 (multiples of 16)
constexpr int kMwRuns2 = 32;
constexpr int kMwRuns3 = 16;
constexpr int kMwRuns4 = 16;
constexpr int kMwMaxK = 128;
constexpr unsigned long long kMwSign = 1ull << 63;

template <int NW>
struct MwShape {
  static constexpr int kRuns = NW == 2 ? kMwRuns2 : NW == 3 ? kMwRuns3 : kMwRuns4;
  static constexpr int kTile = kMwThreads * kRuns;      // windows a tile
  static constexpr int kStride = kRuns + 1;              // staged keys of a thread, a row
  static constexpr int kRowKeys = kMwThreads * kStride;  // staged keys of a row
  // a tile's codes, the halo, and up to 15 + 15 bytes of the chunks that
  // hold the span's ends
  static constexpr int kCodeBuf = (kTile + kMwMaxK - 1 + 30 + 15) / 16 * 16;
  static constexpr int kSmem = 2 * kCodeBuf + NW * kRowKeys * 8;
  static_assert(kRuns % 16 == 0, "every thread's codes share one 16-byte alignment");
};

// Issue the copies of codes [c0, c1) into buf, code i at slot
// ((codes + c0) & 15) + i - c0: each aligned 16-byte chunk that meets the
// span and lies in [codes, codes + N) by cp.async, the span's bytes of a
// chunk that the stream's ends cut by plain loads.
__device__ void load_span_mw(uint8_t* buf, const uint8_t* __restrict__ codes,
                             long long N, long long c0, long long c1) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const uintptr_t lo = (base + c0) & ~static_cast<uintptr_t>(15);
  const int n_chunks = static_cast<int>((base + c1 - lo + 15) >> 4);
  for (int j = threadIdx.x; j < n_chunks; j += kMwThreads) {
    const uintptr_t at = lo + 16 * static_cast<uintptr_t>(j);
    if (at >= base && at + 16 <= base + N) {
      cp_async16(buf + 16 * j, reinterpret_cast<const void*>(at));
    } else {
      for (int b = 0; b < 16; ++b) {
        const uintptr_t p = at + b;
        if (p >= base + c0 && p < base + c1)
          buf[16 * j + b] = *reinterpret_cast<const uint8_t*>(p);
      }
    }
  }
}

__device__ __forceinline__ uint32_t lo32(uint64_t x) { return static_cast<uint32_t>(x); }
__device__ __forceinline__ uint32_t hi32(uint64_t x) { return static_cast<uint32_t>(x >> 32); }

// all ones where a < b lexicographically (word 0 most significant): the
// borrow out of a - b, least significant word first
template <int NW>
__device__ __forceinline__ uint32_t words_less(const uint64_t* a, const uint64_t* b);

template <>
__device__ __forceinline__ uint32_t words_less<2>(const uint64_t* a, const uint64_t* b) {
  uint32_t m;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\tsubc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\tsubc.cc.u32 t, %7, %8;\n\t"
      "subc.u32 %0, %9, %9;\n\t}"
      : "=r"(m)
      : "r"(lo32(a[1])), "r"(lo32(b[1])), "r"(hi32(a[1])), "r"(hi32(b[1])),
        "r"(lo32(a[0])), "r"(lo32(b[0])), "r"(hi32(a[0])), "r"(hi32(b[0])), "r"(0u));
  return m;
}

template <>
__device__ __forceinline__ uint32_t words_less<3>(const uint64_t* a, const uint64_t* b) {
  uint32_t m;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\tsubc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\tsubc.cc.u32 t, %7, %8;\n\t"
      "subc.cc.u32 t, %9, %10;\n\tsubc.cc.u32 t, %11, %12;\n\t"
      "subc.u32 %0, %13, %13;\n\t}"
      : "=r"(m)
      : "r"(lo32(a[2])), "r"(lo32(b[2])), "r"(hi32(a[2])), "r"(hi32(b[2])),
        "r"(lo32(a[1])), "r"(lo32(b[1])), "r"(hi32(a[1])), "r"(hi32(b[1])),
        "r"(lo32(a[0])), "r"(lo32(b[0])), "r"(hi32(a[0])), "r"(hi32(b[0])), "r"(0u));
  return m;
}

template <>
__device__ __forceinline__ uint32_t words_less<4>(const uint64_t* a, const uint64_t* b) {
  uint32_t m;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\tsubc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\tsubc.cc.u32 t, %7, %8;\n\t"
      "subc.cc.u32 t, %9, %10;\n\tsubc.cc.u32 t, %11, %12;\n\t"
      "subc.cc.u32 t, %13, %14;\n\tsubc.cc.u32 t, %15, %16;\n\t"
      "subc.u32 %0, %17, %17;\n\t}"
      : "=r"(m)
      : "r"(lo32(a[3])), "r"(lo32(b[3])), "r"(hi32(a[3])), "r"(hi32(b[3])),
        "r"(lo32(a[2])), "r"(lo32(b[2])), "r"(hi32(a[2])), "r"(hi32(b[2])),
        "r"(lo32(a[1])), "r"(lo32(b[1])), "r"(hi32(a[1])), "r"(hi32(b[1])),
        "r"(lo32(a[0])), "r"(lo32(b[0])), "r"(hi32(a[0])), "r"(hi32(b[0])), "r"(0u));
  return m;
}

// The warm-up layout: the last 32 NW codes, oldest highest (f), and their
// reverse complement, newest highest (r).
template <int NW>
struct MwShift {
  uint64_t f[NW];
  uint64_t r[NW];
  int last_bad = -kMwMaxK - 1;

  __device__ __forceinline__ MwShift() {
#pragma unroll
    for (int w = 0; w < NW; ++w) f[w] = r[w] = 0;
  }

  // four codes, the bytes of x in memory order, the first at slot s
  __device__ __forceinline__ void step4(uint32_t x, int s) {
    const uint32_t bad = x & 0x80808080u;  // bit 7: INVALID (0xFF) alone has it
    if (bad) last_bad = s + 3 - (__clz(bad) >> 3);
    const uint32_t b = x & 0x03030303u;
    const uint32_t fw = (b * 0x40100401u) >> 24;                  // first code highest
    const uint32_t rv = ((b ^ 0x02020202u) * 0x01041040u) >> 24;  // last code highest
#pragma unroll
    for (int w = 0; w < NW - 1; ++w) f[w] = (f[w] << 8) | (f[w + 1] >> 56);
    f[NW - 1] = (f[NW - 1] << 8) | fw;
#pragma unroll
    for (int w = NW - 1; w > 0; --w) r[w] = (r[w] >> 8) | (r[w - 1] << 56);
    r[0] = (r[0] >> 8) | (static_cast<uint64_t>(rv) << 56);
  }
};

// The output layout: the window's forward and reverse-complement words.
template <int NW>
struct MwWindow {
  uint64_t fw[NW];
  uint64_t rc[NW];
  int last_bad;

  // the last k codes of st: sh = 2 (32 NW - k)
  __device__ __forceinline__ explicit MwWindow(const MwShift<NW>& st, int sh) {
#pragma unroll
    for (int w = 0; w < NW - 1; ++w) {
      fw[w] = (st.f[w] << sh) | ((st.f[w + 1] >> 1) >> (63 - sh));
      rc[w] = st.r[w];
    }
    fw[NW - 1] = st.f[NW - 1] & (~0ull >> sh);
    rc[NW - 1] = st.r[NW - 1] >> sh;
    last_bad = st.last_bad;
  }

  // one code, at slot s: cs = 2r - 2, the last word's first base; mask, its
  // 2r bits
  __device__ __forceinline__ void step(uint32_t c, int s, int cs, uint64_t mask) {
    if (c == kInvalid) last_bad = s;
    const uint64_t v = c & 3u;
#pragma unroll
    for (int w = 0; w < NW - 2; ++w) fw[w] = (fw[w] << 2) | (fw[w + 1] >> 62);
    fw[NW - 2] = (fw[NW - 2] << 2) | ((fw[NW - 1] >> cs) & 3u);
    fw[NW - 1] = ((fw[NW - 1] << 2) | v) & mask;
    rc[NW - 1] = (rc[NW - 1] >> 2) | ((rc[NW - 2] & 3u) << cs);
#pragma unroll
    for (int w = NW - 2; w > 0; --w) rc[w] = (rc[w] >> 2) | (rc[w - 1] << 62);
    rc[0] = (rc[0] >> 2) | ((v ^ 2u) << 62);
  }

  // the key row of the window whose last code is at slot s, word w at
  // out[w * stride]
  __device__ __forceinline__ void key(int s, int k, long long* out, int stride) const {
    const uint32_t take = words_less<NW>(rc, fw);
    const uint64_t t = (static_cast<uint64_t>(take) << 32) | take;
    const uint64_t o = s - last_bad >= k ? 0ull : ~0ull;  // all ones: the sentinel
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint64_t v = (rc[w] & t) | (fw[w] & ~t);
      out[w * stride] = static_cast<long long>(((v ^ kMwSign) | o) & ~(o & kMwSign));
    }
  }
};

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int b) {
  const uint32_t x = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return (x >> (8 * (b & 3))) & 0xFFu;
}

template <int NW>
__global__ void __launch_bounds__(kMwThreads, 3)
canonical_kmers_mw_kernel(const uint8_t* __restrict__ codes, long long N, int k,
                          long long* __restrict__ keys, long long n_tiles) {
  using Sh = MwShape<NW>;
  extern __shared__ __align__(16) uint8_t mw_smem[];
  long long* key_buf = reinterpret_cast<long long*>(mw_smem + 2 * Sh::kCodeBuf);

  const long long W = N - k + 1;
  const int sh = 2 * (32 * NW - k);
  const int cs = 62 - sh;
  const uint64_t mask = ~0ull >> sh;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);

  long long tile = blockIdx.x;
  if (tile < n_tiles)
    load_span_mw(mw_smem, codes, N, tile * Sh::kTile,
                 min(N, tile * Sh::kTile + Sh::kTile + k - 1));
  cp_async_commit();
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      load_span_mw(mw_smem + ((it + 1) & 1) * Sh::kCodeBuf, codes, N, next * Sh::kTile,
                   min(N, next * Sh::kTile + Sh::kTile + k - 1));
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const long long lo = tile * Sh::kTile;
    const int n_tile = static_cast<int>(min(static_cast<long long>(Sh::kTile), W - lo));
    const uint8_t* buf = mw_smem + (it & 1) * Sh::kCodeBuf;
    const int r0 = threadIdx.x * Sh::kRuns;  // first window of this thread, in the tile
    const int n_win = min(Sh::kRuns, n_tile - r0);
    const int first = static_cast<int>((base + lo) & 15) + r0;  // slot of its first code
    const int end = first + k - 1;  // slot of its first window's last code
    if (n_win > 0) {
      // the first window's codes up to the last 4-aligned slot, four a step
      const int q = end & ~3;
      MwShift<NW> warm;
      for (int c = first & ~15; c < q; c += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(buf + c);
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + 4 * j < q) warm.step4(words[j], c + 4 * j);
      }
      MwWindow<NW> win(warm, sh);
      // then a code a step; a window a step from slot end on
      const int last = end + n_win;
      long long* staged = key_buf + threadIdx.x * Sh::kStride;
      for (int c = q & ~15; c < last; c += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(buf + c);
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int s = c + b;
          if (s >= q && s < last) {
            win.step(byte_of(v, b), s, cs, mask);
            if (s >= end) win.key(s, k, staged + (s - end), Sh::kRowKeys);
          }
        }
      }
    }
    __syncthreads();

    // each word row of the tile: a contiguous run of keys, 16-byte stores
    // from the first 16-byte boundary on
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      long long* row = keys + w * W + lo;
      const long long* src = key_buf + w * Sh::kRowKeys;
      const int head = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 3) & 1);
      const int n_pairs = (n_tile - head) / 2;
      for (int v = threadIdx.x; v < n_pairs; v += kMwThreads) {
        const int e = head + 2 * v;  // e and e + 1 may belong to two threads
        longlong2 pair;
        pair.x = src[(e / Sh::kRuns) * Sh::kStride + e % Sh::kRuns];
        pair.y = src[((e + 1) / Sh::kRuns) * Sh::kStride + (e + 1) % Sh::kRuns];
        __stcs(reinterpret_cast<longlong2*>(row + e), pair);
      }
      if (threadIdx.x == 0) {
        if (head) __stcs(row, src[0]);
        if ((n_tile - head) & 1) {
          const int e = n_tile - 1;
          __stcs(row + e, src[(e / Sh::kRuns) * Sh::kStride + e % Sh::kRuns]);
        }
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int NW>
int launch_mw(const uint8_t* codes, long long N, int k, int64_t* keys,
              cudaStream_t stream) {
  using Sh = MwShape<NW>;
  // blocks each card holds at once, its shared-memory attribute set
  static kmd::PerDevice<int> grid_of;
  int grid_max = 0;
  const int rc = grid_of.get(
      [](int dev, int* grid) {
        int n_sms = 0, per_sm = 0;
        cudaError_t err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
          err = cudaFuncSetAttribute(canonical_kmers_mw_kernel<NW>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
        if (err == cudaSuccess)
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, canonical_kmers_mw_kernel<NW>, kMwThreads, Sh::kSmem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        *grid = n_sms * per_sm;
        return 0;
      },
      &grid_max);
  if (rc != 0) return rc;
  const long long W = N - k + 1;
  const long long n_tiles = (W + Sh::kTile - 1) / Sh::kTile;
  const long long grid = std::min(n_tiles, static_cast<long long>(grid_max));
  canonical_kmers_mw_kernel<NW><<<static_cast<unsigned>(grid), kMwThreads, Sh::kSmem,
                                   stream>>>(codes, N, k,
                                             reinterpret_cast<long long*>(keys), n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// windows a tile and a thread's run at nw words (the edge cases of the
// tests)
KMD_API long long kmd_canonical_kmers_mw_tile_windows(int nw) {
  return nw == 2 ? MwShape<2>::kTile : nw == 3 ? MwShape<3>::kTile : MwShape<4>::kTile;
}
KMD_API long long kmd_canonical_kmers_mw_run_windows(int nw) {
  return nw == 2 ? MwShape<2>::kRuns : nw == 3 ? MwShape<3>::kRuns : MwShape<4>::kRuns;
}

// codes [N] u8 at any byte offset, N >= k, 33 <= k <= 128; keys [nw, N-k+1]
// int64, contiguous (row w at keys + w * (N-k+1)).
KMD_API int kmd_canonical_kmers_mw(const uint8_t* codes, long long N, int k,
                                   int64_t* keys, cudaStream_t stream) {
  if (k <= 32 || k > kMwMaxK || N < k) return static_cast<int>(cudaErrorInvalidValue);
  switch ((k + 31) / 32) {
    case 2:
      return launch_mw<2>(codes, N, k, keys, stream);
    case 3:
      return launch_mw<3>(codes, N, k, keys, stream);
    default:
      return launch_mw<4>(codes, N, k, keys, stream);
  }
}
