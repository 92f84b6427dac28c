// Decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA, 2016): the exclusive prefix of the
// per-tile counts of a single-pass kernel whose blocks each own one tile of
// consecutive rows. K-CMP (compact.cu) and K-RUN (run_bounds.cu) share it;
// K-FASTA (fasta_codes.cu) carries an ordered value through the same status
// words (exclusive_prefix_ordered).
//
// Scratch: uint64 [1 + n_tiles], zeroed before the launch: the tile
// counter, then one status word per tile. A block takes its tile id from
// the counter (take_tile), so it only ever waits on tiles that running
// blocks hold and always progresses. It publishes its count (publish),
// then one warp sums its predecessors' counts back to the nearest
// published inclusive prefix and publishes its own (exclusive_prefix). A
// status word is 64 bits, the flag in its top two, written with
// st.release.gpu and read with ld.acquire.gpu.
#pragma once

#include "kmd_common.cuh"

namespace kmd {
namespace lookback {

constexpr unsigned long long kAggregate = 1ull << 62;  // tile count published
constexpr unsigned long long kPrefix = 2ull << 62;     // inclusive prefix published
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One thread of the block: the next tile id in block start order.
__device__ __forceinline__ int take_tile(unsigned long long* scratch) {
  return static_cast<int>(atomicAdd(scratch, 1ull));
}

// One thread of the block: publish tile t's count (tile 0's is its prefix).
__device__ __forceinline__ void publish(unsigned long long* scratch, int t,
                                        long long count) {
  store_release(&scratch[1 + t], (t == 0 ? kPrefix : kAggregate) |
                                     static_cast<unsigned long long>(count));
}

// All 32 lanes of one warp, after publish: the sum of the counts of tiles
// 0..t-1. Publishes tile t's inclusive prefix on the way out.
__device__ __forceinline__ long long exclusive_prefix(unsigned long long* scratch,
                                                      int t, long long count,
                                                      int lane) {
  const unsigned long long* status = scratch + 1;
  long long exclusive = 0;
  if (t == 0) return 0;
  for (long long last = t - 1;; last -= 32) {
    const long long i = last - lane;
    unsigned long long s = kPrefix;  // before tile 0: an empty prefix
    if (i >= 0) {
      do {
        s = load_acquire(&status[i]);
      } while (s < kAggregate);
    }
    const unsigned pre = __ballot_sync(0xffffffffu, s >= kPrefix);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    long long x = lane <= stop ? static_cast<long long>(s & kValue) : 0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    exclusive += x;
    if (pre) break;
  }
  if (lane == 0) {
    store_release(&scratch[1 + t],
                  kPrefix | static_cast<unsigned long long>(exclusive + count));
  }
  return exclusive;
}

// exclusive_prefix for a tile value that is not a count (K-FASTA's newline
// count with the state of the last line): op(earlier, later) combines two
// values of consecutive spans, is associative, has 0 as its identity and
// keeps a value below 2^62. Lane l holds tile last - l, so the warp folds
// the higher (earlier) lanes in from the left, in tile order.
template <typename Op>
__device__ __forceinline__ unsigned long long exclusive_prefix_ordered(
    unsigned long long* scratch, int t, unsigned long long value, int lane,
    Op op) {
  const unsigned long long* status = scratch + 1;
  unsigned long long exclusive = 0;
  if (t == 0) return 0;
  for (long long last = t - 1;; last -= 32) {
    const long long i = last - lane;
    unsigned long long s = kPrefix;  // before tile 0: the identity
    if (i >= 0) {
      do {
        s = load_acquire(&status[i]);
      } while (s < kAggregate);
    }
    const unsigned pre = __ballot_sync(0xffffffffu, s >= kPrefix);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    unsigned long long x = lane <= stop ? (s & kValue) : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x = op(y, x);
    }
    exclusive = op(__shfl_sync(0xffffffffu, x, 0), exclusive);
    if (pre) break;
  }
  if (lane == 0) store_release(&scratch[1 + t], kPrefix | op(exclusive, value));
  return exclusive;
}

}  // namespace lookback
}  // namespace kmd
