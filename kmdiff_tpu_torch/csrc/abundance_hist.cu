// K-HIST: one-pass statistics of a counted stream.
//
// Replaces the stats read of kmdiff_tpu/ops/codec.py::sort_rle_core
// (codec.py:409-434): the valid-row count, the largest count and, with the
// histogram, bin b in 1..255 the distinct k-mers seen b times and bin 256
// those seen more than 255 times. Those are the cardinalities that
// io/kmtricks.py::hist_from_device turns into a kmtricks .hist file, so no
// O(distinct) counts array crosses to the host. Bin 0 counts zero counts
// (none in a counted stream); the JAX uvec[0] is pad junk.
//
//   kmd_count_stats  counts [N] u32 (sort_rle's run lengths) or int64
//                    (dedup_sum's sums), n_valid [1] int64 on the device
//                    -> out [2 + 257] int64 in page-locked host memory:
//                       n_valid, the largest count (0 when N = 0; an int64
//                       count is compared signed, a u32 one unsigned), and
//                       with the histogram its 257 bins (a negative int64
//                       count falls in bin 256, as its u64 value would)
//
// One launch and one host sync a call: the entry point waits for the
// kernel, whose last block writes the result row into `out`, so no widening
// pass, no separate max, no concatenation and no device-to-host copy
// surround it. The TPU form (a sort of the clipped counts and 258 binary
// searches) is gone.
//
// Bound on the H100: device memory, each count read once (4 or 8 bytes)
// and 259 int64 written. The design:
//   1. every load is 16 bytes (4 u32 or 2 int64), four in flight a thread;
//      a scalar head up to the first 16-byte boundary and a scalar tail
//      (K-RUN's counts are views at an int64 word offset of its buffer, so
//      they are 8-byte aligned, not always 16) go to block 0. A block owns
//      one contiguous span of the vectors, so the blocks finish together
//   2. counts are mostly 1-3 in a sample: a thread tallies those three bins
//      in registers (21-bit fields of one 64-bit word) and sends the rest to
//      its warp's own 257 bins in shared memory (a shared atomic; warps
//      never contend). The running max stays in a register
//   3. a block sums its register tallies with warp reductions, its max with
//      warp shuffles, then adds each non-zero bin and its max into the
//      accumulators with one global atomic each; the last block to finish
//      (a ticket counter) reads them, clears them and writes the result
//
// Scratch: the accumulators (257 bins, the max as an order-preserving key,
// the ticket; kmd_count_stats_scratch_words int64) persist between calls
// and are zero at the start of each: zeroed once at allocation, then
// cleared by each call's last block. So no memset runs, and none is needed:
// the caller keeps one scratch a host thread and device
// (ops/codec.py::_stats_slots), and a call waits for its kernel before it
// returns, so two calls never share one.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 257;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
// two blocks an SM of a 132-SM card; each block takes 1/grid of the vectors
constexpr long long kMaxBlocks = 132 * 2;
// register tallies of the values 1, 2, 3: one 21-bit field each. A thread
// sees fewer than 2^21 values while N < 2^21 * 512 * 264, about 2.8e11
constexpr int kFieldBits = 21;
constexpr unsigned long long kSign = 1ull << 63;

// scratch words: [bins: 257][max key][blocks done]
constexpr int kMaxSlot = kBins;
constexpr int kDoneSlot = kBins + 1;
constexpr int kScratchWords = kBins + 2;

template <bool kWide>
struct Count;
template <>
struct Count<false> {  // u32 counts
  using Vec = uint4;
  static constexpr int kPer = 4;
  static __device__ __forceinline__ unsigned long long value(const void* p, long long i) {
    return __ldg(static_cast<const uint32_t*>(p) + i);
  }
};
template <>
struct Count<true> {  // int64 counts
  using Vec = longlong2;
  static constexpr int kPer = 2;
  static __device__ __forceinline__ unsigned long long value(const void* p, long long i) {
    return static_cast<unsigned long long>(__ldg(static_cast<const long long*>(p) + i));
  }
};

template <bool kHist>
struct Tally {
  unsigned long long small = 0;  // values 1, 2, 3
  unsigned long long top = 0;    // the largest value's key (value ^ kSign); 0 below all

  // u: the count as u64 (a u32 zero-extended, an int64 as its bits)
  __device__ __forceinline__ void add(unsigned long long u, unsigned int* warp_bins) {
    top = max(top, u ^ kSign);
    if (kHist) {
      const unsigned long long s = u - 1;
      if (s < 3) {
        small += 1ull << (kFieldBits * static_cast<int>(s));
      } else {
        atomicAdd(&warp_bins[u < 256 ? static_cast<int>(u) : 256], 1u);
      }
    }
  }
  __device__ __forceinline__ void add(const uint4& v, unsigned int* b) {
    add(v.x, b); add(v.y, b); add(v.z, b); add(v.w, b);
  }
  __device__ __forceinline__ void add(const longlong2& v, unsigned int* b) {
    add(static_cast<unsigned long long>(v.x), b);
    add(static_cast<unsigned long long>(v.y), b);
  }
};

template <bool kWide, bool kHist>
__global__ void __launch_bounds__(kThreads)
count_stats_kernel(const void* __restrict__ counts, long long N, long long head,
                   long long n_vec, const int64_t* __restrict__ n_valid,
                   unsigned long long* __restrict__ scratch, long long* out) {
  using C = Count<kWide>;
  using Vec = typename C::Vec;
  constexpr int kW = kHist ? kWarps : 1;
  constexpr int kB = kHist ? kBins : 1;
  __shared__ unsigned int bins[kW][kB];
  __shared__ unsigned long long warp_top[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (kHist) {
    for (int i = threadIdx.x; i < kW * kB; i += kThreads) (&bins[0][0])[i] = 0;
    __syncthreads();
  }
  unsigned int* wb = kHist ? bins[warp] : nullptr;
  Tally<kHist> t;

  // 1. the scalar head and tail (block 0), then this block's span of vectors
  const long long tail_at = head + n_vec * C::kPer;
  if (blockIdx.x == 0 && threadIdx.x < head + (N - tail_at)) {
    const long long i = threadIdx.x < head ? threadIdx.x : tail_at + (threadIdx.x - head);
    t.add(C::value(counts, i), wb);
  }
  const Vec* vec = reinterpret_cast<const Vec*>(static_cast<const char*>(counts) +
                                                head * (16 / C::kPer));
  const long long per = (n_vec + gridDim.x - 1) / gridDim.x;
  const long long hi = min(n_vec, (blockIdx.x + 1) * per);
  long long i = blockIdx.x * per + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
    Vec v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vec + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) t.add(v[u], wb);
  }
  for (; i < hi; i += kThreads) t.add(__ldg(vec + i), wb);

  // 2. the block's tallies and max
  unsigned long long top = t.top;
  for (int o = 16; o > 0; o >>= 1) top = max(top, __shfl_xor_sync(0xffffffffu, top, o));
  if (lane == 0) warp_top[warp] = top;
  if (kHist) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const unsigned c = __reduce_add_sync(
          0xffffffffu, static_cast<unsigned>(t.small >> (kFieldBits * f)) & ((1u << kFieldBits) - 1));
      // bins 1..3 take no shared atomics: lane 0 is their one writer
      if (lane == 0) wb[f + 1] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) top = max(top, warp_top[w]);
    atomicMax(&scratch[kMaxSlot], top);
  }
  if (kHist) {
    for (int b = threadIdx.x; b < kBins; b += kThreads) {
      unsigned s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += bins[w][b];
      if (s) atomicAdd(&scratch[b], static_cast<unsigned long long>(s));
    }
  }

  // 3. the last block to finish reads and clears the accumulators
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&scratch[kDoneSlot], 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (kHist) {
    for (int b = threadIdx.x; b < kBins; b += kThreads) {
      out[2 + b] = static_cast<long long>(atomicExch(&scratch[b], 0ull));
    }
  }
  if (threadIdx.x == 0) {
    const unsigned long long key = atomicExch(&scratch[kMaxSlot], 0ull);
    atomicExch(&scratch[kDoneSlot], 0ull);
    out[0] = *n_valid;
    out[1] = N > 0 ? static_cast<long long>(key ^ kSign) : 0;
  }
}

template <bool kWide, bool kHist>
void launch(const void* counts, long long N, long long head, long long n_vec,
            const int64_t* n_valid, unsigned long long* scratch, long long* out,
            cudaStream_t stream) {
  long long blocks = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  count_stats_kernel<kWide, kHist><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      counts, N, head, n_vec, n_valid, scratch, out);
}

}  // namespace

KMD_API long long kmd_count_stats_scratch_words() { return kScratchWords; }

// counts [N] (wide: int64, else u32), aligned to their element; n_valid [1]
// int64 on the device; scratch: kmd_count_stats_scratch_words() int64 on the
// device, zero, used by one call at a time; out: 2 + 257 int64 (2 without
// the histogram) of page-locked host memory, written by the kernel through
// the same pointer under unified addressing. Waits for the kernel: the one
// host sync of a call.
KMD_API int kmd_count_stats(const void* counts, long long N, int wide, int with_hist,
                            const int64_t* n_valid, unsigned long long* scratch,
                            long long* out, cudaStream_t stream) {
  const long long size = wide ? 8 : 4;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(counts);
  if (N < 0 || (N > 0 && addr % size != 0)) return static_cast<int>(cudaErrorInvalidValue);
  long long head = static_cast<long long>((16 - addr % 16) % 16) / size;
  if (head > N) head = N;
  const long long n_vec = (N - head) / (16 / size);
  if (wide) {
    if (with_hist) launch<true, true>(counts, N, head, n_vec, n_valid, scratch, out, stream);
    else launch<true, false>(counts, N, head, n_vec, n_valid, scratch, out, stream);
  } else {
    if (with_hist) launch<false, true>(counts, N, head, n_vec, n_valid, scratch, out, stream);
    else launch<false, false>(counts, N, head, n_vec, n_valid, scratch, out, stream);
  }
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return static_cast<int>(e);
}
