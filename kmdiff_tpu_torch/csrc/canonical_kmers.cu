// K-EXT: canonical k-mer keys of every k-window of a 2-bit code stream.
//
// Replaces kmdiff_tpu/ops/codec.py::extract_canonical_lanes (mask_invalid=
// True), the extraction half of fused_count_kernel. Input: codes [N] u8 with
// 0..3 for A,C,T,G and 0xFF (INVALID) between reads and files. Output: keys
// [N-k+1] int64, one per window:
//   * the canonical k-mer (min of the forward and reverse-complement values)
//     packed as core/kmer.py::pack_codes packs it: first base in the highest
//     bits, right-aligned, one u64 word (1 <= k <= 32; k=32 fills all 64
//     bits);
//   * XORed with 1<<63, so that signed int64 order equals the unsigned word
//     order and torch.sort on int64 sorts k-mers as the JAX lanes sort them;
//   * INT64_MAX (the all-ones sentinel) for a window that holds an INVALID
//     code; it sorts last.
//
// The JAX version builds each window as a k-step ladder of shifted vector
// ORs (O(k) passes over the block, fused by XLA). Here one thread builds its
// window's forward and reverse-complement words in one pass over k codes
// held in shared memory: a block stages its blockDim + k - 1 codes once, so
// each code is read from device memory once per block instead of k times.
//
// Bound on the H100: the k-step inner loop. A window moves 9 bytes of
// device memory (1 in, 8 out) against ~6k integer operations, so at k=31
// the kernel does ~20 integer operations per byte: it is bounded by issue
// rate, not bandwidth. A rolling update (one thread sliding over many
// windows) would cut that to O(1) per window; that is later work.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr uint8_t kInvalid = 0xFF;

__global__ void canonical_kmers_kernel(const uint8_t* __restrict__ codes,
                                       long long N, int k,
                                       int64_t* __restrict__ keys) {
  __shared__ uint8_t tile[kThreads + kMaxK - 1];
  const long long W = N - k + 1;
  const long long base = blockIdx.x * static_cast<long long>(kThreads);
  for (int t = threadIdx.x; t < kThreads + k - 1; t += kThreads) {
    long long i = base + t;
    tile[t] = i < N ? codes[i] : kInvalid;
  }
  __syncthreads();
  const long long w = base + threadIdx.x;
  if (w >= W) return;

  uint64_t fwd = 0;
  uint64_t rc = 0;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    uint8_t c = tile[threadIdx.x + j];
    ok = ok && c != kInvalid;
    uint64_t b = c & 3u;
    fwd = (fwd << 2) | b;
    rc |= (b ^ 2u) << (2 * j);
  }
  uint64_t canon = rc < fwd ? rc : fwd;
  keys[w] = ok ? static_cast<int64_t>(canon ^ (1ull << 63)) : kmd::kSentinel;
}

}  // namespace

KMD_API int kmd_canonical_kmers(const uint8_t* codes, long long N, int k,
                                int64_t* keys, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || N < k) return static_cast<int>(cudaErrorInvalidValue);
  long long W = N - k + 1;
  canonical_kmers_kernel<<<kmd::grid_for(W, kThreads), kThreads, 0, stream>>>(
      codes, N, k, keys);
  return static_cast<int>(cudaGetLastError());
}
