// K-GENO: the deterministic Bernoulli(kmer_pca) sample of distinct k-mers.
//
// Replaces the sampling chain of kmdiff_tpu/ops/merge_dev.py::merge_lrt_local
// (merge_dev.py:39-45 _avalanche, :323-329 the per-lane hash of the run
// starts), whose host twin is kmdiff_tpu/pipeline/popstrat.py::sample_mask:
// a k-mer is sampled iff its avalanche hash, keyed by the seed, falls below
// thr = kmer_pca * (2^32 - 1) as u32 (merge_dev.py::pca_threshold_u32).
//
//   word = key ^ (1 << 63)           (the port's int64 key back to its u64)
//   h    = 0x51ED2700 ^ seed
//   h    = avalanche(hi32(word) ^ h)
//   h    = avalanche(lo32(word) ^ h)
//   mask = h < thr
//
// One thread a key. Bound on the H100: device memory, 8 bytes in and 1 out a
// key against ~20 integer operations; the hash needs no table and no
// randomness, so every layout and chunking samples the same k-mers.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSampleSeed = 0x51ED2700u;

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void geno_sample_kernel(const int64_t* __restrict__ keys, long long U,
                                   uint32_t thr, uint32_t seed,
                                   uint8_t* __restrict__ mask) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= U) return;
  const uint64_t word = static_cast<uint64_t>(keys[i]) ^ (1ull << 63);
  uint32_t h = kSampleSeed ^ seed;
  h = avalanche(static_cast<uint32_t>(word >> 32) ^ h);
  h = avalanche(static_cast<uint32_t>(word) ^ h);
  mask[i] = h < thr ? 1 : 0;
}

}  // namespace

KMD_API int kmd_geno_sample(const int64_t* keys, long long U, unsigned thr,
                            unsigned seed, uint8_t* mask, cudaStream_t stream) {
  geno_sample_kernel<<<kmd::grid_for(U, kThreads), kThreads, 0, stream>>>(
      keys, U, thr, seed, mask);
  return static_cast<int>(cudaGetLastError());
}

// K-GENO, multi-word form (k > 32): keys [nw, U] int64, word-major (row w
// holds word w of every key, row stride ld), each word XORed with 1<<63 as
// in the one-word form. The chain runs over the 2 nw u32 halves, most
// significant word first, hi32 before lo32 (kmdiff_tpu/ops/merge_dev.py:
// 323-329 over the lanes; pipeline/popstrat.py::sample_mask over the
// words). One thread a key; consecutive threads read consecutive keys of
// each row.
namespace {

template <int NW>
__global__ void geno_sample_mw_kernel(const int64_t* __restrict__ keys, long long ld,
                                      long long U, uint32_t thr, uint32_t seed,
                                      uint8_t* __restrict__ mask) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= U) return;
  uint32_t h = kSampleSeed ^ seed;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint64_t word = static_cast<uint64_t>(keys[w * ld + i]) ^ (1ull << 63);
    h = avalanche(static_cast<uint32_t>(word >> 32) ^ h);
    h = avalanche(static_cast<uint32_t>(word) ^ h);
  }
  mask[i] = h < thr ? 1 : 0;
}

}  // namespace

// keys [nw, U] with row stride ld >= U, 2 <= nw <= 4; mask [U].
KMD_API int kmd_geno_sample_mw(const int64_t* keys, long long ld, long long U, int nw,
                               unsigned thr, unsigned seed, uint8_t* mask,
                               cudaStream_t stream) {
  if (nw < 2 || nw > 4 || ld < U) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = kmd::grid_for(U, kThreads);
  switch (nw) {
    case 2:
      geno_sample_mw_kernel<2><<<grid, kThreads, 0, stream>>>(keys, ld, U, thr, seed, mask);
      break;
    case 3:
      geno_sample_mw_kernel<3><<<grid, kThreads, 0, stream>>>(keys, ld, U, thr, seed, mask);
      break;
    default:
      geno_sample_mw_kernel<4><<<grid, kThreads, 0, stream>>>(keys, ld, U, thr, seed, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
