// K-PART: the owner shard of every k-mer row, and the rows each shard gets.
//
// Replaces kmdiff_tpu/ops/codec.py::partition_ids_lanes (codec.py:175-184,
// the k-mer -> partition hash) together with the owner-device target of the
// mesh counting shuffle (kmdiff_tpu/parallel/count_step.py:55-57 and
// :159-160: part % D, D for a sentinel row). The port's mesh count
// (parallel/count_step.py) buckets each shard's windows by this target
// before it sends bucket d to shard d.
//
// Input: keys [N] int64 (k <= 32) or [nw, N] int64 word-major (k > 32, row
// w holding word w of every key, row stride ld >= N), each word XORed with
// 1<<63; the sentinel row has every word INT64_MAX. Per row:
//
//   h = 0x9E3779B9
//   for each word w, most significant first:
//     u = key_w ^ (1 << 63)              (the u64 word back)
//     h = fmix32(hi32(u) ^ h)
//     h = fmix32(lo32(u) ^ h)
//   target = (h % nb_partitions) % D,  or D for the sentinel row
//
// (pipeline/count.py::host_partition_ids is the same chain on the host.)
// Outputs: targets [N] int32 and counts [D + 1] int64, the rows a target.
//
// Bound on the H100: device memory, 8 nw bytes in and 4 out a row against
// ~25 integer operations a word and two 32-bit remainders a row. A
// grid-stride loop over a capped grid (consecutive threads on consecutive
// rows) reads each word row coalesced; each block keeps its D + 1 counts in
// shared memory and adds them to the output once, so the global atomics are
// D + 1 a block, not one a row. The entry point clears counts on the
// stream before the launch.
#include <algorithm>

#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;
constexpr int kMaxShards = 1024;
constexpr uint32_t kHashSeed = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <int NW>
__global__ void partition_ids_kernel(const long long* __restrict__ keys, long long ld,
                                     long long N, uint32_t nb_partitions, int D,
                                     int32_t* __restrict__ targets,
                                     unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int block_counts[];
  for (int t = threadIdx.x; t <= D; t += blockDim.x) block_counts[t] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < N;
       i += stride) {
    uint32_t h = kHashSeed;
    bool sentinel = true;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const long long key = __ldcs(keys + w * ld + i);
      sentinel = sentinel && key == kmd::kSentinel;
      const uint64_t u = static_cast<uint64_t>(key) ^ (1ull << 63);
      h = fmix32(static_cast<uint32_t>(u >> 32) ^ h);
      h = fmix32(static_cast<uint32_t>(u) ^ h);
    }
    const int t = sentinel ? D : static_cast<int>((h % nb_partitions) % static_cast<uint32_t>(D));
    __stcs(targets + i, t);
    atomicAdd(block_counts + t, 1u);
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= D; t += blockDim.x)
    if (block_counts[t]) atomicAdd(counts + t, static_cast<unsigned long long>(block_counts[t]));
}

template <int NW>
void launch(const int64_t* keys, long long ld, long long N, uint32_t nb_partitions, int D,
            int32_t* targets, int64_t* counts, cudaStream_t stream) {
  const long long blocks = std::min<long long>(kMaxBlocks, (N + kThreads - 1) / kThreads);
  partition_ids_kernel<NW><<<static_cast<unsigned>(blocks), kThreads,
                             (D + 1) * sizeof(unsigned int), stream>>>(
      reinterpret_cast<const long long*>(keys), ld, N, nb_partitions, D, targets,
      reinterpret_cast<unsigned long long*>(counts));
}

}  // namespace

// keys [nw, N] int64 with row stride ld >= N (nw = 1: [N], ld unused),
// 1 <= nw <= 4; 1 <= nb_partitions; 1 <= D <= kMaxShards; targets [N] int32;
// counts [D + 1] int64 (cleared here on the stream). A block's shared
// counts are u32: it sees at most ceil(N / kMaxBlocks) rows, below 2^32 for
// any N below 2^43.
KMD_API int kmd_partition_ids(const int64_t* keys, long long ld, long long N, int nw,
                              unsigned nb_partitions, int D, int32_t* targets,
                              int64_t* counts, cudaStream_t stream) {
  if (nw < 1 || nw > 4 || N < 0 || (nw > 1 && ld < N) || nb_partitions < 1 || D < 1 ||
      D > kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counts, 0, (D + 1) * sizeof(int64_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  switch (nw) {
    case 1:
      launch<1>(keys, N, N, nb_partitions, D, targets, counts, stream);
      break;
    case 2:
      launch<2>(keys, ld, N, nb_partitions, D, targets, counts, stream);
      break;
    case 3:
      launch<3>(keys, ld, N, nb_partitions, D, targets, counts, stream);
      break;
    default:
      launch<4>(keys, ld, N, nb_partitions, D, targets, counts, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
