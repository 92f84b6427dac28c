// K-GRAM: the exact integer Gram X^T X of a [B, S] 0/1 matrix.
//
// Replaces kmdiff_tpu/ops/pca.py::_int_gram_block (pca.py:47-52), the
// device half of _int_gram: the Eigenstrat PCA decomposes the normalised
// Gram into per-row-sum-group integer aggregates, so the PCs are
// bit-identical wherever the integers are exact. The TPU computed them as an
// f32 matmul in tiles below 2^24 rows (the bound of f32 integer exactness),
// and sent small groups to the host because a dispatch was expensive. Here
// the arithmetic is integer from the start, exact at any B, and every group
// runs on the card.
//
// Two kernels, one entry point:
//   pack_bits   X [B, S] u8 -> bits [S, W] u32, W = ceil(B / 32): bit r of
//               word w of sample s is X[32w + r, s] != 0 (one thread a
//               word; neighbouring threads read neighbouring samples of a
//               row)
//   gram        G[i, j] = sum_w popc(bits[i, w] & bits[j, w]) into int64:
//               16 x 16 sample tiles on or above the diagonal, 32-word
//               chunks of both tiles' rows staged in shared memory, the word
//               range split over blockIdx.z so that even S = 20 fills the
//               card; each block adds its tile with 64-bit atomics, exact
//               and independent of their order, and mirrors it below the
//               diagonal.
// The output is zeroed first (one memset).
//
// Bound on the H100: at S = 20 the packing, which reads the B x S bytes once;
// at S = 200 the S^2 / 2 x W popcounts (~1.6e8 at 2^18 rows), far below the
// card's integer rate either way. A byte of X becomes a bit, so the gram
// kernel reads 1/8 of X per tile pair.
#include "kmd_common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kChunk = 32;  // words of each tile row staged a step
constexpr int kPackThreads = 256;
// blocks to aim for: a few per SM of the 132
constexpr long long kTargetBlocks = 528;

__global__ void pack_bits_kernel(const uint8_t* __restrict__ X, long long B, int S,
                                 long long W, uint32_t* __restrict__ bits) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= W * S) return;
  const long long w = t / S;
  const int s = static_cast<int>(t % S);
  uint32_t word = 0;
  const long long r0 = w * 32;
  for (int r = 0; r < 32; ++r) {
    const long long row = r0 + r;
    if (row < B && X[row * S + s]) word |= 1u << r;
  }
  bits[static_cast<long long>(s) * W + w] = word;
}

__global__ void gram_kernel(const uint32_t* __restrict__ bits, int S, long long W,
                            long long words_per_split,
                            unsigned long long* __restrict__ gram) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  if (tj < ti) return;  // the mirror of a tile above the diagonal
  __shared__ uint32_t a[kTile][kChunk + 1];
  __shared__ uint32_t b[kTile][kChunk + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const long long w0 = blockIdx.z * words_per_split;
  const long long w1 = w0 + words_per_split < W ? w0 + words_per_split : W;
  unsigned long long acc = 0;
  for (long long wc = w0; wc < w1; wc += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kTile * kTile) {
      const int r = e / kChunk;
      const int c = e % kChunk;
      const long long w = wc + c;
      const int si = ti * kTile + r;
      const int sj = tj * kTile + r;
      a[r][c] = (si < S && w < w1) ? bits[static_cast<long long>(si) * W + w] : 0u;
      b[r][c] = (sj < S && w < w1) ? bits[static_cast<long long>(sj) * W + w] : 0u;
    }
    __syncthreads();
    unsigned int part = 0;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) part += __popc(a[ty][c] & b[tx][c]);
    acc += part;
    __syncthreads();
  }
  const int i = ti * kTile + ty;
  const int j = tj * kTile + tx;
  if (i < S && j < S && acc) {
    atomicAdd(&gram[static_cast<long long>(i) * S + j], acc);
    if (ti != tj) atomicAdd(&gram[static_cast<long long>(j) * S + i], acc);
  }
}

}  // namespace

KMD_API int kmd_int_gram(const uint8_t* X, long long B, int S, uint32_t* bits,
                         int64_t* gram, cudaStream_t stream) {
  if (S <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long W = (B + 31) / 32;
  cudaError_t err = cudaMemsetAsync(
      gram, 0, static_cast<size_t>(S) * S * sizeof(int64_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_bits_kernel<<<kmd::grid_for(W * S, kPackThreads), kPackThreads, 0, stream>>>(
      X, B, S, W, bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long t = (S + kTile - 1) / kTile;
  const long long tiles = t * (t + 1) / 2;
  const long long chunks = (W + kChunk - 1) / kChunk;
  long long z = (kTargetBlocks + tiles - 1) / tiles;
  if (z > chunks) z = chunks;
  if (z > 65535) z = 65535;
  if (z < 1) z = 1;
  const long long per = ((chunks + z - 1) / z) * kChunk;
  z = (W + per - 1) / per;
  gram_kernel<<<dim3(static_cast<unsigned>(t), static_cast<unsigned>(t),
                     static_cast<unsigned>(z)),
                dim3(kTile, kTile), 0, stream>>>(
      bits, S, W, per, reinterpret_cast<unsigned long long*>(gram));
  return static_cast<int>(cudaGetLastError());
}
