// K-LRT: Poisson likelihood-ratio filter over a [B, S] int32 count matrix.
//
// Replaces kmdiff_tpu/ops/lrt_pallas.py::lrt_filter_block_pallas (the only
// Pallas kernel of the JAX package) and the same arithmetic inlined in
// kmdiff_tpu/ops/merge_dev.py::merge_lrt_local (ops/lrt.py::_lr_from_sums).
//
// Per row: s_c = sum of the first nb_controls columns, s_k = sum of the
// rest (exact int32), then in f32
//   lr   = max(0, fc*log(fc/(tot*rc)) + fk*log(fk/(tot*rk)))  (0*log0 := 0)
//   keep = lr + 4e-6*tot + 1e-3 >= lr_min
// The margin (kmdiff_tpu/ops/lrt.py:41-46) assumes IEEE logf and IEEE
// division, so this file is built without --use_fast_math and with
// -fmad=false: the product and sums round exactly as the plain twin's.
//
// Layout: the Pallas kernel transposed the counts to [S_pad, B] and padded
// each group to 8 rows for Mosaic's sublane tiling, and needed B % 1024 == 0.
// None of that is needed here: one thread per row reads its S contiguous
// int32 straight from the row-major matrix, and the grid masks the ragged
// tail, so any B is taken.
//
// Bound on the H100: device memory. A row moves 4*S bytes in and 13 bytes
// out against ~30 flops and two logf, so at S=2 (the merge's [U, 2] sums)
// and S=20 (matrix tiles) the kernel is far below the card's
// flop-per-byte balance. Neighbouring threads read neighbouring rows, so a
// warp's loads cover one contiguous 128*S-byte span.
#include "kmd_common.cuh"

#include <math.h>

namespace {

constexpr float kMarginPerCount = 4e-6f;
constexpr float kMarginAbs = 1e-3f;

__global__ void lrt_filter_kernel(const int32_t* __restrict__ counts,
                                  long long B, int S, int nb_controls,
                                  float ratio_c, float ratio_k, float lr_min,
                                  uint8_t* __restrict__ keep,
                                  float* __restrict__ lr_out,
                                  int32_t* __restrict__ sc_out,
                                  int32_t* __restrict__ sk_out) {
  long long row = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (row >= B) return;
  const int32_t* r = counts + row * S;
  int32_t s_c = 0;
  int32_t s_k = 0;
  for (int j = 0; j < nb_controls; ++j) s_c += r[j];
  for (int j = nb_controls; j < S; ++j) s_k += r[j];

  float fc = static_cast<float>(s_c);
  float fk = static_cast<float>(s_k);
  float tot = fc + fk;
  float safe_tot = fmaxf(tot, 1.0f);
  float term_c = s_c > 0 ? fc * logf(fmaxf(fc, 1.0f) / (safe_tot * ratio_c)) : 0.0f;
  float term_k = s_k > 0 ? fk * logf(fmaxf(fk, 1.0f) / (safe_tot * ratio_k)) : 0.0f;
  float lr = tot > 0.0f ? term_c + term_k : 0.0f;
  lr = fmaxf(lr, 0.0f);

  keep[row] = (lr + kMarginPerCount * tot + kMarginAbs >= lr_min) ? 1 : 0;
  lr_out[row] = lr;
  sc_out[row] = s_c;
  sk_out[row] = s_k;
}

}  // namespace

KMD_API int kmd_lrt_filter(const int32_t* counts, long long B, int S,
                           int nb_controls, float ratio_c, float ratio_k,
                           float lr_min, uint8_t* keep, float* lr,
                           int32_t* s_c, int32_t* s_k, cudaStream_t stream) {
  constexpr int kThreads = 256;
  lrt_filter_kernel<<<kmd::grid_for(B, kThreads), kThreads, 0, stream>>>(
      counts, B, S, nb_controls, ratio_c, ratio_k, lr_min, keep, lr, s_c, s_k);
  return static_cast<int>(cudaGetLastError());
}
