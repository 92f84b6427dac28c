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
// Outputs: keep always; lr, s_c and s_k only where the caller passes a
// pointer (null: not written). The merge reads keep alone, the matrix path
// keep and the sums.
//
// Layout: the Pallas kernel transposed the counts to [S_pad, B] and padded
// each group to 8 rows for Mosaic's sublane tiling, and needed B % 1024 == 0.
// None of that is needed here: the counts are read row-major as they are,
// and the ragged edges are masked, so any B is taken.
//
// Bound on the H100: device memory. A row moves 4*S bytes in and 1 out
// (keep), 4 (lr) and 8 (sums) more where asked for, against ~50 f32
// operations and two logf; at S = 2 the instructions of the two IEEE logf
// and divisions (~75 a row) take about as long to issue as the bytes take
// to move. Two forms:
//   pairs  S = 2 with keep alone: the merge's [U, 2] sums (8-byte aligned:
//          a view at an int64 word offset of K-RUN's buffer). From row
//          `lead` on (1 when the pairs start 8 bytes past a 16-byte
//          boundary, else 0), two rows are one 16-byte load; a thread takes
//          four consecutive loads, eight rows, whose arithmetic runs as
//          straight-line code, and stores their keep in one 8-byte store
//          where keep's row `lead` is 8-byte aligned (the wrapper,
//          ops/lrt_kernel.py, places it so). The lead row and an odd last
//          row, a row a thread. (PERF.md section 6: warp-strided loads with
//          two-row keep stores, or with ballots gathering 8-byte keep
//          stores, took 7-12% longer.)
//   rows   everything else: a thread a row, reading its S counts and writing
//          what is asked for; a warp's loads span its 32 rows, which L1
//          serves after the first touch of each line. It takes the matrix
//          tiles (S = 20 on the bench cohort) and the full form at S = 2,
//          which no caller of the main path asks for. At [2^17, 20] the work
//          is ~4 us, so latency, not bandwidth, sets it (PERF.md section 6):
//          staging 128-row tiles in shared memory with coalesced 16-byte
//          loads (row stride S | 1 against bank conflicts) took
//          0.0048-0.0049 ms against 0.0044-0.0045 for a thread a row with
//          16-byte loads, itself no faster than 4-byte loads (0.0044);
//          staging put its shared-memory stores and a barrier on every
//          block's critical path
#include "kmd_common.cuh"

#include <math.h>

namespace {

constexpr float kMarginPerCount = 4e-6f;
constexpr float kMarginAbs = 1e-3f;
constexpr int kPairVecs = 4;   // consecutive 16-byte loads (of two rows) a thread, pairs form
constexpr int kThreads = 256;

struct Filter {
  int nb_controls;
  float ratio_c, ratio_k, lr_min;
  uint8_t* keep;
  float* lr;      // or null
  int32_t* s_c;   // s_c and s_k, or both null
  int32_t* s_k;

  __device__ __forceinline__ float lr_of(int32_t sc, int32_t sk) const {
    const float fc = static_cast<float>(sc);
    const float fk = static_cast<float>(sk);
    const float tot = fc + fk;
    const float safe_tot = fmaxf(tot, 1.0f);
    const float term_c = sc > 0 ? fc * logf(fmaxf(fc, 1.0f) / (safe_tot * ratio_c)) : 0.0f;
    const float term_k = sk > 0 ? fk * logf(fmaxf(fk, 1.0f) / (safe_tot * ratio_k)) : 0.0f;
    return fmaxf(tot > 0.0f ? term_c + term_k : 0.0f, 0.0f);
  }

  __device__ __forceinline__ bool keep_of(float l, int32_t sc, int32_t sk) const {
    const float tot = static_cast<float>(sc) + static_cast<float>(sk);
    return l + kMarginPerCount * tot + kMarginAbs >= lr_min;
  }

  // one row, scalar stores
  __device__ __forceinline__ void write(long long row, int32_t sc, int32_t sk) const {
    const float l = lr_of(sc, sk);
    keep[row] = keep_of(l, sc, sk) ? 1 : 0;
    if (lr != nullptr) lr[row] = l;
    if (s_c != nullptr) {
      s_c[row] = sc;
      s_k[row] = sk;
    }
  }
};

__device__ __forceinline__ void split_pair(int32_t a, int32_t b, int nb_controls,
                                           int32_t& sc, int32_t& sk) {
  sc = (nb_controls > 0 ? a : 0) + (nb_controls > 1 ? b : 0);
  sk = (nb_controls > 0 ? 0 : a) + (nb_controls > 1 ? 0 : b);
}

template <typename T>
__device__ __forceinline__ bool aligned(const T* p, int bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

// Vector i holds rows lead + 2i and lead + 2i + 1; thread t takes vectors
// 4t .. 4t + 3 and writes only keep. Block 0's threads 0 and 1 also take the
// lead row and an odd last row.
__global__ void __launch_bounds__(kThreads)
lrt_pairs_kernel(const int32_t* __restrict__ counts, long long B, int lead,
                 long long n_vec, Filter f) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long v0 = kPairVecs * t;
  const int4* src = reinterpret_cast<const int4*>(counts + 2 * lead);
  int4 v[kPairVecs];
#pragma unroll
  for (int u = 0; u < kPairVecs; ++u) {
    v[u] = v0 + u < n_vec ? __ldcs(src + v0 + u) : make_int4(0, 0, 0, 0);
  }
  // every row's arithmetic in straight-line code (a missing vector's rows
  // are zeros, never stored), so that the eight rows' logs and divisions
  // interleave; then one store
  int32_t sc[2 * kPairVecs], sk[2 * kPairVecs];
#pragma unroll
  for (int u = 0; u < kPairVecs; ++u) {
    split_pair(v[u].x, v[u].y, f.nb_controls, sc[2 * u], sk[2 * u]);
    split_pair(v[u].z, v[u].w, f.nb_controls, sc[2 * u + 1], sk[2 * u + 1]);
  }
  unsigned long long bytes = 0;
#pragma unroll
  for (int j = 0; j < 2 * kPairVecs; ++j) {
    const bool k = f.keep_of(f.lr_of(sc[j], sk[j]), sc[j], sk[j]);
    bytes |= static_cast<unsigned long long>(k) << (8 * j);
  }
  const long long n_own = min(static_cast<long long>(kPairVecs), n_vec - v0);
  uint8_t* keep = f.keep + lead + 2 * v0;
  if (n_own == kPairVecs && aligned(keep, 8)) {
    *reinterpret_cast<unsigned long long*>(keep) = bytes;
  } else {
    for (int j = 0; j < 2 * n_own; ++j) keep[j] = static_cast<uint8_t>(bytes >> (8 * j));
  }
  const long long odd = (B - lead) & 1;
  if (blockIdx.x == 0 && threadIdx.x < 2 && (threadIdx.x == 0 ? lead : odd)) {
    const long long row = threadIdx.x == 0 ? 0 : B - 1;
    const int2 p = __ldg(reinterpret_cast<const int2*>(counts) + row);
    int32_t sc, sk;
    split_pair(p.x, p.y, f.nb_controls, sc, sk);
    f.write(row, sc, sk);
  }
}

__global__ void __launch_bounds__(kThreads)
lrt_rows_kernel(const int32_t* __restrict__ counts, long long B, int S, Filter f) {
  const long long row = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (row >= B) return;
  const int32_t* r = counts + row * S;
  int32_t sc = 0;
  int32_t sk = 0;
#pragma unroll 8
  for (int j = 0; j < S; ++j) {
    const int32_t v = __ldg(r + j);
    if (j < f.nb_controls) sc += v; else sk += v;
  }
  f.write(row, sc, sk);
}

}  // namespace

// counts [B, S] int32 row-major, aligned to 4 bytes; keep [B] (written);
// lr [B], and s_c and s_k [B] (both or neither), or null to write none.
KMD_API int kmd_lrt_filter(const int32_t* counts, long long B, int S,
                           int nb_controls, float ratio_c, float ratio_k,
                           float lr_min, uint8_t* keep, float* lr,
                           int32_t* s_c, int32_t* s_k, cudaStream_t stream) {
  if (B < 0 || S < 0 || nb_controls < 0 || nb_controls > S || keep == nullptr ||
      (s_c == nullptr) != (s_k == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const Filter f{nb_controls, ratio_c, ratio_k, lr_min, keep, lr, s_c, s_k};
  const unsigned long long addr = reinterpret_cast<unsigned long long>(counts);
  if (S == 2 && addr % 8 == 0 && lr == nullptr && s_c == nullptr) {
    const int lead = addr % 16 != 0 ? 1 : 0;
    const long long n_vec = (B - lead) / 2;
    unsigned blocks = kmd::grid_for((n_vec + kPairVecs - 1) / kPairVecs, kThreads);
    blocks = blocks > 0 ? blocks : 1;
    lrt_pairs_kernel<<<blocks, kThreads, 0, stream>>>(counts, B, lead, n_vec, f);
  } else {
    lrt_rows_kernel<<<kmd::grid_for(B, kThreads), kThreads, 0, stream>>>(counts, B, S, f);
  }
  return static_cast<int>(cudaGetLastError());
}
