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
// Wide counts: int64 [B, S] (the wide merge's [U, 2] group sums, from
// run_bounds.cu's full form, which may pass 2^31 and 2^32), keep alone. The
// sums are exact int64 and each is rounded to f32 once (__ll2float_rn), the
// rest is the same filter. The JAX package's wide merge
// (kmdiff_tpu/ops/merge_dev.py:244-266) sums each count's 16-bit halves and
// feeds the filter f32(hi) * 65536 + f32(lo): while a half-sum stays below
// 2^24 (S <= 256 samples) each term is exact and the one f32 addition rounds
// the exact sum, which is __ll2float_rn's value, so the keep masks agree bit
// for bit there.
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
//   wide pairs  int64 S = 2, 16-byte aligned, keep alone: a row is one
//          16-byte load; a thread takes eight consecutive rows and stores
//          their keep in one 8-byte store (17 bytes a row move)
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
constexpr int kWideRows = 8;   // consecutive 16-byte rows a thread, wide pairs form
constexpr int kThreads = 256;

struct Filter {
  int nb_controls;
  float ratio_c, ratio_k, lr_min;
  uint8_t* keep;
  float* lr;      // or null
  int32_t* s_c;   // s_c and s_k, or both null
  int32_t* s_k;

  // the LR of the sums' f32 values fc and fk; pc and pk: the sums are > 0
  __device__ __forceinline__ float lr_f(float fc, float fk, bool pc, bool pk) const {
    const float tot = fc + fk;
    const float safe_tot = fmaxf(tot, 1.0f);
    const float term_c = pc ? fc * logf(fmaxf(fc, 1.0f) / (safe_tot * ratio_c)) : 0.0f;
    const float term_k = pk ? fk * logf(fmaxf(fk, 1.0f) / (safe_tot * ratio_k)) : 0.0f;
    return fmaxf(tot > 0.0f ? term_c + term_k : 0.0f, 0.0f);
  }

  __device__ __forceinline__ bool keep_f(float l, float fc, float fk) const {
    const float tot = fc + fk;
    return l + kMarginPerCount * tot + kMarginAbs >= lr_min;
  }

  __device__ __forceinline__ float lr_of(int32_t sc, int32_t sk) const {
    return lr_f(static_cast<float>(sc), static_cast<float>(sk), sc > 0, sk > 0);
  }

  __device__ __forceinline__ bool keep_of(float l, int32_t sc, int32_t sk) const {
    return keep_f(l, static_cast<float>(sc), static_cast<float>(sk));
  }

  // int64 sums, each rounded to f32 once
  __device__ __forceinline__ bool keep_wide(long long sc, long long sk) const {
    const float fc = __ll2float_rn(sc);
    const float fk = __ll2float_rn(sk);
    return keep_f(lr_f(fc, fk, sc > 0, sk > 0), fc, fk);
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

template <typename T>
__device__ __forceinline__ void split_pair(T a, T b, int nb_controls, T& sc, T& sk) {
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

// Wide pairs: row r is one 16-byte load (s_c, s_k int64); thread t takes
// rows 8t .. 8t + 7 and writes only keep.
__global__ void __launch_bounds__(kThreads)
lrt_wide_pairs_kernel(const long long* __restrict__ sums, long long B, Filter f) {
  const long long r0 = kWideRows * (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x);
  if (r0 >= B) return;
  const longlong2* src = reinterpret_cast<const longlong2*>(sums) + r0;
  longlong2 v[kWideRows];
#pragma unroll
  for (int j = 0; j < kWideRows; ++j) {
    v[j] = r0 + j < B ? __ldcs(src + j) : make_longlong2(0, 0);
  }
  unsigned long long bytes = 0;
#pragma unroll
  for (int j = 0; j < kWideRows; ++j) {
    long long sc, sk;
    split_pair(v[j].x, v[j].y, f.nb_controls, sc, sk);
    bytes |= static_cast<unsigned long long>(f.keep_wide(sc, sk)) << (8 * j);
  }
  const long long n_own = min(static_cast<long long>(kWideRows), B - r0);
  uint8_t* keep = f.keep + r0;
  if (n_own == kWideRows && aligned(keep, 8)) {
    *reinterpret_cast<unsigned long long*>(keep) = bytes;
  } else {
    for (int j = 0; j < n_own; ++j) keep[j] = static_cast<uint8_t>(bytes >> (8 * j));
  }
}

// int32 counts: every output asked for; int64 counts: keep alone
template <typename T>
__global__ void __launch_bounds__(kThreads)
lrt_rows_kernel(const T* __restrict__ counts, long long B, int S, Filter f) {
  const long long row = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (row >= B) return;
  const T* r = counts + row * S;
  T sc = 0;
  T sk = 0;
#pragma unroll 8
  for (int j = 0; j < S; ++j) {
    const T v = __ldg(r + j);
    if (j < f.nb_controls) sc += v; else sk += v;
  }
  if constexpr (sizeof(T) == 8) {
    f.keep[row] = f.keep_wide(sc, sk) ? 1 : 0;
  } else {
    f.write(row, sc, sk);
  }
}

}  // namespace

// counts [B, S] row-major: int32 aligned to 4 bytes (wide = 0) or int64
// aligned to 8 (wide = 1); keep [B] (written); lr [B], and s_c and s_k [B]
// (both or neither), or null to write none; wide counts write keep alone.
KMD_API int kmd_lrt_filter(const void* counts, long long B, int S, int wide,
                           int nb_controls, float ratio_c, float ratio_k,
                           float lr_min, uint8_t* keep, float* lr,
                           int32_t* s_c, int32_t* s_k, cudaStream_t stream) {
  if (B < 0 || S < 0 || nb_controls < 0 || nb_controls > S || keep == nullptr ||
      (s_c == nullptr) != (s_k == nullptr) ||
      (wide && (lr != nullptr || s_c != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const Filter f{nb_controls, ratio_c, ratio_k, lr_min, keep, lr, s_c, s_k};
  const unsigned long long addr = reinterpret_cast<unsigned long long>(counts);
  if (wide) {
    const long long* sums = static_cast<const long long*>(counts);
    if (S == 2 && addr % 16 == 0) {
      lrt_wide_pairs_kernel<<<kmd::grid_for((B + kWideRows - 1) / kWideRows, kThreads),
                              kThreads, 0, stream>>>(sums, B, f);
    } else {
      lrt_rows_kernel<long long><<<kmd::grid_for(B, kThreads), kThreads, 0, stream>>>(
          sums, B, S, f);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int32_t* c32 = static_cast<const int32_t*>(counts);
  if (S == 2 && addr % 8 == 0 && lr == nullptr && s_c == nullptr) {
    const int lead = addr % 16 != 0 ? 1 : 0;
    const long long n_vec = (B - lead) / 2;
    unsigned blocks = kmd::grid_for((n_vec + kPairVecs - 1) / kPairVecs, kThreads);
    blocks = blocks > 0 ? blocks : 1;
    lrt_pairs_kernel<<<blocks, kThreads, 0, stream>>>(c32, B, lead, n_vec, f);
  } else {
    lrt_rows_kernel<int32_t><<<kmd::grid_for(B, kThreads), kThreads, 0, stream>>>(
        c32, B, S, f);
  }
  return static_cast<int>(cudaGetLastError());
}
