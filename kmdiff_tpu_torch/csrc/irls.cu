// K-IRLS: batched logistic regression by IRLS, then each fit's log-likelihood.
//
// Replaces kmdiff_tpu/ops/glm.py::_irls_single under batched_irls and
// batched_irls_lastcol (glm.py:45-136), and log_likelihood /
// log_likelihood_lastcol (glm.py:139-166): popstrat's one null fit and its
// alt fit per significant k-mer. Item b's design is X[b] (or the shared X[0])
// with, when `last` is given, its last column replaced by last[b]; y [n] is
// shared. All in f32, as the JAX package computes on the CPU and the TPU.
//
// _irls_single's semantics, kept exactly:
//   mu0 = (y + 0.5) / 2, eta0 = log(mu0 / (1 - mu0)), w0 = 1
//   loop: g = mu (1 - mu), good = g > g_floor
//         error = mean((y - mu)^2), taken before the update
//         converged = |error - prev| < eps_conv or no good row -> stop, the
//           iteration count and prev unchanged
//         H = X^T diag(good ? g : 0) X, rhs = X^T (good ? g eta + y - mu : 0)
//         w' = H^-1 rhs, by Gaussian elimination with partial pivoting and
//           no epsilon guard, with fused multiply-adds and reciprocal
//           multipliers as LAPACK's and cuSOLVER's LU (without them, a
//           rank-deficient H of a quasi-separated fit cancels to an exact
//           zero pivot where those leave a tiny one); a zero pivot or a
//           non-finite w' freezes the item at its weights (stop 1)
//         iters + 1 >= max_iters stops without taking w' (stop 2): the
//           weights lag the last solve by one iteration
//         else w = w', eta = X w, mu = sigmoid(eta), prev = error
// then ll = -sum(y softplus(-z) + (1 - y) softplus(z)), z = X w, with a
// stable softplus. Outputs: w [B, F], err [B] (the last error), iters [B],
// ll [B], stop [B] (0 converged, 1 frozen by the solve, 2 max_iters).
//
// The TPU form is gone: no vmapped while_loop that runs every item until the
// slowest is done, no [B, n, F] batched matmuls at HIGHEST precision. One
// warp fits one item, several fits a block (kmd_irls_layout picks how many
// from n and F), and a fit that stops exits its warp: the iteration loop
// has no block barrier, only warp shuffles, reductions and __syncwarp on
// warp-private shared memory. The design is staged in shared memory once,
// column by column: a shared X[0] once a block, each item's own design or
// replaced last column once a warp (read from device memory only where it
// does not fit). Each F up to kMaxRegF has its own kernel, so that every
// loop over F is straight-line code and the solve keeps A in registers;
// one kernel serves any larger F with A in shared memory.
//
// Every arithmetic step is the one-block-an-item kernel's this design
// replaced, in the same order, so that the fits are bit-identical to its
// (tools/irls_seeds.py --parent checks that):
//   - each Hessian and right-hand-side entry is one compensated sum over
//     i = 0..n-1 in order on one lane; a lane sums up to kEntries entries
//     at once;
//   - the error, the good-row test and the log-likelihood were block sums
//     over a 128-thread stride: lane l keeps the partials of the virtual
//     threads l, l + 32, l + 64 and l + 96, each over its rows in order,
//     reduces each by the same shuffle tree and adds the four in order;
//   - the pivot is the first row of the strictly largest |A[r, k]|; the
//     elimination keeps its fmaf(-A[r, k] * (1 / piv), A[k, c], A[r, c]);
//     the back-substitution keeps its fmaf order.
//
// Bound on the H100: the item's flops, ~n F^2 a pass for the Hessian and F^3
// / 3 for the solve, with the n-long sums in order on one lane each; the
// alt fits of 10^4 k-mers at n = 20, F = 5 are ~10^8 flops in all. A
// launch of popstrat's ~850 alt fits is one wave: its time is the slowest
// fit's chain of iterations, each a chain of dependent shared-memory
// steps.
#include "kmd_common.cuh"

#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxF = 64;
// up to this many features, F is a compile-time constant and A lives in
// registers (a kernel for each F); beyond, one kernel for any F
constexpr int kMaxRegF = 16;
constexpr int kMaxWarps = 8;
// the replaced kernel's block: its block sums ran over this stride
constexpr int kStride = 128;
constexpr int kParts = kStride / 32;
// Hessian and right-hand-side entries a lane sums in one pass over the rows
constexpr int kEntries = 4;

// Compensated sum: one lane's n-long sums stay within a few ulp of the
// exact sum at any n (a plain f32 loop drifts by ~sqrt(n) ulp), so the
// sequential order costs no accuracy against a blocked product. Exact
// without fused multiply-adds, which the build turns off (-fmad=false).
struct Kahan {
  float sum = 0.0f;
  float c = 0.0f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The replaced kernel's block sum of the partials of 128 threads, thread t
// = l + 32 q held by lane l as p[q]: each group of 32 by the shuffle tree,
// then the four added in order from 0. The same value in every lane. A
// group whose threads held no row (32 q >= n) adds +0 to a sum that is
// never -0 (sums from +0 never are): it is skipped.
__device__ __forceinline__ float stride_sum(const float (&p)[kParts], int n) {
  float t = 0.0f;
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    if (32 * q >= n) break;
    float v = p[q];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    t += __shfl_sync(kFull, v, 0);
  }
  return t;
}

// Shared-memory floats, every segment a multiple of 4 (16-byte aligned):
// per block, staged, y [ldn] and a shared X[0] column by column [F, ldn];
// per warp eta, mu, gw, gz [4, ldn], A [F, F + 1], w and nw [2 F] and,
// staged, the item's own design [F, ldn] and its replaced last column
// [ldn]. ldn = n rounded up to 32, plus 4: a column starts 16 bytes on in
// the banks from the one before, so lanes reading 16 bytes of different
// columns hit different banks.
__host__ __device__ inline int col_ld(int n) { return (n + 31) / 32 * 32 + 4; }

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

__host__ __device__ inline long long block_floats(int n, int F, bool shared_x, bool staged) {
  return staged ? (shared_x ? F + 1LL : 1LL) * col_ld(n) : 0;
}

__host__ __device__ inline long long warp_floats(int n, int F, bool shared_x, bool has_last,
                                                 bool staged) {
  long long f = 4LL * col_ld(n) + round4(F * (F + 1)) + round4(2 * F);
  if (staged) {
    if (!shared_x) f += static_cast<long long>(F) * col_ld(n);
    if (has_last) f += col_ld(n);
  }
  return f;
}

// The fits a block and whether the designs are staged: as many fits (up
// to kMaxWarps) as fit the limit with the designs staged, else unstaged;
// the block's bytes, 0 when not even one unstaged fit does.
long long choose_layout(int n, int F, bool shared_x, bool has_last, long long limit,
                        int* fits, bool* staged) {
  for (int pass = 0; pass < 2; ++pass) {
    const bool st = pass == 0;
    for (int w = kMaxWarps; w >= 1; --w) {
      const long long bytes =
          (block_floats(n, F, shared_x, st) + w * warp_floats(n, F, shared_x, has_last, st)) *
          static_cast<long long>(sizeof(float));
      if (bytes <= limit) {
        *fits = w;
        *staged = st;
        return bytes;
      }
    }
  }
  return 0;
}

// A design column: x(i, j) = p[i * ld]
struct Col {
  const float* p;
  int ld;
};

// An item's design with the last column replaced by `last` where given.
// Staged: in shared memory, column j at x + j * ld (ld = col_ld(n)); else
// the row-major [n, F] design in device memory (ld = F). kF > 0: F = kF at
// compile time; 0: F = f.
template <int kF, bool kStaged>
struct Design {
  const float* x;
  const float* last;
  int ld;
  int f;
  __device__ __forceinline__ int F() const { return kF > 0 ? kF : f; }
  __device__ __forceinline__ Col col(int j) const {
    if (last != nullptr && j == F() - 1) return Col{last, 1};
    return kStaged ? Col{x + j * ld, 1} : Col{x + j, ld};
  }
  __device__ __forceinline__ float operator()(int i, int j) const {
    if (last != nullptr && j == F() - 1) return last[i];
    return kStaged ? x[j * ld + i] : x[i * ld + j];
  }
};

// Copy a row-major [n, F] design column by column into dst (column j at dst
// + j * ld), element e = t0, t0 + step, ... of the source.
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src, int n,
                                     int F, int t0, int step) {
  const int di = step / F;
  const int dj = step % F;
  int i = t0 / F;
  int j = t0 % F;
  for (int e = t0; e < n * F; e += step) {
    dst[j * ld + i] = src[e];
    i += di;
    j += dj;
    if (j >= F) {
      j -= F;
      ++i;
    }
  }
}

// eta or z of row i: sum over j of x(i, j) w[j], in order from 0
template <int kF, bool kStaged>
__device__ __forceinline__ float linpred(const Design<kF, kStaged>& d, int i, const float* w) {
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < d.F(); ++j) e += d(i, j) * w[j];
  return e;
}

// One term of a normal-equation entry: H's (x_j g) x_k or the rhs's x_j z,
// both computed and one selected (no branch in the rows' loop)
__device__ __forceinline__ float normal_term(bool hess, float xj, float xk, float g, float z) {
  const float h = (xj * g) * xk;
  const float r = xj * z;
  return hess ? h : r;
}

// One pass of the normal equations over the rows: lane slot u sums entry
// e0 + 32 u (e0 the lane's first of the pass) into A [F, F + 1]. Entries 0
// .. F(F+1)/2 - 1 are H's upper triangle row by row (mirrored below), the
// next F the right-hand side. The rows go kStep at a time, their loads
// ahead of the sums (16-byte loads of the staged columns), each sum still
// in row order.
template <int U, int kF, bool kStaged>
__device__ __forceinline__ void normal_pass(int e0, int n, int n_pairs,
                                            const Design<kF, kStaged>& d, const float* gw,
                                            const float* gz, float* A) {
  constexpr int kStep = 4;
  const int F = d.F();
  const int ld = F + 1;
  Col cj[U];
  Col ck[U];
  int jj[U];
  int kk[U];
  bool hess[U];
  Kahan s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = e0 + 32 * u;
    hess[u] = e < n_pairs;
    int j = 0;
    int k = 0;
    if (hess[u]) {
      int r = e;
      while (r >= F - j) {
        r -= F - j;
        ++j;
      }
      k = j + r;
    } else if (e < n_pairs + F) {
      j = e - n_pairs;
    }
    jj[u] = j;
    kk[u] = k;
    cj[u] = d.col(j);
    ck[u] = d.col(k);
  }
  int i = 0;
  if constexpr (kStaged) {
    for (; i + 4 <= n; i += 4) {
      const float4 g = *reinterpret_cast<const float4*>(gw + i);
      const float4 z = *reinterpret_cast<const float4*>(gz + i);
      float4 xj[U];
      float4 xk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xj[u] = *reinterpret_cast<const float4*>(cj[u].p + i);
        xk[u] = *reinterpret_cast<const float4*>(ck[u].p + i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) s[u].add(normal_term(hess[u], xj[u].x, xk[u].x, g.x, z.x));
#pragma unroll
      for (int u = 0; u < U; ++u) s[u].add(normal_term(hess[u], xj[u].y, xk[u].y, g.y, z.y));
#pragma unroll
      for (int u = 0; u < U; ++u) s[u].add(normal_term(hess[u], xj[u].z, xk[u].z, g.z, z.z));
#pragma unroll
      for (int u = 0; u < U; ++u) s[u].add(normal_term(hess[u], xj[u].w, xk[u].w, g.w, z.w));
    }
  }
  for (; i + kStep <= n; i += kStep) {
    float g[kStep];
    float z[kStep];
    float xj[U][kStep];
    float xk[U][kStep];
#pragma unroll
    for (int t = 0; t < kStep; ++t) {
      g[t] = gw[i + t];
      z[t] = gz[i + t];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xj[u][t] = cj[u].p[(i + t) * cj[u].ld];
        xk[u][t] = ck[u].p[(i + t) * ck[u].ld];
      }
    }
#pragma unroll
    for (int t = 0; t < kStep; ++t) {
#pragma unroll
      for (int u = 0; u < U; ++u) s[u].add(normal_term(hess[u], xj[u][t], xk[u][t], g[t], z[t]));
    }
  }
  for (; i < n; ++i) {
    const float g = gw[i];
    const float z = gz[i];
#pragma unroll
    for (int u = 0; u < U; ++u)
      s[u].add(normal_term(hess[u], cj[u].p[i * cj[u].ld], ck[u].p[i * ck[u].ld], g, z));
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = e0 + 32 * u;
    if (hess[u]) {
      A[jj[u] * ld + kk[u]] = s[u].sum;
      A[kk[u] * ld + jj[u]] = s[u].sum;
    } else if (e < n_pairs + F) {
      A[jj[u] * ld + F] = s[u].sum;
    }
  }
}

// w' = H^-1 rhs from A = [H | rhs] in shared memory, for any F <= kMaxF:
// rows over lanes, the pivot by a warp arg-max, one lane back-substitutes
// into nw. Returns true when the solve freezes the fit (a zero pivot or a
// non-finite w'), the same value in every lane.
__device__ bool solve_shared(float* A, int F, int lane, float* nw) {
  const int ld = F + 1;
  for (int k = 0; k < F; ++k) {
    // the first row of the strictly largest |A[r, k]|, r >= k: a NaN at
    // row k keeps row k (nothing is larger than it), a NaN below never
    // wins; keys are |A| + 1 as ordered bits, 0 for those NaNs
    unsigned key = 0u;
    unsigned row = 0xffffffffu;
    for (int r = k + lane; r < F; r += 32) {
      const float a = fabsf(A[r * ld + k]);
      const unsigned v = isnan(a) ? (r == k ? 0x7f800001u : 0u) : __float_as_uint(a) + 1u;
      if (row == 0xffffffffu || v > key) {
        key = v;
        row = r;
      }
    }
    const unsigned top = __reduce_max_sync(kFull, key);
    const int p = static_cast<int>(__reduce_min_sync(kFull, key == top ? row : 0xffffffffu));
    if (p != k) {
      for (int c = lane; c <= F; c += 32) {
        const float t = A[k * ld + c];
        A[k * ld + c] = A[p * ld + c];
        A[p * ld + c] = t;
      }
    }
    __syncwarp();
    const float piv = A[k * ld + k];
    if (piv == 0.0f) return true;
    const float inv = 1.0f / piv;
    for (int r = k + 1 + lane; r < F; r += 32) {
      const float mult = A[r * ld + k] * inv;
      for (int c = k + 1; c <= F; ++c) A[r * ld + c] = fmaf(-mult, A[k * ld + c], A[r * ld + c]);
    }
    __syncwarp();
  }
  bool bad = false;
  if (lane == 0) {
    for (int k = F - 1; k >= 0; --k) {
      float s = A[k * ld + F];
      for (int c = k + 1; c < F; ++c) s = fmaf(-A[k * ld + c], nw[c], s);
      nw[k] = s / A[k * ld + k];
      if (!isfinite(nw[k])) bad = true;
    }
  }
  return __shfl_sync(kFull, static_cast<int>(bad), 0) != 0;
}

// The same solve for F = kF <= kMaxRegF with A in registers, a column a
// lane (lane c holds A[0 .. F-1, c], c <= F), straight-line code with every
// register index static. Lane k scans its column for the pivot as the
// replaced kernel's one thread did; each lane swaps rows k and p in its own
// column; every lane takes the multipliers A[r, k] * (1 / piv) from lane k
// and updates its column; every lane back-substitutes the rows it gathers
// from the others, in the replaced kernel's fmaf order.
template <int kF>
__device__ __forceinline__ bool solve_regs(const float* A, int lane, float* nw) {
  constexpr int ld = kF + 1;
  float col[kF];
#pragma unroll
  for (int r = 0; r < kF; ++r) col[r] = lane <= kF ? A[r * ld + lane] : 0.0f;
#pragma unroll
  for (int k = 0; k < kF; ++k) {
    int p = k;
    float best = fabsf(col[k]);
#pragma unroll
    for (int r = k + 1; r < kF; ++r) {
      const float v = fabsf(col[r]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
    p = __shfl_sync(kFull, p, k);
    const float ck = col[k];
    float cp = ck;
#pragma unroll
    for (int r = k + 1; r < kF; ++r) {
      if (r == p) {
        cp = col[r];
        col[r] = ck;
      }
    }
    col[k] = cp;
    const float piv = __shfl_sync(kFull, col[k], k);
    if (piv == 0.0f) return true;
    const float inv = 1.0f / piv;
#pragma unroll
    for (int r = k + 1; r < kF; ++r) {
      const float mult = __shfl_sync(kFull, col[r], k) * inv;
      if (lane > k) col[r] = fmaf(-mult, col[k], col[r]);
    }
  }
  float x[kF];
  bool bad = false;
#pragma unroll
  for (int k = kF - 1; k >= 0; --k) {
    float s = __shfl_sync(kFull, col[k], kF);
#pragma unroll
    for (int c = k + 1; c < kF; ++c) s = fmaf(-__shfl_sync(kFull, col[k], c), x[c], s);
    x[k] = s / __shfl_sync(kFull, col[k], k);
    if (!isfinite(x[k])) bad = true;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kF; ++k) nw[k] = x[k];
  }
  return bad;
}

template <bool kStaged, int kF>
__global__ void __launch_bounds__(kMaxWarps * 32)
    irls_kernel(const float* __restrict__ X, long long x_item_stride,
                const float* __restrict__ last, const float* __restrict__ y_in, long long B,
                int n, int f, int max_iters, float g_floor, float eps_conv,
                float* __restrict__ w_out, float* __restrict__ err_out,
                int32_t* __restrict__ iters_out, float* __restrict__ ll_out,
                int8_t* __restrict__ stop_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int F = kF > 0 ? kF : f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool shared_x = x_item_stride == 0;
  const bool has_last = last != nullptr;
  const int ldn = col_ld(n);
  float* ys = smem;
  float* xblk = ys + ldn;
  float* eta = smem + block_floats(n, F, shared_x, kStaged) +
               warp * warp_floats(n, F, shared_x, has_last, kStaged);
  float* mu = eta + ldn;
  float* gw = mu + ldn;
  float* gz = gw + ldn;
  float* A = gz + ldn;  // [F, F + 1]: H | rhs
  float* w = A + round4(F * (F + 1));
  float* nw = w + F;
  float* xw = w + round4(2 * F);
  float* lw = xw + (shared_x ? 0 : F * ldn);

  if (kStaged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) ys[i] = y_in[i];
    if (shared_x) stage(xblk, ldn, X, n, F, threadIdx.x, blockDim.x);
  }
  const float* y = kStaged ? ys : y_in;
  __syncthreads();  // the one block barrier: a fit's steps are its warp's alone
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;

  Design<kF, kStaged> d;
  d.f = F;
  d.ld = kStaged ? ldn : F;
  if (kStaged) {
    d.x = xblk;
    if (!shared_x) {
      stage(xw, ldn, X + b * x_item_stride, n, F, lane, 32);
      d.x = xw;
    }
    d.last = nullptr;
    if (has_last) {
      const float* src = last + b * n;
      for (int i = lane; i < n; i += 32) lw[i] = src[i];
      d.last = lw;
    }
  } else {
    d.x = X + b * x_item_stride;
    d.last = has_last ? last + b * n : nullptr;
  }

  // lane l owns rows i = l (mod 32) of eta and mu in every pass
  for (int i = lane; i < n; i += 32) {
    const float m0 = (y[i] + 0.5f) / 2.0f;
    mu[i] = m0;
    eta[i] = logf(m0 / (1.0f - m0));
  }
  for (int j = lane; j < F; j += 32) w[j] = 1.0f;
  float prev = 1e18f;
  float err = 1e18f;
  int iters = 0;
  int stop = 0;
  const int n_pairs = F * (F + 1) / 2;
  const int n_ent = n_pairs + F;
  __syncwarp();

  while (true) {
    float se[kParts];
    bool any_good = false;
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      float p = 0.0f;
      for (int i = lane + 32 * q; i < n; i += kStride) {
        const float m = mu[i];
        const float g = m * (1.0f - m);
        const bool good = g > g_floor;
        const float dy = y[i] - m;
        p += dy * dy;
        any_good |= good;
        gw[i] = good ? g : 0.0f;
        gz[i] = good ? g * eta[i] + dy : 0.0f;
      }
      se[q] = p;
    }
    const float error = stride_sum(se, n) / static_cast<float>(n);
    const bool none_good = !__any_sync(kFull, any_good);
    err = error;
    if (fabsf(error - prev) < eps_conv || none_good) {
      stop = 0;
      break;
    }
    __syncwarp();  // gw, gz

    for (int eb = 0; eb < n_ent; eb += 32 * kEntries) {
      switch (min(kEntries, (n_ent - eb + 31) / 32)) {
        case 1: normal_pass<1>(eb + lane, n, n_pairs, d, gw, gz, A); break;
        case 2: normal_pass<2>(eb + lane, n, n_pairs, d, gw, gz, A); break;
        case 3: normal_pass<3>(eb + lane, n, n_pairs, d, gw, gz, A); break;
        default: normal_pass<kEntries>(eb + lane, n, n_pairs, d, gw, gz, A); break;
      }
    }
    __syncwarp();  // A

    bool frozen;
    if constexpr (kF > 0) {
      frozen = solve_regs<kF>(A, lane, nw);
    } else {
      frozen = solve_shared(A, F, lane, nw);
    }
    __syncwarp();  // nw

    prev = error;
    ++iters;
    if (frozen) {
      stop = 1;
      break;
    }
    if (iters >= max_iters) {
      stop = 2;
      break;
    }
    for (int j = lane; j < F; j += 32) w[j] = nw[j];
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const float e = linpred(d, i, w);
      eta[i] = e;
      mu[i] = 1.0f / (1.0f + expf(-e));
    }
  }

  // log-likelihood of the final weights
  float part[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    float s = 0.0f;
    for (int i = lane + 32 * q; i < n; i += kStride) {
      const float z = linpred(d, i, w);
      s += -(y[i] * softplus(-z) + (1.0f - y[i]) * softplus(z));
    }
    part[q] = s;
  }
  const float ll = stride_sum(part, n);
  for (int j = lane; j < F; j += 32) w_out[b * F + j] = w[j];
  if (lane == 0) {
    err_out[b] = err;
    iters_out[b] = iters;
    ll_out[b] = ll;
    stop_out[b] = static_cast<int8_t>(stop);
  }
}

}  // namespace

KMD_API int kmd_irls_max_features() { return kMaxF; }

// The launch's layout at n samples and F features: *fits fits a block,
// *staged 1 when the designs are staged in shared memory; returns the
// block's shared-memory bytes within smem_limit, 0 (and *fits 0) when not
// even one fit a block fits. shared_design: one X[0] for every item.
KMD_API long long kmd_irls_layout(int n, int F, int shared_design, int has_last,
                                  long long smem_limit, int* fits, int* staged) {
  int w = 0;
  bool st = false;
  const long long bytes =
      n > 0 && F > 0 ? choose_layout(n, F, shared_design != 0, has_last != 0, smem_limit, &w, &st)
                     : 0;
  *fits = w;
  *staged = st ? 1 : 0;
  return bytes;
}

KMD_API int kmd_irls(const float* X, long long x_item_stride, const float* last,
                     const float* y, long long B, int n, int F, int max_iters,
                     float g_floor, float eps_conv, long long smem_limit, float* w, float* err,
                     int32_t* iters, float* ll, int8_t* stop, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || F <= 0 || F > kMaxF) return static_cast<int>(cudaErrorInvalidValue);
  int fits = 0;
  bool staged = false;
  const long long smem =
      choose_layout(n, F, x_item_stride == 0, last != nullptr, smem_limit, &fits, &staged);
  const long long grid = smem > 0 ? (B + fits - 1) / fits : 0;
  if (grid <= 0 || grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(const float*, long long, const float*, const float*, long long, int,
                          int, int, float, float, float*, float*, int32_t*, float*, int8_t*);
  static const Kernel kByF[kMaxRegF + 1] = {
      nullptr,                 irls_kernel<true, 1>,  irls_kernel<true, 2>,
      irls_kernel<true, 3>,    irls_kernel<true, 4>,  irls_kernel<true, 5>,
      irls_kernel<true, 6>,    irls_kernel<true, 7>,  irls_kernel<true, 8>,
      irls_kernel<true, 9>,    irls_kernel<true, 10>, irls_kernel<true, 11>,
      irls_kernel<true, 12>,   irls_kernel<true, 13>, irls_kernel<true, 14>,
      irls_kernel<true, 15>,   irls_kernel<true, 16>};
  const Kernel kernel = !staged          ? irls_kernel<false, 0>
                        : F <= kMaxRegF ? kByF[F]
                                        : irls_kernel<true, 0>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(grid), 32 * fits, static_cast<size_t>(smem), stream>>>(
      X, x_item_stride, last, y, B, n, F, max_iters, g_floor, eps_conv, w, err, iters, ll, stop);
  return static_cast<int>(cudaGetLastError());
}
