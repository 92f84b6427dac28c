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
// thread block fits one item and stops when that item stops. The block keeps
// eta, mu and the masked g and g z in shared memory ([4, n] floats) with the
// augmented [F, F + 1] system; X is read from device memory on each pass
// (the shared design of popstrat's alt fits stays in L1/L2). Threads split
// the F (F + 1) / 2 + F Hessian and right-hand-side entries, each a
// compensated sum over n in order, then the rows of each elimination step;
// one thread picks the pivot and back-substitutes (F <= 64).
//
// Bound on the H100: the item's flops, ~n F^2 a pass for the Hessian and F^3
// / 3 for the solve, with the n-long sums in order on one thread each; the
// alt fits of 10^4 k-mers at n = 20, F = 5 are ~10^8 flops in all.
#include "kmd_common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 64;

// Sum of v over the block, the same value in every thread (one fixed order).
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

// Compensated sum: one thread's n-long sums stay within a few ulp of the
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

__global__ void irls_kernel(const float* __restrict__ X, long long x_item_stride,
                            const float* __restrict__ last,
                            const float* __restrict__ y, int n, int F,
                            int max_iters, float g_floor, float eps_conv,
                            float* __restrict__ w_out, float* __restrict__ err_out,
                            int32_t* __restrict__ iters_out,
                            float* __restrict__ ll_out,
                            int8_t* __restrict__ stop_out) {
  extern __shared__ float smem[];
  float* eta = smem;
  float* mu = eta + n;
  float* gw = mu + n;
  float* gz = gw + n;
  float* A = gz + n;  // [F, F + 1]: H | rhs
  float* w = A + F * (F + 1);
  float* nw = w + F;
  float* mult = nw + F;
  float* red = mult + F;
  __shared__ int s_piv;
  __shared__ int s_bad;

  const int tid = threadIdx.x;
  const int ld = F + 1;
  const long long b = blockIdx.x;
  const float* Xb = X + b * x_item_stride;
  const float* lb = last != nullptr ? last + b * static_cast<long long>(n) : nullptr;
  auto x = [&](int i, int j) -> float {
    return (lb != nullptr && j == F - 1) ? lb[i] : Xb[static_cast<long long>(i) * F + j];
  };

  for (int i = tid; i < n; i += kThreads) {
    const float m0 = (y[i] + 0.5f) / 2.0f;
    mu[i] = m0;
    eta[i] = logf(m0 / (1.0f - m0));
  }
  for (int j = tid; j < F; j += kThreads) w[j] = 1.0f;
  float prev = 1e18f;
  float err = 1e18f;
  int iters = 0;
  int stop = 0;
  __syncthreads();

  const int n_pairs = F * (F + 1) / 2;
  while (true) {
    float se = 0.0f;
    float n_good = 0.0f;
    for (int i = tid; i < n; i += kThreads) {
      const float m = mu[i];
      const float g = m * (1.0f - m);
      const bool good = g > g_floor;
      const float d = y[i] - m;
      se += d * d;
      n_good += good ? 1.0f : 0.0f;
      gw[i] = good ? g : 0.0f;
      gz[i] = good ? g * eta[i] + d : 0.0f;
    }
    const float error = block_sum(se, red) / static_cast<float>(n);
    const bool none_good = block_sum(n_good, red) == 0.0f;
    err = error;
    if (fabsf(error - prev) < eps_conv || none_good) {
      stop = 0;
      break;
    }

    // augmented system [H | rhs]; gw and gz were written before block_sum's syncs
    for (int e = tid; e < n_pairs + F; e += kThreads) {
      if (e < n_pairs) {
        int j = 0;
        int r = e;
        while (r >= F - j) {
          r -= F - j;
          ++j;
        }
        const int k = j + r;
        Kahan s;
        for (int i = 0; i < n; ++i) s.add((x(i, j) * gw[i]) * x(i, k));
        A[j * ld + k] = s.sum;
        A[k * ld + j] = s.sum;
      } else {
        const int j = e - n_pairs;
        Kahan s;
        for (int i = 0; i < n; ++i) s.add(x(i, j) * gz[i]);
        A[j * ld + F] = s.sum;
      }
    }
    __syncthreads();

    bool singular = false;
    for (int k = 0; k < F; ++k) {
      if (tid == 0) {
        int p = k;
        float best = fabsf(A[k * ld + k]);
        for (int r = k + 1; r < F; ++r) {
          const float v = fabsf(A[r * ld + k]);
          if (v > best) {
            best = v;
            p = r;
          }
        }
        s_piv = p;
      }
      __syncthreads();
      const int p = s_piv;
      if (p != k) {
        for (int c = tid; c <= F; c += kThreads) {
          const float t = A[k * ld + c];
          A[k * ld + c] = A[p * ld + c];
          A[p * ld + c] = t;
        }
      }
      __syncthreads();
      const float piv = A[k * ld + k];
      if (piv == 0.0f) {
        singular = true;  // the same value in every thread
        break;
      }
      const float inv = 1.0f / piv;
      for (int r = k + 1 + tid; r < F; r += kThreads) mult[r] = A[r * ld + k] * inv;
      __syncthreads();
      const int cols = F - k;  // columns k + 1 .. F
      for (int e = tid; e < (F - k - 1) * cols; e += kThreads) {
        const int r = k + 1 + e / cols;
        const int c = k + 1 + e % cols;
        A[r * ld + c] = fmaf(-mult[r], A[k * ld + c], A[r * ld + c]);
      }
      __syncthreads();
    }
    if (!singular && tid == 0) {
      bool bad = false;
      for (int k = F - 1; k >= 0; --k) {
        float s = A[k * ld + F];
        for (int c = k + 1; c < F; ++c) s = fmaf(-A[k * ld + c], nw[c], s);
        nw[k] = s / A[k * ld + k];
        if (!isfinite(nw[k])) bad = true;
      }
      s_bad = bad;
    }
    __syncthreads();

    prev = error;
    ++iters;
    if (singular || s_bad) {
      stop = 1;
      break;
    }
    if (iters >= max_iters) {
      stop = 2;
      break;
    }
    for (int j = tid; j < F; j += kThreads) w[j] = nw[j];
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      float e = 0.0f;
      for (int j = 0; j < F; ++j) e += x(i, j) * w[j];
      eta[i] = e;
      mu[i] = 1.0f / (1.0f + expf(-e));
    }
    __syncthreads();
  }

  // log-likelihood of the final weights: z = X[:, :F-1] w[:F-1] + X[:, F-1] w[F-1]
  float s = 0.0f;
  for (int i = tid; i < n; i += kThreads) {
    float z = 0.0f;
    for (int j = 0; j < F - 1; ++j) z += x(i, j) * w[j];
    z += x(i, F - 1) * w[F - 1];
    s += -(y[i] * softplus(-z) + (1.0f - y[i]) * softplus(z));
  }
  const float ll = block_sum(s, red);
  for (int j = tid; j < F; j += kThreads) w_out[b * F + j] = w[j];
  if (tid == 0) {
    err_out[b] = err;
    iters_out[b] = iters;
    ll_out[b] = ll;
    stop_out[b] = static_cast<int8_t>(stop);
  }
}

}  // namespace

KMD_API int kmd_irls_max_features() { return kMaxF; }

KMD_API long long kmd_irls_smem_bytes(int n, int F) {
  return static_cast<long long>(4 * n + F * (F + 1) + 3 * F + kWarps) * sizeof(float);
}

KMD_API int kmd_irls(const float* X, long long x_item_stride, const float* last,
                     const float* y, long long B, int n, int F, int max_iters,
                     float g_floor, float eps_conv, float* w, float* err,
                     int32_t* iters, float* ll, int8_t* stop, cudaStream_t stream) {
  if (B <= 0 || B > 0x7FFFFFFFLL || n <= 0 || F <= 0 || F > kMaxF)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = kmd_irls_smem_bytes(n, F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        irls_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  irls_kernel<<<static_cast<unsigned>(B), kThreads, static_cast<size_t>(smem), stream>>>(
      X, x_item_stride, last, y, n, F, max_iters, g_floor, eps_conv, w, err, iters, ll,
      stop);
  return static_cast<int>(cudaGetLastError());
}
