// K-GRAM: the exact integer Gram X^T X of a [B, S] 0/1 matrix.
//
// Replaces kmdiff_tpu/ops/pca.py::_int_gram_block (pca.py:48), the device
// half of _int_gram: the Eigenstrat PCA decomposes the normalised Gram into
// per-row-sum-group integer aggregates, so the PCs are bit-identical
// wherever the integers are exact. The TPU computed them as an f32 matmul in
// tiles below 2^24 rows (the bound of f32 integer exactness), and sent small
// groups to the host because a dispatch was expensive. Here the arithmetic
// is integer from the start, exact at any B, and every group runs on the
// card (popstrat makes a call a row-sum group, 18 a command at the bench
// cohort's 20 samples).
//
// Two forms, by the number of samples:
//
// S <= kFusedMaxS (256): one kernel, one device operation a call. It is
// launched cooperatively (every block resident at once, two an SM). Block z
// owns a contiguous range of 32-row words of X and all sample pairs:
//   1. bit packing: the range passes through shared memory in stages of
//      ~16 KB of contiguous rows, kStages of them in flight as 16-byte
//      cp.async copies (only the chunks that X's own ends cut are copied
//      byte by byte, so nothing reads outside X and no thread waits on a
//      plain load mid-stream). A warp packs 32 rows x 32 samples: lane
//      4q + g reads samples 4q..4q+3 of rows 8g..8g+7 (one 32-bit load a
//      row where X's rows are 4-byte aligned, bytes otherwise), marks each
//      nonzero byte's bit 7 in two operations and moves it to bit g' of its
//      byte (8 rows a byte); a 4 x 4 byte transpose across the four lanes of
//      q (two shuffles, two byte permutes) leaves lane 4q + g with sample
//      4q + g's word. The words go to `bits`, word-major ([word][sample], S
//      padded with zero words to Sp, a multiple of MT, and a row stride of
//      Sp or Sp + 4 words, an odd multiple of 4, so that 8 lanes' 16-byte
//      loads of 8 rows fall on distinct banks). No bit matrix touches
//      global memory. A range larger than the packed words' shared budget
//      (47 words at S = 256) runs in super-chunks.
//   2. popcounts: the upper triangle of the Sp x Sp pairs in MT x MT
//      micro-tiles (MT = 4 up to 32 samples, else 8), a thread a micro-tile:
//      per word, 2 MT / 4 16-byte shared loads feed MT^2 AND + POPC + ADD
//      into u32 registers. With fewer micro-tiles than threads, Q = 2..32
//      consecutive lanes share one micro-tile's words and sum by shuffles.
//      A micro-tile's sums go to the block's slice of `scratch` ([block]
//      [micro-tile][MT^2] u32, at most 132 KB a block at S = 256; a later
//      super-chunk adds to them): exact, since a block holds fewer than
//      2^32 rows.
//   3. G is zeroed by the blocks as they start; one grid-wide sync
//      (cooperative_groups); then the fold: a warp sums 32 entries over 16
//      blocks' partials in u64, all 16 loads in flight, and adds each sum to
//      G[i, j] and G[j, i] with a 64-bit atomic (exact, so the order does
//      not matter; pairs of padding samples are dropped). No memset and no
//      second launch.
//
// S > kFusedMaxS: the fused form does not scale there. A block's partial
// sums grow as S^2 (the grid would shrink below the card from ~350 samples
// on) and a 32-row word's packed samples as S (they outgrow the shared
// budget past ~12,280). So three device operations, at any S: a memset of
// G; pack_bits (X -> bits [S, W] u32 in global memory, a thread a word,
// neighbouring threads on neighbouring samples of a row); and the tiled
// gram (16 x 16 sample tiles on or above the diagonal, 32-word chunks of
// both tiles' rows staged in shared memory, the words split over
// blockIdx.z so that the grid fills the card, each block adding its tile
// to G and its mirror with 64-bit atomics). `scratch` holds the bits.
//
// The tensor cores' 1-bit mma is not used: no share of the bound below
// counts it.
//
// Bound on the H100: at S = 20 the bytes (X read once, ~21 MB at [2^20,
// 20], 6.3 us at 3.35 TB/s); at S = 200 the popcounts, S(S+1)/2 x B/32
// (1.65e8 at [2^18, 200], 39 us at 16 a clock an SM). In the fused form
// the packing costs ~2 operations a byte of X; the popcounts take one
// 16-byte shared load per 2 MT of them, each with an AND and an ADD on the
// integer pipe; a block packs and then counts, so only its neighbour on
// the SM overlaps the two; the partial sums add 4 bytes x MT^2 a
// micro-tile a block (22 MB at [2^18, 200], mostly in L2).
#include <algorithm>

#include <cooperative_groups.h>

#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kStageBytes = 16384;           // rows of X a stage, at most
constexpr int kStageBuf = kStageBytes + 32;  // + the chunks at the stage's ends
constexpr int kStages = 3;
constexpr int kBitsBytes = 48 * 1024;        // packed words of a super-chunk
constexpr int kSmem = kStages * kStageBuf + kBitsBytes;
constexpr int kMinWords = 4;                 // 32-row words a block, at least
constexpr int kSmallS = 32;                  // up to here, 4 x 4 micro-tiles
constexpr int kFoldBlocks = 16;              // blocks' partials a fold task sums
constexpr int kFusedMaxS = 256;              // samples of the fused form, at most
// the tiled form
constexpr int kTile = 16;
constexpr int kChunk = 32;  // words of each tile row staged a step
constexpr int kPackThreads = 256;
constexpr long long kTargetBlocks = 528;  // a few per SM of the 132

struct Plan {
  int mt;          // micro-tile side: 4 or 8
  int Sp;          // S rounded up to mt
  int stride;      // words a packed row
  int nb;          // micro-tile rows: Sp / mt
  int M;           // micro-tiles on or above the diagonal
  int Q;           // lanes sharing one micro-tile's words (1..32, a power of 2)
  long long W;     // 32-row words of X
  int blocks;      // the grid
  int wsc;         // words a super-chunk, at most
  int stage_rows;  // rows a stage, a multiple of 32
};

struct Args {
  const uint8_t* X;
  long long B;
  int S;
  Plan p;
  uint32_t* partial;  // [blocks][M * mt^2]
  int64_t* gram;      // [S, S]
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// micro-tile m -> (ib, jb), row-major over the upper triangle of nb x nb
__device__ __forceinline__ void tile_of(int m, int nb, int& ib, int& jb) {
  ib = 0;
  while (m >= nb - ib) {
    m -= nb - ib;
    ++ib;
  }
  jb = ib + m;
}

// Issue the copies of X's bytes [b0, b1) into buf, byte i at slot
// ((X + b0) & 15) + i - b0.
__device__ void load_stage(uint8_t* buf, const uint8_t* X, long long n_bytes,
                           long long b0, long long b1) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(X);
  const uintptr_t lo = (base + b0) & ~static_cast<uintptr_t>(15);
  const int n_chunks = static_cast<int>((base + b1 - lo + 15) >> 4);
  for (int j = threadIdx.x; j < n_chunks; j += kThreads) {
    const uintptr_t at = lo + 16 * static_cast<uintptr_t>(j);
    if (at >= base && at + 16 <= base + n_bytes) {
      cp_async16(buf + 16 * j, reinterpret_cast<const void*>(at));
    } else {
      for (int b = 0; b < 16; ++b) {
        const uintptr_t q = at + b;
        if (q >= base + b0 && q < base + b1)
          buf[16 * j + b] = *reinterpret_cast<const uint8_t*>(q);
      }
    }
  }
}

// The high bit of each byte of x set where the byte is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// Samples c4 .. c4 + 3 of a row at p, bytes in order (those at or past S
// zero).
__device__ __forceinline__ uint32_t quad_at(const uint8_t* p, bool by_word, int c4, int S) {
  if (by_word) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (c4 + b < S) x |= static_cast<uint32_t>(p[b]) << (8 * b);
  return x;
}

// Pack the n_rows rows of a stage (X's rows rs .., rs a multiple of 32,
// byte (r, c) at slot off + (r - rs) S + c of buf) into the super-chunk's
// words from c_lo on: every word of the stage, samples 0 .. Sp - 1.
__device__ void pack_stage(const uint8_t* buf, int off, long long rs, int n_rows, int S,
                           long long c_lo, const Plan& p, uint32_t* bits) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 2;  // this lane's quad of samples in a slab of 8 quads
  const int g = lane & 3;   // its byte of rows: 8g .. 8g + 7
  const bool by_word = ((off | S) & 3) == 0;
  const int n_slabs = (S + 31) / 32;
  uint32_t* dst = bits + (rs / 32 - c_lo) * p.stride;
  const int n_items = (n_rows + 31) / 32 * n_slabs;
  const uint32_t sel1 = g < 2 ? 0x5410u : 0x3276u;
  const uint32_t sel2 = (g & 1) ? 0x3715u : 0x6240u;
  for (int item = threadIdx.x >> 5; item < n_items; item += kWarps) {
    const int wi = item / n_slabs;
    const int c4 = (item % n_slabs) * 32 + 4 * q;  // first sample of the quad
    const int r0 = 32 * wi + 8 * g;                // stage row of this lane's byte
    const uint8_t* col = buf + off + c4;
    uint32_t acc = 0;
    if (c4 < S) {
      if (r0 + 8 <= n_rows) {  // the usual case: all 8 rows here
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jj = (j + 2 * g) & 7;  // staggered over the bank rows
          acc |= nonzero_bytes(quad_at(col + (r0 + jj) * S, by_word, c4, S)) >> (7 - jj);
        }
      } else {
        for (int jj = 0; jj < 8; ++jj)
          if (r0 + jj < n_rows)
            acc |= nonzero_bytes(quad_at(col + (r0 + jj) * S, by_word, c4, S)) >> (7 - jj);
      }
    }
    // lane 4q + g: byte b holds sample c4 + b's rows 8g..; transpose the
    // four lanes of q so that lane 4q + g holds sample c4 + g's 32 rows
    const uint32_t r1 = __byte_perm(acc, __shfl_xor_sync(0xFFFFFFFFu, acc, 2), sel1);
    const uint32_t word = __byte_perm(r1, __shfl_xor_sync(0xFFFFFFFFu, r1, 1), sel2);
    const int c = c4 + g;
    if (c < p.Sp) dst[wi * p.stride + c] = word;
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) gram_kernel(const Args a) {
  constexpr int kPairs = MT * MT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stages = smem;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kStages * kStageBuf);
  const Plan& p = a.p;
  const int S = a.S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long n_bytes = a.B * S;
  const long long E = static_cast<long long>(p.M) * kPairs;  // entries a block
  uint32_t* mine = a.partial + blockIdx.x * E;

  // G starts at zero; the fold adds into it after the grid-wide sync
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + tid;
       e < static_cast<long long>(S) * S; e += static_cast<long long>(gridDim.x) * kThreads)
    a.gram[e] = 0;

  // this block's words, in super-chunks of at most p.wsc
  const long long w_lo = p.W * blockIdx.x / gridDim.x;
  const long long w_hi = p.W * (blockIdx.x + 1) / gridDim.x;
  const long long n_sc = (w_hi - w_lo + p.wsc - 1) / p.wsc;
  const long long per_sc = (w_hi - w_lo + n_sc - 1) / n_sc;

  for (long long sc = 0; sc < n_sc; ++sc) {
    const long long c_lo = w_lo + sc * per_sc;
    const long long c_hi = min(w_hi, c_lo + per_sc);
    const int n_words = static_cast<int>(c_hi - c_lo);
    const long long row_lo = 32 * c_lo;
    const long long row_hi = min(a.B, 32 * c_hi);
    const int n_stages =
        static_cast<int>((row_hi - row_lo + p.stage_rows - 1) / p.stage_rows);

    // 1. pack, kStages - 1 stages ahead
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_stages) {
        const long long r = row_lo + static_cast<long long>(st) * p.stage_rows;
        load_stage(stages + st * kStageBuf, a.X, n_bytes, r * S,
                   min(row_hi, r + p.stage_rows) * S);
      }
      cp_async_commit();
    }
    for (int st = 0; st < n_stages; ++st) {
      const int ahead = st + kStages - 1;
      if (ahead < n_stages) {
        const long long r = row_lo + static_cast<long long>(ahead) * p.stage_rows;
        load_stage(stages + (ahead % kStages) * kStageBuf, a.X, n_bytes, r * S,
                   min(row_hi, r + p.stage_rows) * S);
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const long long rs = row_lo + static_cast<long long>(st) * p.stage_rows;
      const int off = static_cast<int>((reinterpret_cast<uintptr_t>(a.X) + rs * S) & 15);
      pack_stage(stages + (st % kStages) * kStageBuf, off, rs,
                 static_cast<int>(min(row_hi - rs, static_cast<long long>(p.stage_rows))), S,
                 c_lo, p, bits);
      __syncthreads();
    }

    // 2. popcounts of the micro-tiles over this super-chunk's words
    const int Q = p.Q;
    const int q = tid % Q;
    for (int m0 = 0; m0 < p.M; m0 += kThreads / Q) {
      const int m = m0 + tid / Q;
      const bool has = m < p.M;
      uint32_t acc[kPairs];
#pragma unroll
      for (int e = 0; e < kPairs; ++e) acc[e] = 0;
      if (has) {
        int ib, jb;
        tile_of(m, p.nb, ib, jb);
        const uint32_t* ra = bits + MT * ib;
        const uint32_t* rb = bits + MT * jb;
        for (int w = q; w < n_words; w += Q) {
          uint32_t av[MT];
          uint32_t bv[MT];
#pragma unroll
          for (int v = 0; v < MT / 4; ++v) {
            const uint4 x = *reinterpret_cast<const uint4*>(ra + w * p.stride + 4 * v);
            const uint4 y = *reinterpret_cast<const uint4*>(rb + w * p.stride + 4 * v);
            av[4 * v] = x.x, av[4 * v + 1] = x.y, av[4 * v + 2] = x.z, av[4 * v + 3] = x.w;
            bv[4 * v] = y.x, bv[4 * v + 1] = y.y, bv[4 * v + 2] = y.z, bv[4 * v + 3] = y.w;
          }
#pragma unroll
          for (int x = 0; x < MT; ++x)
#pragma unroll
            for (int y = 0; y < MT; ++y) acc[x * MT + y] += __popc(av[x] & bv[y]);
        }
      }
      if (Q > 1) {  // one round (M * Q <= kThreads): the whole warp is here
#pragma unroll
        for (int e = 0; e < kPairs; ++e)
          for (int o = Q / 2; o > 0; o /= 2) acc[e] += __shfl_xor_sync(0xFFFFFFFFu, acc[e], o);
      }
      if (has && q == 0) {
        uint4* dst = reinterpret_cast<uint4*>(mine + static_cast<long long>(m) * kPairs);
#pragma unroll
        for (int v = 0; v < kPairs / 4; ++v) {
          uint4 s = make_uint4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
          if (sc > 0) {
            const uint4 old = dst[v];
            s.x += old.x;
            s.y += old.y;
            s.z += old.z;
            s.w += old.w;
          }
          dst[v] = s;
        }
      }
    }
    __syncthreads();  // before the next super-chunk packs over bits
  }

  // 3. every block's partial sums (and G's zeros) are in: a warp sums 32
  // entries over kFoldBlocks blocks, all loads in flight, and adds each
  // sum to G[i, j] and G[j, i]
  cooperative_groups::this_grid().sync();
  const long long n_groups = (E + 31) / 32;
  const long long n_tasks = n_groups * ((gridDim.x + kFoldBlocks - 1) / kFoldBlocks);
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long task = static_cast<long long>(blockIdx.x) * kWarps + warp; task < n_tasks;
       task += n_warps) {
    const long long e = 32 * (task % n_groups) + lane;
    const int z0 = static_cast<int>(task / n_groups) * kFoldBlocks;
    if (e >= E) continue;
    unsigned long long s = 0;
#pragma unroll
    for (int z = 0; z < kFoldBlocks; ++z)
      if (z0 + z < gridDim.x) s += __ldcg(a.partial + static_cast<long long>(z0 + z) * E + e);
    int ib, jb;
    tile_of(static_cast<int>(e / kPairs), p.nb, ib, jb);
    const int x = static_cast<int>(e % kPairs) / MT;
    const int y = static_cast<int>(e % MT);
    const int i = MT * ib + x;
    const int j = MT * jb + y;
    if (s && i < S && j < S && (ib < jb || x <= y)) {
      unsigned long long* G = reinterpret_cast<unsigned long long*>(a.gram);
      atomicAdd(G + static_cast<long long>(i) * S + j, s);
      if (i != j) atomicAdd(G + static_cast<long long>(j) * S + i, s);
    }
  }
}

// blocks an SM of gram_kernel<MT> at kSmem on the current card, its
// shared-memory attribute set there (0 on a CUDA error)
struct Residency {
  int sms;
  int per_sm;
};

template <int MT>
int resident_blocks(int* n_sms) {
  static kmd::PerDevice<Residency> residency_of;
  Residency r{0, 0};
  const int rc = residency_of.get(
      [](int dev, Residency* out) {
        cudaError_t err = cudaDeviceGetAttribute(&out->sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
          err = cudaFuncSetAttribute(gram_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kSmem);
        if (err == cudaSuccess)
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out->per_sm, gram_kernel<MT>,
                                                              kThreads, kSmem);
        return static_cast<int>(err);
      },
      &r);
  *n_sms = r.sms;
  return rc != 0 ? 0 : r.per_sm;
}

// The fused form's launch plan for a [B, S] matrix, S <= kFusedMaxS (0 on
// success).
int plan_for(long long B, int S, Plan* p) {
  if (S <= 0 || B <= 0 || S > kFusedMaxS) return static_cast<int>(cudaErrorInvalidValue);
  p->mt = S <= kSmallS ? 4 : 8;
  p->Sp = (S + p->mt - 1) / p->mt * p->mt;
  p->stride = p->Sp % 8 == 0 ? p->Sp + 4 : p->Sp;
  p->nb = p->Sp / p->mt;
  p->M = p->nb * (p->nb + 1) / 2;
  int Q = 1;
  while (Q < 32 && p->M * Q * 2 <= kThreads) Q *= 2;
  p->Q = Q;
  p->W = (B + 31) / 32;
  p->wsc = kBitsBytes / (4 * p->stride);
  if (p->wsc < 1) return static_cast<int>(cudaErrorInvalidValue);
  p->stage_rows = kStageBytes / (32 * S) * 32;  // whole words: 32 S <= kStageBytes
  int n_sms = 0;
  const int per_sm = p->mt == 4 ? resident_blocks<4>(&n_sms) : resident_blocks<8>(&n_sms);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = std::min(static_cast<long long>(n_sms) * per_sm,
                                    (p->W + kMinWords - 1) / kMinWords);
  p->blocks = static_cast<int>(std::max(1ll, blocks));
  // a block's rows stay below 2^32, so its u32 sums are exact
  if ((p->W + p->blocks - 1) / p->blocks >= (1ll << 27))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The tiled form (S > kFusedMaxS): bit w of word r of sample s is
// X[32w + r, s] != 0.
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

__global__ void tiled_gram_kernel(const uint32_t* __restrict__ bits, int S, long long W,
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

int tiled_gram(const uint8_t* X, long long B, int S, uint32_t* bits, int64_t* gram,
               cudaStream_t stream) {
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
  tiled_gram_kernel<<<dim3(static_cast<unsigned>(t), static_cast<unsigned>(t),
                           static_cast<unsigned>(z)),
                      dim3(kTile, kTile), 0, stream>>>(
      bits, S, W, per, reinterpret_cast<unsigned long long*>(gram));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u32 words of the scratch that kmd_int_gram takes for a [B, S] matrix: the
// fused form's partial sums, or the tiled form's bits (-1 for a shape it
// refuses)
KMD_API long long kmd_int_gram_scratch_words(long long B, int S) {
  if (S <= 0 || B <= 0) return -1;
  if (S > kFusedMaxS) return static_cast<long long>(S) * ((B + 31) / 32);
  Plan p;
  if (plan_for(B, S, &p) != 0) return -1;
  return static_cast<long long>(p.blocks) * p.M * p.mt * p.mt;
}

// X [B, S] u8 (row-major, any byte offset; nonzero = 1), scratch of
// kmd_int_gram_scratch_words u32, gram [S, S] int64 (every entry written).
KMD_API int kmd_int_gram(const uint8_t* X, long long B, int S, uint32_t* scratch,
                         int64_t* gram, cudaStream_t stream) {
  if (S > kFusedMaxS && B > 0) return tiled_gram(X, B, S, scratch, gram, stream);
  Args a;
  const int rc = plan_for(B, S, &a.p);
  if (rc != 0) return rc;
  a.X = X;
  a.B = B;
  a.S = S;
  a.partial = scratch;
  a.gram = gram;
  void* args[] = {&a};
  const void* fn = a.p.mt == 4 ? reinterpret_cast<const void*>(gram_kernel<4>)
                               : reinterpret_cast<const void*>(gram_kernel<8>);
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(a.p.blocks), dim3(kThreads), args,
                                                kSmem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
