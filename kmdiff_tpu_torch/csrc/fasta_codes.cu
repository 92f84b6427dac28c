// K-FASTA: a FASTA or FASTQ file's raw bytes -> the 2-bit code stream that
// the count reads.
//
// Replaces no TPU kernel. The JAX package decodes on the host
// (kmdiff_tpu/io/fasta.py::flat_codes, numpy passes over the file), and so
// did the port until this kernel: in the fused `run` that host decode took
// 95-97% of the sample threads' time and left the card idle 94-97% of a job
// (PERF.md). Here the host only reads the file into page-locked memory; its
// bytes cross to the card in one copy and are decoded there.
//
// Contract: flat_codes' output, byte for byte, for a file whose first byte
// is '>' (FASTA) or '@' (FASTQ; `fastq` says which):
//   * ACGTacgt -> (b >> 1) & 3 (core/kmer.py::_CODE); every other byte,
//     '\r' included, INVALID (0xFF);
//   * FASTA: every byte of a line whose first byte is '>' INVALID;
//     FASTQ: every byte of lines 0, 2 and 3 mod 4 INVALID;
//   * every '\n' dropped: byte i lands at i - (newlines before i).
// Two results go to page-locked host memory: the number of codes, and
// whether the file is strict (FASTQ: its line count a multiple of 4, lines
// 0 mod 4 starting with '@', lines 2 mod 4 with '+'; FASTA: always). A file
// that is not strict is redone by the caller's record parser, as flat_codes
// does.
//
// One single-pass kernel; a block owns one tile of 8192 bytes (512 threads
// x 16 bytes, one 16-byte load each):
//   1. each thread folds its 16 bytes into one scan value (Scan below):
//      its newline count, the state of its last line start (a '>' line or
//      not) and, for FASTQ, a 4-bit mask of the strict-layout faults of the
//      lines that start in it, one bit for each count of lines before it
//      mod 4 (the fault of a line depends on its index mod 4, which is
//      known only after the scan);
//   2. a block scan of the values in thread order (warp shuffles, then the
//      16 warp totals), whose combine is associative but not commutative;
//   3. decoupled look-back over the tiles for the tile's exclusive value
//      (kmd_lookback.cuh::exclusive_prefix_ordered): a line that spans
//      many tiles, as in a single-line assembly, is carried by the state
//      and never rescanned;
//   4. each thread walks its 16 bytes again from its exclusive value and
//      stages its codes in shared memory at their tile-local output
//      positions; the tile's codes then leave as 16-byte stores, with byte
//      stores for the partial first and last 16 bytes.
// No intermediate goes to device memory but one status word a tile. The
// last tile writes the two results. The C entry point waits for the kernel,
// so the results are there when it returns: the one host sync a file.
// Tiles start at the 16-byte boundary at or below the bytes, so a view at
// any byte offset is read with aligned vector loads; the bytes outside the
// file that these loads take are skipped (each lies in the 16-byte chunk of
// a real byte, so no load leaves the file's pages).
//
// Bound on the H100: one read of the bytes in and one write of the codes
// out at 3.35 TB/s: a 19.8 MB sample file of 150 bp reads (19.6 MB of
// codes) takes at least 11.8 us. The integer work, ~30 operations a byte
// over the two walks at the int32 rate (16.7 TOP/s), takes 35.6 us, so the
// operations bound it tighter. The kernel takes ~0.10 ms of device time on
// such a file, 35% of the operations bound, ~4 ms in a 40-file job: ~1% of
// the job (PERF.md).
#include "kmd_lookback.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBytes = 16;                // bytes a thread: one 16-byte load
constexpr int kTile = kThreads * kBytes;  // 8192
constexpr uint8_t kInvalid = 0xFF;
constexpr unsigned kNewline = '\n';

// The scan value of a span of bytes, 62 bits: the span's newlines from bit
// 6, FASTQ's fault mask in bits 2-5 (bit r: a line starting in the span
// breaks the strict layout when r lines, mod 4, come before the span) and
// in bits 0-1 the state of the span's last line start (0: none, 2: a line,
// 3: a line that starts with '>').
using Scan = unsigned long long;

__device__ __forceinline__ Scan combine(Scan a, Scan b) {  // a, then b
  const unsigned shift = static_cast<unsigned>(a >> 6) & 3;
  const unsigned bf = static_cast<unsigned>(b >> 2) & 15;
  const unsigned fault = (static_cast<unsigned>(a >> 2) & 15) |
                         (((bf >> shift) | (bf << (4 - shift))) & 15);
  const unsigned state = (b & 3) ? static_cast<unsigned>(b & 3)
                                 : static_cast<unsigned>(a & 3);
  return (((a >> 6) + (b >> 6)) << 6) | (fault << 2) | state;
}

struct Combine {
  __device__ __forceinline__ Scan operator()(Scan a, Scan b) const {
    return combine(a, b);
  }
};

__device__ __forceinline__ unsigned byte_at(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

__device__ __forceinline__ uint8_t code_of(unsigned b) {
  const unsigned lower = b | 0x20u;
  const bool base = lower == 'a' || lower == 'c' || lower == 'g' || lower == 't';
  return base ? static_cast<uint8_t>((b >> 1) & 3) : kInvalid;
}

// chunks: the bytes from their 16-byte boundary; aligned position a is file
// byte a - lead and is real for lead <= a < end (end = L + lead).
__global__ void __launch_bounds__(kThreads)
fasta_codes_kernel(const uint4* __restrict__ chunks, long long n_chunks, int lead,
                   long long end, int fastq, int n_tiles, uint8_t* __restrict__ out,
                   unsigned long long* scratch, long long* result) {
  __shared__ __align__(16) uint8_t staged[kTile + 16];
  __shared__ Scan warp_total[kWarps];
  __shared__ int tile_id;
  __shared__ Scan tile_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(chunks);

  if (threadIdx.x == 0) tile_id = kmd::lookback::take_tile(scratch);
  __syncthreads();
  const int t = tile_id;

  // 1. this thread's 16 bytes as one scan value
  const long long c = static_cast<long long>(t) * kThreads + threadIdx.x;
  const uint4 v = c < n_chunks ? __ldg(chunks + c) : make_uint4(0, 0, 0, 0);
  const long long a0 = 16 * c;
  const long long lo = lead - a0;  // real bytes: lo <= j < hi
  const long long hi = end - a0;
  // the byte before the first: a newline before the file's first byte
  const unsigned before = a0 > lead && a0 <= end ? bytes[a0 - 1] : kNewline;
  Scan mine;
  {
    unsigned newlines = 0, state = 0, fault = 0, prev = before;
#pragma unroll
    for (int j = 0; j < kBytes; ++j) {
      const unsigned b = byte_at(v, j);
      if (j >= lo && j < hi) {
        if (prev == kNewline || j == lo) {
          state = b == '>' ? 3u : 2u;
          if (fastq) {
            // the line's index mod 4 is (r + newlines) & 3 with r lines before
            if (b != '@') fault |= 1u << ((0u - newlines) & 3);
            if (b != '+') fault |= 1u << ((2u - newlines) & 3);
          }
        }
        newlines += b == kNewline;
      }
      prev = b;
    }
    mine = (static_cast<Scan>(newlines) << 6) | (fault << 2) | state;
  }

  // 2. block scan in thread order
  Scan incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const Scan y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = combine(y, incl);
  }
  Scan excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0;
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  Scan aggregate = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) excl = combine(aggregate, excl);
    aggregate = combine(aggregate, warp_total[w]);
  }
  if (threadIdx.x == 0) {
    kmd::lookback::publish(scratch, t, static_cast<long long>(aggregate));
  }

  // 3. look-back (warp 0); the last tile writes the results
  if (warp == 0) {
    const Scan ex = kmd::lookback::exclusive_prefix_ordered(scratch, t, aggregate,
                                                            lane, Combine{});
    if (lane == 0) {
      tile_prefix = ex;
      if (t == n_tiles - 1) {
        const Scan total = combine(ex, aggregate);
        const long long newlines = static_cast<long long>(total >> 6);
        result[0] = end - lead - newlines;
        // a line a line start: the first byte and each byte after a newline
        const long long lines = 1 + newlines - (bytes[end - 1] == kNewline);
        result[1] = !fastq || (lines % 4 == 0 && !((total >> 2) & 1));
      }
    }
  }
  __syncthreads();

  // 4. stage the codes at their tile-local positions, then write them out
  const long long tile_a0 = static_cast<long long>(t) * kTile;
  const long long tile_i0 = tile_a0 > lead ? tile_a0 - lead : 0;
  const long long tile_i1 = (tile_a0 + kTile < end ? tile_a0 + kTile : end) - lead;
  const long long out_base = tile_i0 - static_cast<long long>(tile_prefix >> 6);
  const int s0 = static_cast<int>((reinterpret_cast<uintptr_t>(out) + out_base) & 15);
  {
    const Scan pre = combine(tile_prefix, excl);
    long long newlines = static_cast<long long>(pre >> 6);
    unsigned state = static_cast<unsigned>(pre & 3), prev = before;
    const long long stage0 = s0 - out_base + a0 - lead;  // + j - newlines
#pragma unroll
    for (int j = 0; j < kBytes; ++j) {
      const unsigned b = byte_at(v, j);
      if (j >= lo && j < hi) {
        if (prev == kNewline || j == lo) state = b == '>' ? 3u : 2u;
        if (b == kNewline) {
          ++newlines;
        } else {
          const bool masked = fastq ? (newlines & 3) != 1 : state == 3u;
          staged[stage0 + j - newlines] = masked ? kInvalid : code_of(b);
        }
      }
      prev = b;
    }
  }
  __syncthreads();
  const int q_end = s0 + static_cast<int>(tile_i1 - tile_i0 -
                                          static_cast<long long>(aggregate >> 6));
  uint8_t* dst = out + out_base - s0;  // 16-byte aligned
  for (int q0 = 16 * threadIdx.x; q0 < q_end; q0 += 16 * kThreads) {
    if (q0 >= s0 && q0 + 16 <= q_end) {
      *reinterpret_cast<uint4*>(dst + q0) = *reinterpret_cast<const uint4*>(staged + q0);
    } else {
      const int q1 = q0 + 16 < q_end ? q0 + 16 : q_end;
      for (int q = q0 > s0 ? q0 : s0; q < q1; ++q) dst[q] = staged[q];
    }
  }
}

}  // namespace

KMD_API long long kmd_fasta_codes_tile_bytes(void) { return kTile; }

// raw [L], L > 0, at any byte offset, its first byte '>' or '@' (fastq 0
// or 1); out with room for L codes, at any offset; scratch: int64 [1 +
// n_tiles], n_tiles = ceil((L + (raw & 15)) / 8192), zeroed here with
// cudaMemsetAsync; result: two int64 in page-locked host memory
// (cudaHostAlloc, as torch's pin_memory allocates it), which the kernel
// writes through the same pointer under unified addressing: the number of
// codes, then 1 where the file is strict. Like K-CMP's entry point this one
// waits for its kernel, so that both results are there when it returns.
KMD_API int kmd_fasta_codes(const uint8_t* raw, long long L, int fastq, uint8_t* out,
                            int64_t* scratch, long long* result, cudaStream_t stream) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(raw) & 15);
  const long long end = L + lead;
  const long long n_tiles = (end + kTile - 1) / kTile;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + n_tiles) * sizeof(int64_t), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  fasta_codes_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(raw - lead), (end + 15) / 16, lead, end,
      fastq, static_cast<int>(n_tiles), out,
      reinterpret_cast<unsigned long long*>(scratch), result);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return static_cast<int>(e);
}
