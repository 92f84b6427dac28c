// K-ASM: assemble one merge chunk from slices of the resident sample streams.
//
// Replaces kmdiff_tpu/pipeline/fused.py::_assemble_chunk_impl in its packed
// modes (p16, p32) and its "full" mode (fused.py:414-420, p32 counts plus
// each row's sample id, for popstrat's count and geno rows and --save-sk):
// every stream s contributes rows [start_s, start_s + len_s)
// of its sorted int64 keys and u32 counts; the chunk is their concatenation
// in stream order, each count packed with its stream's control flag, the
// packing of run_bounds.cu::run_group_sums_kernel (and of
// kmdiff_tpu_torch/ops/merge_dev.py::build_triples_packed):
//   count_bytes == 2: u16, count in bits 0..14, control flag in bit 15
//   count_bytes == 4: i32, count in bits 0..30, control flag in the sign bit
// With out_sample, each row's stream index s is written beside it as u16.
//
// The TPU form is gone: no fixed [S, M] slice per stream (dynamic_slice with a
// sentinel-padded blob so it never clamps), no sentinel fill of the unused
// slots, no pad rows for the sort to carry. The chunk holds exactly the sum of
// the slice lengths; a stream with len 0 contributes nothing.
//
// The slices come in a small device table, one row of six int64 per stream:
// keys pointer, counts pointer, start, len, output offset, is_control. One
// launch per chunk: blockIdx.y picks the stream, the x blocks stride over its
// rows, so a stream of length 0 costs only the blocks that read its row and
// exit.
//
// Bound on the H100: device memory. A row reads 8 + 4 bytes and writes 8 + 2
// (or 4, and 2 more with sample ids), all contiguous within a stream. No
// shared memory, no atomics.
#include "kmd_common.cuh"

namespace {

constexpr int kThreads = 256;
// x blocks a stream at most; each thread then strides over its rows
constexpr long long kMaxBlocksX = 4096;

struct Slice {
  const int64_t* keys;
  const uint32_t* counts;
  long long start;
  long long len;
  long long out;
  long long is_control;
};
static_assert(sizeof(Slice) == 48, "one table row is six int64");

template <typename Packed>
__global__ void assemble_kernel(const Slice* __restrict__ table,
                                int64_t* __restrict__ out_keys,
                                Packed* __restrict__ out_counts,
                                uint16_t* __restrict__ out_sample) {
  const Slice t = table[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < t.len; i += stride) {
    const long long src = t.start + i;
    const long long dst = t.out + i;
    out_keys[dst] = t.keys[src];
    const uint32_t c = t.counts[src];
    if (sizeof(Packed) == 2) {
      uint16_t v = static_cast<uint16_t>(c);
      if (t.is_control) v |= 0x8000u;
      out_counts[dst] = static_cast<Packed>(v);
    } else {
      uint32_t v = c;
      if (t.is_control) v |= 0x80000000u;
      out_counts[dst] = static_cast<Packed>(v);
    }
    if (out_sample != nullptr) out_sample[dst] = static_cast<uint16_t>(blockIdx.y);
  }
}

}  // namespace

KMD_API int kmd_assemble_chunk(const int64_t* table, int S, long long max_len,
                               int count_bytes, int64_t* out_keys,
                               void* out_counts, uint16_t* out_sample,
                               cudaStream_t stream) {
  if (count_bytes != 2 && count_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || S > 65535 || max_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long bx = (max_len + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(S));
  const Slice* slices = reinterpret_cast<const Slice*>(table);
  if (count_bytes == 2) {
    assemble_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
        slices, out_keys, static_cast<uint16_t*>(out_counts), out_sample);
  } else {
    assemble_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
        slices, out_keys, static_cast<uint32_t*>(out_counts), out_sample);
  }
  return static_cast<int>(cudaGetLastError());
}
