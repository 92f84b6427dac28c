// Shared declarations of the kmdiff_tpu_torch kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// kmdiff_tpu_torch/kernels.py), launches on the stream it is given, never
// synchronises and allocates nothing: the Python wrapper allocates outputs
// with torch.empty. Each returns cudaGetLastError() right after its
// launches, so a refused launch reaches the wrapper, which raises.
#pragma once

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#define KMD_API extern "C" __attribute__((visibility("default")))

namespace kmd {

// Sorted-key sentinel: the all-ones u64 k-mer with its top bit flipped.
// Invalid windows map here; no canonical k-mer does (kmdiff_tpu/ops/codec.py
// count_sort_rle_lanes explains why), so it sorts last and is masked.
constexpr int64_t kSentinel = INT64_MAX;

inline unsigned grid_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// A launch setting computed once for each CUDA device, on the calling
// thread's current device: cudaFuncSetAttribute and the occupancy and
// attribute queries apply to the current device only, so a process-wide
// static set on the first card would leave every other card unset. The
// setting is made under a lock, so threads that launch on several cards (the
// mesh runtime's shards) or on one card (count's sample threads) set each
// device once; a failed setting is not kept and is tried again at the next
// call.
constexpr int kMaxDevices = 64;

template <typename T>
class PerDevice {
 public:
  // init(dev, &value) returns a cudaError_t (0 on success)
  template <typename Init>
  int get(Init init, T* value) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    std::lock_guard<std::mutex> lock(mu_);
    if (!set_[dev]) {
      T v{};
      const int e = init(dev, &v);
      if (e != 0) return e;
      value_[dev] = v;
      set_[dev] = true;
    }
    *value = value_[dev];
    return 0;
  }

 private:
  std::mutex mu_;
  bool set_[kMaxDevices] = {};
  T value_[kMaxDevices] = {};
};

}  // namespace kmd
