// Function attributes set once on each device a launcher reaches.
//
// cudaFuncSetAttribute acts on the current device's context, so a
// process-wide "already set" flag leaves every device but the first
// without the attribute.  A launcher keeps one PerDeviceAttr (a
// function-local static: one per kernel instantiation) and calls
// ensure(value, set) before each launch: set() runs, under a lock, the
// first time the current device needs at least `value` (a dynamic
// shared-memory size, or 1 for a flag); later calls on that device cost
// one cudaGetDevice and one atomic load.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <mutex>

class PerDeviceAttr {
 public:
  template <typename Set>
  int ensure(size_t value, Set&& set) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (have_[dev].load(std::memory_order_acquire) >= value) return 0;
    std::lock_guard<std::mutex> lock(mu_);
    if (have_[dev].load(std::memory_order_relaxed) >= value) return 0;
    err = set();
    if (err != cudaSuccess) return static_cast<int>(err);
    have_[dev].store(value, std::memory_order_release);
    return 0;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::atomic<size_t> have_[kMaxDevices] = {};
  std::mutex mu_;
};
