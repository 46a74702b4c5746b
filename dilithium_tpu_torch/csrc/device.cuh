// Host-side facts about the current card that launch code reads on every
// call, looked up once a device: K4 (ntt.cu) sizes its grid from the SM
// count, K6 (sponge_planes.cu) picks its form from it.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace dk {

constexpr int kMaxDevices = 64;

// The current device and its SM count, kept in a table indexed by the
// device (0 = not yet looked up; a device past the table is looked up on
// every call).
inline int sm_count(int* device = nullptr) {
  static std::atomic<int> table[kMaxDevices];  // zero-initialised (static storage)
  int dev = 0;
  cudaGetDevice(&dev);
  if (device) *device = dev;
  int sms = dev < kMaxDevices ? table[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
    if (dev < kMaxDevices) table[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

}  // namespace dk
