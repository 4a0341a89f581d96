// Launch attributes that the kernels' entry points ask of the runtime once
// per (kernel, device), included by score.cu, prefilter.cu and phase_c.cu:
// a steady launch -- and a launch recorded into a CUDA graph -- then calls
// no attribute function.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;

// Raise the dynamic shared memory `kernel` may use above 48 KB to `smem`,
// only when the device does not allow it that much already: `allowed`
// holds, per device, the bytes already set for this kernel (one static
// array per kernel at its call site).
cudaError_t allow_smem(const void* kernel, std::atomic<int>* allowed, long long smem) {
  if (smem <= 48 * 1024) {
    return cudaSuccess;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return err;
  }
  const bool known = device >= 0 && device < MAX_DEVICES;
  if (known && allowed[device].load(std::memory_order_acquire) >= smem) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && known) {
    int seen = allowed[device].load(std::memory_order_relaxed);
    while (seen < smem && !allowed[device].compare_exchange_weak(seen, static_cast<int>(smem))) {
    }
  }
  return err;
}

// The SMs of the current device into `sms`, asked once per device; returns
// the runtime's error code (0 on success).
int n_sms(int* sms) {
  static std::atomic<int> count[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const bool known = device >= 0 && device < MAX_DEVICES;
  *sms = known ? count[device].load(std::memory_order_relaxed) : 0;
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess && known) {
      count[device].store(*sms, std::memory_order_relaxed);
    }
  }
  return static_cast<int>(err);
}

}  // namespace
