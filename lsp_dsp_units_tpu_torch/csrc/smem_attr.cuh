// A kernel's dynamic shared memory above the default 48 KB, shared by
// csrc/biquad.cu and csrc/delay.cu: the kernel takes it only once its
// attribute allows it, raised here to the block's most (227 KB), once a
// kernel and device, not at every launch.

#pragma once

#include <cuda_runtime.h>

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMostSmem = 232448;   // 227 KB a block on the H100
constexpr int kMaxDevices = 64;

template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  if (bytes > kMostSmem) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSmem) return cudaSuccess;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMostSmem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}
