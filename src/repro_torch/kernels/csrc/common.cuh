// Helpers shared by the kernel sources (leaf_insert.cu, probe.cu).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxDevices = 64;

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device.  Up to 48 KB needs no attribute.  Above that,
// cudaFuncSetAttribute runs once per device and size (the attribute
// belongs to the device's context); `configured` (one per kernel, zeroed)
// keeps the largest size set on each device, and devices past kMaxDevices
// set it on every call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem,
                       size_t (&configured)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = smem;
  return err;
}

// The current device's opt-in dynamic shared memory per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), queried once per device.
inline cudaError_t smem_optin(size_t* out) {
  static size_t limit[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && limit[dev]) {
    *out = limit[dev];
    return cudaSuccess;
  }
  int v = 0;
  err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) limit[dev] = (size_t)v;
  *out = (size_t)v;
  return cudaSuccess;
}

}  // namespace
