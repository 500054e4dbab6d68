// Microbenchmarks of the card that the kernels' bounds are read against.
// Not part of the sketch: chip_smoke.py builds it with nvcc for sm_90a and
// calls it through ctypes.
//
// chain_bench: dependent round trips of one warp, the latencies that bound
// the leaf-insert kernel's sequential item chain
// (src/repro_torch/kernels/csrc/leaf_insert.cu).
// mode 0: a shared-memory read -> ballot -> shared-memory write of the word
//         the next read takes (the chain of a kernel that keeps the matrix
//         state in shared memory between items);
// mode 1: a ballot -> find-first-set -> shuffle (the chain of a kernel that
//         passes each item's decision on in registers).
// out[0] gets the SM cycles of the loop of `iters` round trips.
//
// l2_read_bench: read rates that the edge probe's loads are compared with.
// mode 0: a coalesced stream of 16-byte loads over the buffer, `reps`
//         times (each pass starts at another offset);
// mode 1: 4-byte loads of hashed 32-byte sectors of the buffer, `reps`
//         per thread, eight in flight (the edge probe's scattered reads).
// Both load through the L2 only (ld.global.cg), so a buffer that fits the
// L2 is read from it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int MODE>
__global__ void chain_bench_kernel(int iters, long long* out) {
  __shared__ int s[64];
  const int lane = threadIdx.x;
  s[lane] = lane * 7 + 1;
  s[lane + 32] = lane * 3 + 2;
  __syncwarp();
  int a = 0, acc = lane;
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (MODE == 0) {
      const int x = s[a];
      const unsigned bal = __ballot_sync(kFull, ((x >> (lane & 7)) ^ lane) & 1);
      const int nxt = (__ffs(bal | 0x80000000u) + i) & 63;
      if (lane == 0) s[nxt] = x + (int)bal;
      __syncwarp();
      a = nxt;
    } else {
      const unsigned bal =
          __ballot_sync(kFull, ((acc >> (lane & 7)) ^ lane) & 1);
      acc = __shfl_sync(kFull, acc + i, __ffs(bal | 0x80000000u) - 1);
    }
  }
  const long long c1 = clock64();
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = a + acc;                   // keeps the chain live
  }
}

constexpr int kBenchThreads = 256;

__global__ void __launch_bounds__(kBenchThreads)
    l2_stream_kernel(const int4* __restrict__ buf, size_t n, int reps,
                     int* out) {
  int acc = 0;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int rep = 0; rep < reps; ++rep) {
    const size_t shift = (size_t)rep * 4099 % n;
    for (size_t i = t; i < n; i += stride) {
      size_t k = i + shift;
      if (k >= n) k -= n;
      const int4 v = __ldcg(buf + k);
      acc = acc * 31 + (v.x ^ v.y ^ v.z ^ v.w);
    }
  }
  if (acc == 0x13579bdf) out[0] = acc;  // keeps the loads live
}

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kBenchThreads)
    l2_sector_kernel(const int32_t* __restrict__ buf, uint32_t sectors,
                     int reps, int* out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  int acc = 0;
  for (int it = 0; it < reps; it += 8) {
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __ldcg(buf + (size_t)(mix(t * 0x9E3779B1u + it + k) %
                                   sectors) * 8);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = acc * 31 + v[k];
  }
  if (acc == 0x13579bdf) out[0] = acc;
}

}  // namespace

// Returns a cudaError_t (0 on success); launches `grid` CTAs of 256
// threads on `stream`, no sync.  `bytes` is the buffer's size (a multiple
// of 32); mode 1 takes `reps` as a multiple of 8.
extern "C" int l2_read_bench(int mode, const void* buf, size_t bytes,
                             int reps, int grid, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    l2_stream_kernel<<<grid, kBenchThreads, 0, s>>>(
        (const int4*)buf, bytes / 16, reps, (int*)out);
  else
    l2_sector_kernel<<<grid, kBenchThreads, 0, s>>>(
        (const int32_t*)buf, (uint32_t)(bytes / 32), reps, (int*)out);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
extern "C" int chain_bench(int mode, int iters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    chain_bench_kernel<0><<<1, 32, 0, s>>>(iters, (long long*)out);
  else
    chain_bench_kernel<1><<<1, 32, 0, s>>>(iters, (long long*)out);
  return (int)cudaGetLastError();
}
