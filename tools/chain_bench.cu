// Dependent round trips of one warp, the latencies that bound the
// leaf-insert kernel's sequential item chain
// (src/repro_torch/kernels/csrc/leaf_insert.cu).  Not part of the sketch:
// chip_smoke.py builds it with nvcc for sm_90a and calls it through ctypes.
//
// mode 0: a shared-memory read -> ballot -> shared-memory write of the word
//         the next read takes (the chain of a kernel that keeps the matrix
//         state in shared memory between items);
// mode 1: a ballot -> find-first-set -> shuffle (the chain of a kernel that
//         passes each item's decision on in registers).
// out[0] gets the SM cycles of the loop of `iters` round trips.

#include <cuda_runtime.h>

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

}  // namespace

// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
extern "C" int chain_bench(int mode, int iters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    chain_bench_kernel<0><<<1, 32, 0, s>>>(iters, (long long*)out);
  else
    chain_bench_kernel<1><<<1, 32, 0, s>>>(iters, (long long*)out);
  return (int)cudaGetLastError();
}
