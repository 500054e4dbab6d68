// K3/K4: edge and vertex probes on Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of the reference package:
//   src/repro/kernels/probe.py::edge_probe_pallas   (K3)
//   src/repro/kernels/probe.py::vertex_probe_pallas (K4)
// and, on the reference's main path, the planner's fused jnp launches
// `_edge_probe_fused` / `_vertex_probe_fused` (src/repro/api/planner.py).
//
// Both read the level pool's resident slabs (cap, d, d, b) directly through
// the row index `idx` of the m probed matrices (the reference first takes
// those rows into a copy); `mask` gates the matrices.  Integer fields are
// int32 bit patterns of the reference's uint32; time bounds compare as
// unsigned.
//
// The TPU kernels stream whole (matrix, row-tile) blocks through VMEM with
// one-hot candidate masks, because per-query gathers are slow on the TPU's
// vector unit.  On Hopper a gather is cheap, so each query reads only its
// candidate slots:
//
// K3 (edge): one warp per query.  The m*r*r*b candidate slots are spread
//   over the lanes; each lane sums its matches and a fixed-order shuffle
//   reduction gives the total, so results are deterministic.  Bound: the
//   candidate slots' bytes (4 fields x 4 bytes; scattered 4-byte reads, so
//   each touches a 32-byte sector).
//
// K4 (vertex): one 256-thread block per query.  Each warp takes (matrix,
//   candidate) pairs; its lanes stride over the d*b slots of the candidate
//   row ("out": contiguous, coalesced) or column ("in": one b-slot run per
//   row, d*b*4 bytes apart, so most of each 32-byte sector is wasted).  Warp
//   partials are summed by thread 0 in warp order (deterministic).  Bound:
//   the candidate lines' bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool in_range(int32_t t, uint32_t ts,
                                         uint32_t te) {
  const uint32_t u = (uint32_t)t;
  return u >= ts && u <= te;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void edge_probe_kernel(
    const int32_t* __restrict__ fp_s, const int32_t* __restrict__ fp_d,
    const float* __restrict__ w, const int32_t* __restrict__ t,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ fs, const int32_t* __restrict__ fd,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
    uint32_t ts, uint32_t te, int match_time, float* __restrict__ out,
    int m, int q, int d, int b, int r) {
  const int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= q) return;                 // whole warps exit together
  const int32_t qfs = fs[qi], qfd = fd[qi];
  const int per = r * r * b;
  float acc = 0.f;
  for (int e = lane; e < m * per; e += 32) {
    const int mi = e / per;
    if (!mask[mi]) continue;
    const int rem = e - mi * per;
    const int k = rem / b, s = rem - k * b;
    const int row = rows[qi * r + k / r], col = cols[qi * r + k % r];
    const size_t c = (((size_t)idx[mi] * d + row) * d + col) * b + s;
    if (fp_s[c] == qfs && fp_d[c] == qfd &&
        (!match_time || in_range(t[c], ts, te)))
      acc += w[c];
  }
  acc = warp_sum(acc);
  if (lane == 0) out[qi] = acc;
}

constexpr int kVertexWarps = 8;

__global__ void vertex_probe_kernel(
    const int32_t* __restrict__ fp, const float* __restrict__ w,
    const int32_t* __restrict__ t, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ fv,
    const int32_t* __restrict__ rows, uint32_t ts, uint32_t te,
    int match_time, int dir_in, float* __restrict__ out, int m, int d,
    int b, int r) {
  __shared__ float partial[kVertexWarps];
  const int qi = blockIdx.x;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t f = fv[qi];
  const int line_len = d * b;
  float acc = 0.f;
  for (int p = wid; p < m * r; p += kVertexWarps) {
    const int mi = p / r;
    if (!mask[mi]) continue;
    const size_t line = rows[qi * r + (p - mi * r)];
    const size_t mbase = (size_t)idx[mi] * d * d * b;
    for (int e = lane; e < line_len; e += 32) {
      const int x = e / b, s = e - (e / b) * b;
      const size_t c = dir_in ? mbase + ((size_t)x * d + line) * b + s
                              : mbase + (line * d + x) * b + s;
      if (fp[c] == f && (!match_time || in_range(t[c], ts, te)))
        acc += w[c];
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) partial[wid] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < kVertexWarps; ++i) total += partial[i];
    out[qi] = total;
  }
}

}  // namespace

// Both return a cudaError_t (0 on success); launch on `stream`, no sync.
extern "C" int higgs_edge_probe(
    const void* fp_s, const void* fp_d, const void* w, const void* t,
    const void* idx, const void* mask, const void* fs, const void* fd,
    const void* rows, const void* cols, unsigned int ts, unsigned int te,
    int match_time, void* out, int m, int q, int d, int b, int r,
    void* stream) {
  if (q <= 0) return 0;
  const int threads = 256;
  const int blocks = (q * 32 + threads - 1) / threads;
  edge_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)fp_s, (const int32_t*)fp_d, (const float*)w,
      (const int32_t*)t, (const int32_t*)idx, (const uint8_t*)mask,
      (const int32_t*)fs, (const int32_t*)fd, (const int32_t*)rows,
      (const int32_t*)cols, ts, te, match_time, (float*)out, m, q, d, b, r);
  return (int)cudaGetLastError();
}

extern "C" int higgs_vertex_probe(
    const void* fp, const void* w, const void* t, const void* idx,
    const void* mask, const void* fv, const void* rows, unsigned int ts,
    unsigned int te, int match_time, int dir_in, void* out, int m, int q,
    int d, int b, int r, void* stream) {
  if (q <= 0) return 0;
  vertex_probe_kernel<<<q, kVertexWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)fp, (const float*)w, (const int32_t*)t,
      (const int32_t*)idx, (const uint8_t*)mask, (const int32_t*)fv,
      (const int32_t*)rows, ts, te, match_time, dir_in, (float*)out, m, d,
      b, r);
  return (int)cudaGetLastError();
}
