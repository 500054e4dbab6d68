// K1/K2: Algorithm-1 leaf insertion on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference package:
//   src/repro/kernels/leaf_insert.py::leaf_insert_batched_pallas (K1)
//   src/repro/kernels/leaf_insert.py::leaf_insert_pallas         (K2, L = 1)
//
// What it computes: for each of L stacked leaves, the items of that leaf
// are placed in arrival order.  Item e visits its r*r mapping buckets
// (rows[e][i], cols[e][j]) in lex order k = i*r + j; the first bucket that
// holds a slot matching (fp_s, fp_d, t) -- the weight is added there -- or,
// failing a match, an EMPTY slot -- claimed with idx = k -- takes the item.
// Within one bucket a match beats a free slot.  An item no bucket takes is
// spilled (spill[e] = 1).
//
// Design: one warp (one CTA of 32 threads) per leaf.  The leaf's SoA
// matrix (d*d*b slots of fp_s, fp_d, t, idx, w: 15 KiB at d=16, b=3) is
// loaded into shared memory, updated there and written back once.  Items
// stay strictly sequential within the leaf; leaves run in parallel across
// the SMs.  For one item, lane k tests bucket k (all b slots) and a ballot
// picks the lowest bucket that offers a match or a free slot, so the
// reference's per-bucket priority is kept exactly.  Weight updates are
// single float32 adds in arrival order (bit-identical to the reference).
// Item data is staged 32 items at a time into shared memory with one
// coalesced load per field.
//
// Bound on this card: the matrices are read and written once and the items
// read once, so bytes set the floor; the sequential item chain inside a
// leaf (a shared-memory read, a ballot and a write per item) is what the
// kernel actually waits on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;   // int32 bit pattern of 0xFFFFFFFF
constexpr int kTile = 32;    // items staged per tile (one per lane)

__global__ void leaf_insert_kernel(
    int32_t* __restrict__ fp_s, int32_t* __restrict__ fp_d,
    float* __restrict__ w_m, int32_t* __restrict__ t_m,
    int32_t* __restrict__ idx_m,                      // (L, d, d, b)
    const int32_t* __restrict__ fs, const int32_t* __restrict__ fd,
    const float* __restrict__ w, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ valid,                // (L, n)
    const int32_t* __restrict__ rows,
    const int32_t* __restrict__ cols,                 // (L, n, r)
    int32_t* __restrict__ spill,                      // (L, n)
    int n, int d, int b, int r) {
  extern __shared__ int32_t smem[];
  const int cells = d * d * b;
  int32_t* s_fps = smem;
  int32_t* s_fpd = s_fps + cells;
  int32_t* s_t = s_fpd + cells;
  int32_t* s_idx = s_t + cells;
  float* s_w = reinterpret_cast<float*>(s_idx + cells);
  int32_t* q_fs = reinterpret_cast<int32_t*>(s_w + cells);
  int32_t* q_fd = q_fs + kTile;
  int32_t* q_t = q_fd + kTile;
  int32_t* q_v = q_t + kTile;
  float* q_w = reinterpret_cast<float*>(q_v + kTile);
  int32_t* q_rows = reinterpret_cast<int32_t*>(q_w + kTile);
  int32_t* q_cols = q_rows + kTile * r;

  const int lane = threadIdx.x;
  const size_t leaf = blockIdx.x;
  const size_t moff = leaf * cells;
  for (int c = lane; c < cells; c += 32) {
    s_fps[c] = fp_s[moff + c];
    s_fpd[c] = fp_d[moff + c];
    s_t[c] = t_m[moff + c];
    s_idx[c] = idx_m[moff + c];
    s_w[c] = w_m[moff + c];
  }
  __syncwarp();

  const int rr = r * r;
  for (int e0 = 0; e0 < n; e0 += kTile) {
    const int cnt = min(kTile, n - e0);
    const size_t it0 = leaf * n + e0;
    if (lane < cnt) {
      q_fs[lane] = fs[it0 + lane];
      q_fd[lane] = fd[it0 + lane];
      q_t[lane] = t[it0 + lane];
      q_w[lane] = w[it0 + lane];
      q_v[lane] = valid[it0 + lane];
    }
    for (int c = lane; c < cnt * r; c += 32) {
      q_rows[c] = rows[it0 * r + c];
      q_cols[c] = cols[it0 * r + c];
    }
    __syncwarp();
    for (int e = 0; e < cnt; ++e) {
      int spilled = 0;
      if (q_v[e]) {
        const int32_t f_s = q_fs[e], f_d = q_fd[e], tv = q_t[e];
        const float wv = q_w[e];
        bool done = false;
        // buckets in groups of 32 (one per lane); `done` is warp-uniform
        for (int g = 0; g < rr && !done; g += 32) {
          const int k = g + lane;
          int mslot = -1, eslot = -1, base = 0;
          if (k < rr) {
            const int row = q_rows[e * r + k / r];
            const int col = q_cols[e * r + k % r];
            base = (row * d + col) * b;
            for (int s = 0; s < b; ++s) {
              const int32_t x = s_fps[base + s];
              if (mslot < 0 && x == f_s && s_fpd[base + s] == f_d &&
                  s_t[base + s] == tv && x != kEmpty)
                mslot = s;
              if (eslot < 0 && x == kEmpty) eslot = s;
            }
          }
          const unsigned ok = __ballot_sync(0xffffffffu,
                                            mslot >= 0 || eslot >= 0);
          if (ok) {
            done = true;
            if (lane == __ffs(ok) - 1) {
              if (mslot >= 0) {
                const int c = base + mslot;
                s_w[c] = __fadd_rn(s_w[c], wv);
              } else {
                const int c = base + eslot;
                s_fps[c] = f_s;
                s_fpd[c] = f_d;
                s_t[c] = tv;
                s_idx[c] = k;
                s_w[c] = __fadd_rn(s_w[c], wv);
              }
            }
          }
        }
        spilled = done ? 0 : 1;
      }
      if (lane == 0) spill[it0 + e] = spilled;
      __syncwarp();
    }
  }

  for (int c = lane; c < cells; c += 32) {
    fp_s[moff + c] = s_fps[c];
    fp_d[moff + c] = s_fpd[c];
    t_m[moff + c] = s_t[c];
    idx_m[moff + c] = s_idx[c];
    w_m[moff + c] = s_w[c];
  }
}

}  // namespace

extern "C" size_t higgs_leaf_insert_smem(int d, int b, int r) {
  return (size_t)d * d * b * 5 * 4 + (size_t)kTile * (5 + 2 * r) * 4;
}

// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
extern "C" int higgs_leaf_insert(
    void* fp_s, void* fp_d, void* w_m, void* t_m, void* idx_m,
    const void* fs, const void* fd, const void* w, const void* t,
    const void* valid, const void* rows, const void* cols, void* spill,
    int L, int n, int d, int b, int r, void* stream) {
  if (L <= 0) return 0;
  const size_t smem = higgs_leaf_insert_smem(d, b, r);
  cudaError_t err = cudaFuncSetAttribute(
      leaf_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  leaf_insert_kernel<<<L, 32, smem, (cudaStream_t)stream>>>(
      (int32_t*)fp_s, (int32_t*)fp_d, (float*)w_m, (int32_t*)t_m,
      (int32_t*)idx_m, (const int32_t*)fs, (const int32_t*)fd,
      (const float*)w, (const int32_t*)t, (const uint8_t*)valid,
      (const int32_t*)rows, (const int32_t*)cols, (int32_t*)spill,
      n, d, b, r);
  return (int)cudaGetLastError();
}
