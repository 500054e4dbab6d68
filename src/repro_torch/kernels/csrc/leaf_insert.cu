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
// Bound on this card: the matrices are read and written once and the items
// read once (about 8 us at L = 402, d = 16, b = 3), but the items of one
// leaf are strictly sequential, so what the kernel waits on is the chain
// from one item's decision to the next item's.  The design keeps only
// register work and two warp collectives on that chain:
//
// - One warp (one CTA of 32 threads) per leaf; lane k owns bucket k of the
//   current item (r*r <= 32).  The leaf's matrix lives in shared memory for
//   the whole launch as one 16-byte {fp_s, fp_d, t, w} record per slot
//   (idx beside it), so a lane reads its b candidate slots with b
//   independent 16-byte loads.
// - Item data never passes through shared memory: the next 32-item tile's
//   fields (one item per lane) and every lane's row and column of each of
//   its items are loaded from global memory into registers a whole tile
//   ahead, so the tile's bucket bases (row*d + col)*b are ready in
//   registers when it starts, and item fields reach the lanes by shuffles.
// - Item e+1's candidate slots are loaded, and tested against its key,
//   while item e is decided.  Item e writes at most one slot; its cell and
//   new weight reach every lane by shuffle, and a lane whose candidate is
//   that cell corrects its flags: the cell then holds item e's key, so it
//   matches iff the two items' keys are equal (a per-item flag worked out
//   when the tile is loaded).  The chain per item is therefore: a cell
//   compare, the bucket's priority, ballot, find-first-set, shuffle -- no
//   shared-memory round trip.
// - Spill flags stay in a register of the item's lane and are stored once
//   per tile, coalesced.
//
// Semantics kept bit for bit: the per-bucket priority (the lowest lane with
// a match or a free slot wins, a match beating a free slot within its
// bucket), arrival order, and one __fadd_rn per item into the chosen slot.
//
// Other shapes (b > 8 or r*r > 32) take leaf_insert_any_kernel, the same
// semantics without the register pipeline: the item's buckets are walked in
// groups of 32 (one per lane) against a structure-of-arrays matrix in
// shared memory, one item at a time.
//
// A leaf whose staging does not fit the device's opt-in shared memory per
// block (d*d*b*20 bytes; about 227 KB on this card, so d = 64 at b = 3, or
// d = 32 at b >= 12) takes leaf_insert_global_kernel: the same walk and the
// same priority, on the leaf's rows of the level-1 slabs themselves
// (global memory, served by the L2), which the launch writes anyway.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kEmpty = -1;            // int32 bit pattern of 0xFFFFFFFF
constexpr int kTile = 32;             // items per tile (one per lane)
constexpr int kMaxB = 8;              // slots per bucket the kernel takes
constexpr unsigned kFull = 0xffffffffu;

// The next tile's raw items: lane e holds item e0+e's fields; every lane
// holds the row (its bucket's i) and column (its j) of all kTile items.
struct Tile {
  int fs, fd, t, v;
  float w;
  int row[kTile], col[kTile];
};

__device__ __forceinline__ void fetch_tile(
    Tile& tl, int e0, int n, size_t item0, int r, int ri, int ci,
    const int32_t* __restrict__ fs, const int32_t* __restrict__ fd,
    const float* __restrict__ w, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ cols) {
  const int lane = threadIdx.x;
  const bool in = e0 + lane < n;
  const size_t g = item0 + (in ? e0 + lane : 0);
  tl.fs = fs[g];
  tl.fd = fd[g];
  tl.t = t[g];
  tl.w = w[g];
  tl.v = in && valid[g];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const size_t e = item0 + min(e0 + j, n - 1);
    tl.row[j] = rows[e * r + ri];
    tl.col[j] = cols[e * r + ci];
  }
}

template <int B>
__device__ __forceinline__ void load_bucket(const int4* s_slot, int base,
                                            int4 (&v)[B]) {
#pragma unroll
  for (int s = 0; s < B; ++s) v[s] = s_slot[base + s];
}

template <int B>
__global__ void __launch_bounds__(32) leaf_insert_kernel(
    int32_t* __restrict__ fp_s, int32_t* __restrict__ fp_d,
    float* __restrict__ w_m, int32_t* __restrict__ t_m,
    int32_t* __restrict__ idx_m,                      // (L, d, d, B)
    const int32_t* __restrict__ fs, const int32_t* __restrict__ fd,
    const float* __restrict__ w, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ valid,                // (L, n)
    const int32_t* __restrict__ rows,
    const int32_t* __restrict__ cols,                 // (L, n, r)
    int32_t* __restrict__ spill,                      // (L, n)
    int n, int d, int r) {
  extern __shared__ int4 s_slot[];                    // {fp_s, fp_d, t, w}
  constexpr unsigned kSlots = (1u << B) - 1;          // bits of the b slots
  const int cells = d * d * B;
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_slot + cells);
  const int lane = threadIdx.x;
  const size_t leaf = blockIdx.x;
  const size_t moff = leaf * cells;
  for (int c = lane; c < cells; c += 32) {
    s_slot[c] = make_int4(fp_s[moff + c], fp_d[moff + c], t_m[moff + c],
                          __float_as_int(w_m[moff + c]));
    s_idx[c] = idx_m[moff + c];
  }
  const bool bucket_lane = lane < r * r;
  const int ri = bucket_lane ? lane / r : 0;
  const int ci = bucket_lane ? lane % r : 0;
  const size_t item0 = leaf * n;

  Tile nx;
  if (n > 0)
    fetch_tile(nx, 0, n, item0, r, ri, ci, fs, fd, w, t, valid, rows, cols);
  __syncwarp();

  for (int e0 = 0; e0 < n; e0 += kTile) {
    const int my_fs = nx.fs, my_fd = nx.fd, my_t = nx.t;
    const float my_w = nx.w;
    // what item e's candidates hold where item e-1 just wrote: item e-1's
    // key, so they match iff the two items' keys are equal
    const int p_fs = __shfl_up_sync(kFull, my_fs, 1);
    const int p_fd = __shfl_up_sync(kFull, my_fd, 1);
    const int p_t = __shfl_up_sync(kFull, my_t, 1);
    const bool same = p_fs == my_fs && p_fd == my_fd && p_t == my_t;
    const int my_flags = nx.v | (same && p_fs != kEmpty ? 2 : 0) |
                         (p_fs == kEmpty ? 4 : 0);
    int base[kTile];                    // this lane's bucket of each item
#pragma unroll
    for (int j = 0; j < kTile; ++j) base[j] = (nx.row[j] * d + nx.col[j]) * B;
    if (e0 + kTile < n)                 // a whole tile ahead
      fetch_tile(nx, e0 + kTile, n, item0, r, ri, ci, fs, fd, w, t, valid,
                 rows, cols);

    int4 cur[B];
    load_bucket<B>(s_slot, base[0], cur);   // sees every earlier write
    int last_c = -1, last_w = 0;
    int my_spill = 0;
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      const int f_s = __shfl_sync(kFull, my_fs, e);
      const int f_d = __shfl_sync(kFull, my_fd, e);
      const int tv = __shfl_sync(kFull, my_t, e);
      const float wv = __shfl_sync(kFull, my_w, e);
      const int fl = __shfl_sync(kFull, my_flags, e);
      // item e+1's candidates, read before item e writes: they see every
      // write up to item e-1
      int4 nxt[B];
      if (e + 1 < kTile) load_bucket<B>(s_slot, base[e + 1], nxt);
      // bit s: slot s matches item e / is free, as read (off the chain)
      unsigned mm = 0, em = 0;
#pragma unroll
      for (int s = 0; s < B; ++s) {
        const bool free_s = cur[s].x == kEmpty;
        em |= (unsigned)free_s << s;
        mm |= (unsigned)(!free_s && cur[s].x == f_s && cur[s].y == f_d &&
                         cur[s].z == tv) << s;
      }
      // what the slot item e-1 wrote now holds: item e-1's key (fl bit 1:
      // it equals item e's; bit 2: it is EMPTY)
      const unsigned smask = fl & 2 ? kSlots : 0u;
      const unsigned emask = fl & 4 ? kSlots : 0u;
      // the chain: item e-1's cell, compared with this lane's bucket
      const unsigned off = (unsigned)(last_c - base[e]);
      const unsigned wr = off < (unsigned)B ? 1u << off : 0u;
      mm = (mm & ~wr) | (wr & smask);
      em = (em & ~wr) | (wr & emask);
      const bool can = bucket_lane && (fl & 1) && (mm | em) != 0u;
      const unsigned ok = __ballot_sync(kFull, can);
      // this lane's slot (first match, else first free) and new weight
      const int slot = __ffs(mm ? mm : em) - 1;
      int old_w = cur[0].w;
#pragma unroll
      for (int s = 1; s < B; ++s)
        if (slot == s) old_w = cur[s].w;
      if (wr && (unsigned)slot == off) old_w = last_w;
      const int my_c = can ? base[e] + slot : -1;
      const int my_nw =
          __float_as_int(__fadd_rn(__int_as_float(old_w), wv));
      // -1 when no bucket takes the item: srcLane -1 reads lane 31, whose
      // my_c is then -1 too
      const int win = __ffs(ok) - 1;
      last_c = __shfl_sync(kFull, my_c, win);
      last_w = __shfl_sync(kFull, my_nw, win);
      const bool am_win = lane == win;
      if (am_win) s_slot[my_c] = make_int4(f_s, f_d, tv, my_nw);
      if (am_win && mm == 0u) s_idx[my_c] = lane;
      if (lane == e) my_spill = (fl & 1) && !ok;
      __syncwarp();
      if (e + 1 < kTile) {
#pragma unroll
        for (int s = 0; s < B; ++s) cur[s] = nxt[s];
      }
    }
    if (e0 + lane < n) spill[item0 + e0 + lane] = my_spill;
  }
  __syncwarp();

  for (int c = lane; c < cells; c += 32) {
    const int4 x = s_slot[c];
    fp_s[moff + c] = x.x;
    fp_d[moff + c] = x.y;
    t_m[moff + c] = x.z;
    w_m[moff + c] = __int_as_float(x.w);
    idx_m[moff + c] = s_idx[c];
  }
}

// Any b and r: lane k of a group tests bucket g + k (all b slots) against
// the shared-memory matrix; the first group whose ballot is nonzero takes
// the item, at its lowest lane.  Item fields are staged 32 at a time.
__global__ void __launch_bounds__(32) leaf_insert_any_kernel(
    int32_t* __restrict__ fp_s, int32_t* __restrict__ fp_d,
    float* __restrict__ w_m, int32_t* __restrict__ t_m,
    int32_t* __restrict__ idx_m, const int32_t* __restrict__ fs,
    const int32_t* __restrict__ fd, const float* __restrict__ w,
    const int32_t* __restrict__ t, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
    int32_t* __restrict__ spill, int n, int d, int b, int r) {
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
    int my_spill = 0;
    for (int e = 0; e < cnt; ++e) {
      if (!q_v[e]) continue;              // warp-uniform
      const int32_t f_s = q_fs[e], f_d = q_fd[e], tv = q_t[e];
      const float wv = q_w[e];
      bool done = false;
      for (int g = 0; g < rr && !done; g += 32) {
        const int k = g + lane;
        int mslot = -1, eslot = -1, base = 0;
        if (k < rr) {
          base = (q_rows[e * r + k / r] * d + q_cols[e * r + k % r]) * b;
          for (int s = 0; s < b; ++s) {
            const int32_t x = s_fps[base + s];
            if (mslot < 0 && x != kEmpty && x == f_s &&
                s_fpd[base + s] == f_d && s_t[base + s] == tv)
              mslot = s;
            if (eslot < 0 && x == kEmpty) eslot = s;
          }
        }
        const unsigned ok = __ballot_sync(kFull, mslot >= 0 || eslot >= 0);
        done = ok != 0u;
        if (done && lane == __ffs(ok) - 1) {
          const int c = base + (mslot >= 0 ? mslot : eslot);
          if (mslot < 0) {
            s_fps[c] = f_s;
            s_fpd[c] = f_d;
            s_t[c] = tv;
            s_idx[c] = k;
          }
          s_w[c] = __fadd_rn(s_w[c], wv);
        }
      }
      if (lane == e) my_spill = !done;
      __syncwarp();
    }
    if (lane < cnt) spill[it0 + lane] = my_spill;
    __syncwarp();
  }
  for (int c = lane; c < cells; c += 32) {
    fp_s[moff + c] = s_fps[c];
    fp_d[moff + c] = s_fpd[c];
    t_m[moff + c] = s_t[c];
    idx_m[moff + c] = s_idx[c];
    w_m[moff + c] = s_w[c];
  }
}

// Leaves too large for shared memory: leaf_insert_any_kernel's walk on the
// matrices in global memory.  Lane e of a tile holds item e0+e's fields
// (passed to the warp by shuffle); the winning lane writes the slot, and
// __syncwarp orders that write before the warp's reads for the next item.
// The matrix pointers are neither const nor __restrict__, so every read
// goes through the coherent load path.
__global__ void __launch_bounds__(32) leaf_insert_global_kernel(
    int32_t* fp_s, int32_t* fp_d, float* w_m, int32_t* t_m, int32_t* idx_m,
    const int32_t* __restrict__ fs, const int32_t* __restrict__ fd,
    const float* __restrict__ w, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ cols, int32_t* __restrict__ spill, int n,
    int d, int b, int r) {
  const int lane = threadIdx.x;
  const size_t leaf = blockIdx.x;
  const size_t moff = leaf * (size_t)d * d * b;
  int32_t* m_fps = fp_s + moff;
  int32_t* m_fpd = fp_d + moff;
  int32_t* m_t = t_m + moff;
  int32_t* m_idx = idx_m + moff;
  float* m_w = w_m + moff;
  const int rr = r * r;
  for (int e0 = 0; e0 < n; e0 += kTile) {
    const int cnt = min(kTile, n - e0);
    const size_t it0 = leaf * n + e0;
    const size_t my_it = it0 + (lane < cnt ? lane : 0);
    const int my_fs = fs[my_it], my_fd = fd[my_it], my_t = t[my_it];
    const float my_w = w[my_it];
    const int my_v = lane < cnt && valid[my_it];
    int my_spill = 0;
    for (int e = 0; e < cnt; ++e) {
      const int f_s = __shfl_sync(kFull, my_fs, e);
      const int f_d = __shfl_sync(kFull, my_fd, e);
      const int tv = __shfl_sync(kFull, my_t, e);
      const float wv = __shfl_sync(kFull, my_w, e);
      if (!__shfl_sync(kFull, my_v, e)) continue;      // warp-uniform
      const size_t it = it0 + e;
      bool done = false;
      for (int g = 0; g < rr && !done; g += 32) {
        const int k = g + lane;
        int mslot = -1, eslot = -1;
        size_t base = 0;
        if (k < rr) {
          base = ((size_t)rows[it * r + k / r] * d + cols[it * r + k % r]) *
                 b;
          for (int s = 0; s < b; ++s) {
            const int32_t x = m_fps[base + s];
            if (mslot < 0 && x != kEmpty && x == f_s &&
                m_fpd[base + s] == f_d && m_t[base + s] == tv)
              mslot = s;
            if (eslot < 0 && x == kEmpty) eslot = s;
            if (mslot >= 0) break;         // a match is final in a bucket
          }
        }
        const unsigned ok = __ballot_sync(kFull, mslot >= 0 || eslot >= 0);
        done = ok != 0u;
        if (done && lane == __ffs(ok) - 1) {
          const size_t c = base + (mslot >= 0 ? mslot : eslot);
          if (mslot < 0) {
            m_fps[c] = f_s;
            m_fpd[c] = f_d;
            m_t[c] = tv;
            m_idx[c] = k;
          }
          m_w[c] = __fadd_rn(m_w[c], wv);
        }
        __syncwarp();
      }
      if (lane == e) my_spill = !done;
    }
    if (lane < cnt) spill[it0 + lane] = my_spill;
  }
}

template <int B>
int launch(size_t smem, int L, int n, int d, int r, cudaStream_t stream,
           void* fp_s, void* fp_d, void* w_m, void* t_m, void* idx_m,
           const void* fs, const void* fd, const void* w, const void* t,
           const void* valid, const void* rows, const void* cols,
           void* spill) {
  static size_t configured[kMaxDevices] = {};
  const cudaError_t err = allow_smem(leaf_insert_kernel<B>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  leaf_insert_kernel<B><<<L, 32, smem, stream>>>(
      (int32_t*)fp_s, (int32_t*)fp_d, (float*)w_m, (int32_t*)t_m,
      (int32_t*)idx_m, (const int32_t*)fs, (const int32_t*)fd,
      (const float*)w, (const int32_t*)t, (const uint8_t*)valid,
      (const int32_t*)rows, (const int32_t*)cols, (int32_t*)spill, n, d, r);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
// b <= 8 and r*r <= 32 take leaf_insert_kernel<b>, any other shape
// leaf_insert_any_kernel; a leaf whose shared-memory staging exceeds the
// device's opt-in limit takes leaf_insert_global_kernel.  *form is set to
// the kernel launched: 0, 1 or 2 in that order.
extern "C" int higgs_leaf_insert(
    void* fp_s, void* fp_d, void* w_m, void* t_m, void* idx_m,
    const void* fs, const void* fd, const void* w, const void* t,
    const void* valid, const void* rows, const void* cols, void* spill,
    int L, int n, int d, int b, int r, void* stream, int* form) {
  if (L <= 0) return 0;
  if (b < 1 || r < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool any = b > kMaxB || r * r > 32;
  const size_t smem =
      any ? (size_t)d * d * b * 5 * 4 + (size_t)kTile * (5 + 2 * r) * 4
          : (size_t)d * d * b * (16 + 4);
  size_t limit = 0;
  const cudaError_t qerr = smem_optin(&limit);
  if (qerr != cudaSuccess) return (int)qerr;
  if (smem > limit) {
    *form = 2;
    leaf_insert_global_kernel<<<L, 32, 0, s>>>(
        (int32_t*)fp_s, (int32_t*)fp_d, (float*)w_m, (int32_t*)t_m,
        (int32_t*)idx_m, (const int32_t*)fs, (const int32_t*)fd,
        (const float*)w, (const int32_t*)t, (const uint8_t*)valid,
        (const int32_t*)rows, (const int32_t*)cols, (int32_t*)spill, n, d, b,
        r);
    return (int)cudaGetLastError();
  }
  if (any) {
    *form = 1;
    static size_t configured[kMaxDevices] = {};
    const cudaError_t err =
        allow_smem(leaf_insert_any_kernel, smem, configured);
    if (err != cudaSuccess) return (int)err;
    leaf_insert_any_kernel<<<L, 32, smem, s>>>(
        (int32_t*)fp_s, (int32_t*)fp_d, (float*)w_m, (int32_t*)t_m,
        (int32_t*)idx_m, (const int32_t*)fs, (const int32_t*)fd,
        (const float*)w, (const int32_t*)t, (const uint8_t*)valid,
        (const int32_t*)rows, (const int32_t*)cols, (int32_t*)spill, n, d, b,
        r);
    return (int)cudaGetLastError();
  }
  *form = 0;
#define HIGGS_LEAF_CASE(B)                                                 \
  case B:                                                                  \
    return launch<B>(smem, L, n, d, r, s, fp_s, fp_d, w_m, t_m, idx_m, fs, \
                     fd, w, t, valid, rows, cols, spill);
  switch (b) {
    HIGGS_LEAF_CASE(1)
    HIGGS_LEAF_CASE(2)
    HIGGS_LEAF_CASE(3)
    HIGGS_LEAF_CASE(4)
    HIGGS_LEAF_CASE(5)
    HIGGS_LEAF_CASE(6)
    HIGGS_LEAF_CASE(7)
    HIGGS_LEAF_CASE(8)
  }
#undef HIGGS_LEAF_CASE
  return (int)cudaErrorInvalidValue;
}
