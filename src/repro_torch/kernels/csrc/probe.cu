// K3/K4: edge and vertex probes on Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of the reference package:
//   src/repro/kernels/probe.py:107 edge_probe_pallas   (K3)
//   src/repro/kernels/probe.py:139 vertex_probe_pallas (K4)
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
// vector unit.  On Hopper a gather is cheap, and the two kernels gather
// differently:
//
// K3 (edge): one launch per edge batch, over all its probe entries (an
//   entry is one (level, range class) of the planner's plan: a level's
//   matrices, or the time-filtered leaves).  The port's first K3 (one
//   launch per entry, one warp per query, each lane walking
//   ceil(m*r*r*b/32) slots, and per slot three divisions, four metadata
//   loads and then the dependent fp_s -> fp_d -> t -> w loads) was
//   latency-bound and launch-bound, not byte-bound: at the smoke run's
//   shapes it took 11-13 us per level whatever the level's bytes (0.1-2
//   us at HBM rate), plus the wrapper's host work for each level.  Here:
//   - the entries' descriptors (slab pointers, d, m, shift s, [ts, te],
//     time flag) travel by value as a kernel parameter, their idx/mask
//     concatenated in one buffer, and blockIdx.y picks the entry;
//   - one warp per (entry, query) reads the query's leaf-level
//     fingerprint and chain, and the slab rows of up to 32 matrices, in
//     one round trip, shifts the coordinates to the entry's level in
//     registers (cmatrix.level_coords), and hands rows and candidates to
//     the lanes by shuffle: the host computes no per-level coordinates,
//     and no barrier or shared memory is needed;
//   - lane l walks slots l, l + 32, ... in the mixed radix (matrix, i, j,
//     slot), stepped by carries (no division in the loop; the paper's
//     r = 4, b = 3 as template constants, any other shape at run time), so
//     neighbouring lanes read neighbouring slots of a bucket; it issues
//     the fp_s loads of kSlots slots at once, then fp_d only for the
//     slots still matching, then t and w: a round trip or three per
//     kSlots slots instead of 3-4 per slot.  Giving each lane a whole
//     bucket instead (b loads to one sector) measured slower at the top
//     levels, and 12 slots in flight slower than 6 (fewer warps fit);
//   - each lane adds its matches in a fixed order and a fixed shuffle tree
//     sums the lanes: deterministic, no atomics.
//   Over all levels the launch still takes several times its byte bound;
//   what binds it is measured in PERF.md (sections 6 and 7).
//
// K4 (vertex): many queries share candidate lines (query vertices are
//   Zipf-drawn and a level has at most m*d distinct lines), so a kernel per
//   query reads the same lines again and again -- about 1.2 GB of traffic
//   per launch at level 6 against 38 MB of distinct bytes -- and "in" lines
//   are columns, b-slot runs d*b*4 bytes apart.  Here the (query,
//   candidate) pairs are grouped by line block (up to kMaxLines adjacent
//   lines; about 128 blocks once d >= 128), and each block of a matrix is
//   read from global memory once per work unit of kPairs pairs (once per
//   launch unless more pairs fall on it), with coalesced reads: "out" lines
//   are row segments, and a block of adjacent columns is read as row
//   segments of nl*b contiguous slots.  At the top levels a line holds many
//   slots of the queried fingerprint (the hot vertices' edges, and
//   fingerprints shortened by a bit per level), so w (and t) are staged
//   beside fp and every slot is added branch-free.  Three launches per
//   chunk of kMaxPairs pairs:
//   1. prep (one CTA per kSeg pairs, so the grouping's scattered traffic
//      spreads over SMs): pairs with equal (line, fv) share one
//      representative (the Zipf-drawn query sets repeat their hot
//      vertices), and the representatives are sorted by line block within
//      the CTA's segment;
//   2. probe (one CTA per line block, unit slot and matrix): concatenate
//      the segments' runs of the block, take units of kPairs pairs, stage
//      the block's slots in shared memory (cp.async, chunks of the cross
//      dimension); each thread owns one pair and scans its line with four
//      running sums (threads on one line read the same words: a
//      broadcast); one partial per (matrix, pair);
//   3. sum: each query adds its pairs' representatives' m*r partials in a
//      fixed order (matrix, then candidate).  No float atomics: results are
//      deterministic.
//   Bound: the distinct candidate lines' bytes; the compare loop, m*d*b
//   slots per distinct pair, is of the same order at the top levels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int kMaxEntries = 16;   // probe entries per launch
constexpr int kEdgeWarps = 8;     // queries per CTA, one warp each
constexpr int kSlots = 6;         // slots in flight per lane

struct EdgeEntry {                // one probe entry; kernels/probe.py mirrors
  const int32_t* fp_s;            // the layout (_EdgeEntry)
  const int32_t* fp_d;
  const float* w;
  const int32_t* t;
  int d, m, off, s;   // side, matrices, offset into idx/mask, level shift
  uint32_t ts, te;
  int match_time, pad;
};
static_assert(sizeof(EdgeEntry) == 64, "EdgeEntry layout");

struct EdgeEntries {
  EdgeEntry e[kMaxEntries];
};

struct EdgeQueries {              // leaf-level query coordinates
  const int32_t* f1s;             // (q,) fingerprints
  const int32_t* rows1;           // (q, r) chains
  const int32_t* f1d;
  const int32_t* cols1;
  int q, r, b, F1;
};

// the level's fingerprint and line from the leaf level's, on uint32, as
// cmatrix.level_coords: 1 <= F1 - s <= 32, and F1 - s <= 31 when s > 0
// (a shift by 32 is undefined)
__device__ __forceinline__ uint32_t level_fp(uint32_t f1, int F1, int s) {
  return F1 - s >= 32 ? f1 : f1 & ((1u << (F1 - s)) - 1u);
}

__device__ __forceinline__ uint32_t level_line(uint32_t line1, uint32_t f1,
                                               int F1, int s) {
  return s == 0 ? line1 : (line1 << s) | (f1 >> (F1 - s));
}

struct QueryAtLevel {
  uint32_t f1s, f1d;              // leaf level
  uint32_t fs, fd;                // the entry's level
  uint32_t row, col;              // candidate `lane` (lanes < r)
};

__device__ __forceinline__ QueryAtLevel query_at_level(const EdgeQueries& qs,
                                                       int qi, int lane,
                                                       int s) {
  QueryAtLevel a{};
  a.f1s = (uint32_t)qs.f1s[qi];
  a.f1d = (uint32_t)qs.f1d[qi];
  a.fs = level_fp(a.f1s, qs.F1, s);
  a.fd = level_fp(a.f1d, qs.F1, s);
  if (lane < qs.r) {
    const size_t c = (size_t)qi * qs.r + lane;
    a.row = level_line((uint32_t)qs.rows1[c], a.f1s, qs.F1, s);
    a.col = level_line((uint32_t)qs.cols1[c], a.f1d, qs.F1, s);
  }
  return a;
}

// slab rows of the entry's matrices m0 + lane (lanes < n; -1 where
// masked), off = the entry's offset + m0
__device__ __forceinline__ int32_t lane_rows(const int32_t* __restrict__ idx,
                                             const uint8_t* __restrict__ mask,
                                             int off, int n, int lane) {
  int32_t v = -1;
  if (lane < n) {
    const int32_t x = idx[off + lane];
    v = mask[off + lane] ? x : -1;
  }
  return v;
}

// N candidate slots at addr[k] (ok[k]: a slot of an unmasked matrix): all
// fp_s loads issue before any compare, fp_d loads only for the slots still
// matching, then t and w; the matches' weights add to acc in slot order
template <int N>
__device__ __forceinline__ float probe_slots(const EdgeEntry& E,
                                             const size_t (&addr)[N],
                                             const bool (&ok)[N],
                                             uint32_t qfs, uint32_t qfd,
                                             float acc) {
  int32_t v[N];
  bool hit[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = ok[k] ? __ldg(E.fp_s + addr[k]) : 0;
#pragma unroll
  for (int k = 0; k < N; ++k) hit[k] = ok[k] && (uint32_t)v[k] == qfs;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = hit[k] ? __ldg(E.fp_d + addr[k]) : 0;
#pragma unroll
  for (int k = 0; k < N; ++k) hit[k] = hit[k] && (uint32_t)v[k] == qfd;
  float wv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    wv[k] = hit[k] ? __ldg(E.w + addr[k]) : 0.f;
    v[k] = hit[k] && E.match_time ? __ldg(E.t + addr[k]) : 0;
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (hit[k] && (!E.match_time || in_range(v[k], E.ts, E.te)))
      acc += wv[k];
  return acc;
}

// one warp per (entry blockIdx.y, query): the lanes walk the entry's
// m*r*r*b candidate slots, lane l taking slots l, l + 32, ..., in the
// mixed radix (matrix, i, j, slot) stepped by carries, so neighbouring
// lanes read neighbouring slots of a bucket.  R, B > 0 fix r and b at
// compile time; R = B = 0 takes the launch's.
template <int R, int B>
__global__ void __launch_bounds__(kEdgeWarps * 32) edge_probe_kernel(
    const __grid_constant__ EdgeEntries ents, const EdgeQueries qs,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ mask,
    float* __restrict__ out) {
  const EdgeEntry E = ents.e[blockIdx.y];
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (qi >= qs.q) return;                  // whole warps; no barrier follows
  const int r = R ? R : qs.r, b = B ? B : qs.b;
  // one round trip: the query's coordinates and the first 32 matrices'
  // slab rows, handed out by shuffle
  int32_t rows_m = lane_rows(idx, mask, E.off, E.m, lane);
  const QueryAtLevel a = query_at_level(qs, qi, lane, E.s);
  // 32 slots in the radix (matrix, i, j, slot)
  const int dsl = 32 % b, dj = 32 / b % r, di = 32 / b / r % r,
            dm = 32 / b / r / r;
  const size_t mat = (size_t)E.d * E.d * b;
  const size_t qrow = (size_t)qi * r;
  float acc = 0.f;
  for (int m0 = 0; m0 < E.m; m0 += 32) {
    if (m0) rows_m = lane_rows(idx, mask, E.off + m0, E.m - m0, lane);
    const long long S = (long long)min(32, E.m - m0) * r * r * b;
    int sl = lane % b, j = lane / b % r, i = lane / b / r % r,
        mi = lane / b / r / r;
    for (long long e0 = lane; e0 < S + lane; e0 += 32 * kSlots) {
      size_t addr[kSlots];
      bool ok[kSlots];
#pragma unroll
      for (int g = 0; g < kSlots; ++g) {
        uint32_t row = __shfl_sync(kFull, a.row, i & 31);
        uint32_t col = __shfl_sync(kFull, a.col, j & 31);
        if (R == 0 && r > 32) {                // candidates not in lanes
          row = level_line((uint32_t)qs.rows1[qrow + i], a.f1s, qs.F1, E.s);
          col = level_line((uint32_t)qs.cols1[qrow + j], a.f1d, qs.F1, E.s);
        }
        const int32_t slab_row = __shfl_sync(kFull, rows_m, mi & 31);
        ok[g] = e0 + 32 * g < S && slab_row >= 0;
        addr[g] = (size_t)slab_row * mat + ((size_t)row * E.d + col) * b + sl;
        sl += dsl;
        j += dj;
        i += di;
        mi += dm;
        if (sl >= b) { sl -= b; ++j; }
        if (j >= r) { j -= r; ++i; }
        if (i >= r) { i -= r; ++mi; }
      }
      acc = probe_slots(E, addr, ok, a.fs, a.fd, acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[(size_t)blockIdx.y * qs.q + qi] = acc;
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

constexpr int kMaxLines = 8;     // adjacent lines per line block (at most)
constexpr int kPairs = 128;      // pairs per work unit = probe CTA threads
constexpr int kStage = 768;      // slots per line per staged chunk
constexpr int kSeg = 1024;       // pairs per prep CTA (one per thread)
constexpr int kMaxSegs = 16;     // prep CTAs per launch
constexpr int kMaxPairs = kSeg * kMaxSegs;   // pairs per launch
constexpr int kHash = 2 * kSeg;

// a staged chunk of a line: stage_cross(b) cross positions of
// stage_slots(b) slots each (b > kStage: a cross position's slots in
// chunks of kStage)
__host__ __device__ __forceinline__ int stage_cross(int b) {
  return b < kStage ? kStage / b : 1;
}

__host__ __device__ __forceinline__ int stage_slots(int b) {
  return b < kStage ? b : kStage;
}

__host__ __device__ __forceinline__ int stage_pitch(int b) {
  // words per staged line: a multiple of 4 (16-byte loads) that is 4 mod
  // 32, so the lines of a block start on distinct bank quads
  return (stage_cross(b) * stage_slots(b) + 31) / 32 * 32 + 4;
}

// lines per block: 1 up to d = 128, then about 128 blocks, at most 8 lines
__host__ __device__ __forceinline__ int lines_per_block(int d) {
  return d >= 128 * kMaxLines ? kMaxLines : (d >= 256 ? d / 128 : 1);
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src));
}

// 1. one CTA per segment of kSeg pairs p = qi*r + i (one per thread):
//    pairs with equal (line, fv) share one representative (queries repeat:
//    Zipf-drawn vertices), rep_of[p]; the representatives are sorted by
//    line block inside the segment's slice of `order`, with their count
//    and offset per block in cnt/off[segment][block].
__global__ void __launch_bounds__(kSeg) vertex_prep_kernel(
    const int32_t* __restrict__ fv, const int32_t* __restrict__ rows, int P,
    int r, int d, int32_t* __restrict__ order, int32_t* __restrict__ cnt,
    int32_t* __restrict__ off, int32_t* __restrict__ rep_of) {
  extern __shared__ int32_t sh[];
  const int lb = lines_per_block(d), nblk = (d + lb - 1) / lb;
  int32_t* s_ln = sh;                   // line of each pair
  int32_t* s_f = sh + kSeg;             // fv of each pair
  int32_t* s_tab = sh + 2 * kSeg;       // hash -> pair slot
  int32_t* hist = s_tab + kHash;        // representatives per block
  int32_t* warps = hist + nblk;         // 32
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int seg0 = blockIdx.x * kSeg, p = seg0 + tid;
  const bool active = p < P;
  const int ln = active ? rows[p] : -1;
  const int32_t f = active ? fv[p / r] : 0;
  s_ln[tid] = ln;
  s_f[tid] = f;
  for (int i = tid; i < kHash; i += kSeg) s_tab[i] = -1;
  for (int i = tid; i < nblk; i += kSeg) hist[i] = 0;
  __syncthreads();
  uint32_t h = ((uint32_t)ln * 0x9E3779B1u) ^ (uint32_t)f;
  h *= 0x85EBCA6Bu;
  h = active ? (h ^ (h >> 15)) & 0x7FFFFFFFu : 0x80000000u | (unsigned)lane;
  // lanes with equal hashes defer to their leader, so a hot vertex costs
  // one table probe per warp
  const unsigned peers = __match_any_sync(kFull, h);
  const int leader = __ffs(peers) - 1;
  const bool same = s_ln[wid * 32 + leader] == ln &&
                    s_f[wid * 32 + leader] == f;
  auto insert = [&]() -> int {
    for (int slot = h & (kHash - 1);; slot = (slot + 1) & (kHash - 1)) {
      const int old = atomicCAS(&s_tab[slot], -1, tid);
      if (old < 0) return tid;
      if (s_ln[old] == ln && s_f[old] == f) return old;
    }
  };
  int rep = tid;
  if (active && lane == leader) rep = insert();
  const int lead_rep = __shfl_sync(kFull, rep, leader);
  if (active && lane != leader) rep = same ? lead_rep : insert();
  if (active) rep_of[p] = seg0 + rep;
  const bool is_rep = active && rep == tid;
  const int blk = is_rep ? ln / lb : -1;
  const int rank = is_rep ? atomicAdd(&hist[blk], 1) : 0;
  __syncthreads();
  // exclusive scan of hist (nblk counts) by the whole CTA
  const int per = (nblk + kSeg - 1) / kSeg;
  const int lo = min(nblk, tid * per), hi = min(nblk, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) {
    sum += hist[i];
    cnt[blockIdx.x * nblk + i] = hist[i];
  }
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warps[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    int wv = warps[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, wv, o);
      if (lane >= o) wv += v;
    }
    warps[lane] = wv;
  }
  __syncthreads();
  int run = inc - sum + (wid > 0 ? warps[wid - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = hist[i];
    hist[i] = run;
    off[blockIdx.x * nblk + i] = run;
    run += v;
  }
  __syncthreads();
  if (is_rep) order[seg0 + hist[blk] + rank] = p;
}

// 2. one CTA per (line block, unit slot, matrix): the block's
//    representatives are the concatenation of the segments' runs; the CTA
//    takes units of kPairs of them (u = blockIdx.y, + gridDim.y, ...),
//    stages the block's fp, w (and t) (cp.async, chunks of the cross
//    dimension, and of a cross position's slots when b > kStage), and
//    each thread scans its pair's line: four running sums over staged
//    slots 4i .. 4i+3, added in a fixed order.  partial[mi][p] = the
//    representative pair's sum.
template <bool TIME>
__global__ void __launch_bounds__(kPairs) vertex_probe_kernel(
    const int32_t* __restrict__ fp, const float* __restrict__ w,
    const int32_t* __restrict__ t, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ fv,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ order,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ off,
    int nseg, uint32_t ts, uint32_t te, int dir_in,
    float* __restrict__ partial, int P, int d, int b, int r) {
  extern __shared__ __align__(16) int32_t s_fp[];   // lb x pitch, fp
  __shared__ int32_t s_pre[kMaxSegs + 1], s_src[kMaxSegs];
  const int blk = blockIdx.x, mi = blockIdx.z;
  if (!mask[mi]) return;                      // the sum skips masked ones
  const int tid = threadIdx.x;
  const int lb = lines_per_block(d), nblk = (d + lb - 1) / lb;
  if (tid < 32) {                             // runs of the segments
    const int c = tid < nseg ? cnt[tid * nblk + blk] : 0;
    int inc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, o);
      if (tid >= o) inc += v;
    }
    if (tid < nseg) {
      s_pre[tid] = inc - c;
      s_src[tid] = tid * kSeg + off[tid * nblk + blk];
    }
    if (tid == 31) s_pre[kMaxSegs] = inc;
  }
  __syncthreads();
  const int n_b = s_pre[kMaxSegs];
  const int pitch = stage_pitch(b);
  int32_t* s_w = s_fp + lb * pitch;           // then w, then t
  int32_t* s_t = s_w + lb * pitch;
  const int X = stage_cross(b), SB = stage_slots(b);
  const int l0 = blk * lb, nl = min(lb, d - l0);
  const size_t mbase = (size_t)idx[mi] * d * d * b;
  // "in": row x of a chunk holds seg = nl*b contiguous slots; thread tid
  // stages slot k_in of rows tid / seg, tid / seg + rows_per_pass, ...
  const int seg = nl * b, rows_per_pass = kPairs / seg;
  const int k_in = tid % seg, l_in = k_in / b, s_in = k_in - l_in * b;
  for (int u0 = blockIdx.y * kPairs; u0 < n_b; u0 += gridDim.y * kPairs) {
    const int j = u0 + tid;
    int p = -1, line = l0;
    int32_t f = 0;
    if (j < n_b) {
      int g = 0;
      while (g + 1 < nseg && s_pre[g + 1] <= j) ++g;
      p = order[s_src[g] + j - s_pre[g]];
      line = rows[p];
      f = fv[p / r];
    }
    const int li = (line - l0) * pitch;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int x0 = 0; x0 < d; x0 += X)
    for (int s0 = 0; s0 < b; s0 += SB) {
      // stage fp, w (and t) of the block's lines: cross positions x0 ..
      // x0 + nx - 1, slots s0 .. s0 + ns - 1 (ns = b, or nx = 1); element
      // e of a staged line is cross x0 + e / ns, slot s0 + e % ns
      const int nx = min(X, d - x0), ns = min(SB, b - s0), run = nx * ns;
      auto stage = [&](int dst, size_t src) {
        cp_async4(s_fp + dst, fp + src);
        cp_async4(s_w + dst, reinterpret_cast<const int32_t*>(w) + src);
        if (TIME) cp_async4(s_t + dst, t + src);
      };
      if (!dir_in) {                          // line = row: contiguous runs
        for (int l = 0; l < nl; ++l) {
          const size_t g = mbase + ((size_t)(l0 + l) * d + x0) * b + s0;
          for (int e = tid; e < run; e += kPairs) stage(l * pitch + e, g + e);
        }
      } else if (rows_per_pass > 0) {         // line = column; ns = b
        if (tid < rows_per_pass * seg) {
          for (int x = tid / seg; x < nx; x += rows_per_pass)
            stage(l_in * pitch + x * b + s_in,
                  mbase + ((size_t)(x0 + x) * d + l0) * b + k_in);
        }
      } else {                                // wide buckets: seg > kPairs
        const int sg = nl * ns;
        for (int e = tid; e < nx * sg; e += kPairs) {
          const int x = e / sg, k = e - x * sg, l = k / ns, sl = k - l * ns;
          stage(l * pitch + x * ns + sl,
                mbase + ((size_t)(x0 + x) * d + l0 + l) * b + s0 + sl);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();
      if (p >= 0) {
        // four running sums (slots 4i, 4i+1, ...), added in a fixed order
        const int32_t* lf = s_fp + li;
        const float* lw = reinterpret_cast<const float*>(s_w + li);
        const int32_t* lt = s_t + li;
        auto take = [&](int32_t fpv, int32_t tv) {
          return fpv == f && (!TIME || in_range(tv, ts, te));
        };
        const int run4 = run & ~3;
        for (int e = 0; e < run4; e += 4) {
          const int4 fq = *reinterpret_cast<const int4*>(lf + e);
          const float4 wq = *reinterpret_cast<const float4*>(lw + e);
          int4 tq = make_int4(0, 0, 0, 0);
          if (TIME) tq = *reinterpret_cast<const int4*>(lt + e);
          a0 += take(fq.x, tq.x) ? wq.x : 0.f;
          a1 += take(fq.y, tq.y) ? wq.y : 0.f;
          a2 += take(fq.z, tq.z) ? wq.z : 0.f;
          a3 += take(fq.w, tq.w) ? wq.w : 0.f;
        }
        for (int e = run4; e < run; ++e)
          a0 += take(lf[e], TIME ? lt[e] : 0) ? lw[e] : 0.f;
      }
      __syncthreads();
    }
    const float acc = (a0 + a1) + (a2 + a3);
    if (p >= 0) partial[(size_t)mi * P + p] = acc;
  }
}

// 3. out[qi] = sum over unmasked matrices, then candidates, of the
//    partials of each candidate pair's representative
__global__ void vertex_sum_kernel(const float* __restrict__ partial,
                                  const uint8_t* __restrict__ mask,
                                  const int32_t* __restrict__ rep_of,
                                  float* __restrict__ out, int m, int q,
                                  int r) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const size_t P = (size_t)q * r;
  const int32_t* src = rep_of + (size_t)qi * r;
  float acc = 0.f;
  for (int mi = 0; mi < m; ++mi) {
    if (!mask[mi]) continue;
    for (int i = 0; i < r; ++i) acc += partial[mi * P + src[i]];
  }
  out[qi] = acc;
}

struct VertexWorkspace {
  int32_t *order, *cnt, *off, *rep_of;
  float* partial;
};

// int32 words of scratch for launches of P <= kMaxPairs pairs: order[P],
// cnt and off[segments * nblk], rep_of[P], partial[m * P]
__host__ VertexWorkspace vertex_workspace(void* base, int m, int q, int d,
                                          int r, size_t* words) {
  const int qc = q < kMaxPairs / r ? q : kMaxPairs / r;
  const size_t P = (size_t)qc * r;
  const int lb = lines_per_block(d), nblk = (d + lb - 1) / lb;
  const size_t nseg = (P + kSeg - 1) / kSeg;
  int32_t* w32 = static_cast<int32_t*>(base);
  VertexWorkspace ws;
  ws.order = w32;
  ws.cnt = w32 + P;
  ws.off = ws.cnt + nseg * nblk;
  ws.rep_of = ws.off + nseg * nblk;
  ws.partial = reinterpret_cast<float*>(ws.rep_of + P);
  *words = 2 * P + 2 * nseg * nblk + (size_t)m * P;
  return ws;
}

}  // namespace

// All return a cudaError_t (0 on success); launch on `stream`, no sync.

// K3 over n probe entries (`entries`: n host EdgeEntry records; idx/mask
// of entry e at [off, off + m) of `idx`/`mask`), for q queries given at
// the leaf level (f1s/f1d (q,), rows1/cols1 (q, r)); out: (n, q).  One
// launch per kMaxEntries entries.
extern "C" int higgs_edge_probe_levels(
    const void* entries, int n, const void* idx, const void* mask,
    const void* f1s, const void* rows1, const void* f1d, const void* cols1,
    void* out, int q, int b, int r, int F1, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (b < 1 || r < 1 || F1 < 1 || F1 > 32) return (int)cudaErrorInvalidValue;
  const EdgeEntry* src = static_cast<const EdgeEntry*>(entries);
  const EdgeQueries qs{(const int32_t*)f1s, (const int32_t*)rows1,
                       (const int32_t*)f1d, (const int32_t*)cols1, q, r, b,
                       F1};
  cudaStream_t s = (cudaStream_t)stream;
  for (int e0 = 0; e0 < n; e0 += kMaxEntries) {
    const int ne = n - e0 < kMaxEntries ? n - e0 : kMaxEntries;
    EdgeEntries ents{};
    for (int k = 0; k < ne; ++k) {
      const EdgeEntry& e = src[e0 + k];
      if (e.d < 1 || e.m < 0 || e.off < 0 || e.s < 0 || F1 - e.s < 1 ||
          (e.s > 0 && F1 - e.s > 31))
        return (int)cudaErrorInvalidValue;
      ents.e[k] = e;
    }
    const dim3 grid((q + kEdgeWarps - 1) / kEdgeWarps, ne);
    const int32_t* ix = (const int32_t*)idx;
    const uint8_t* mk = (const uint8_t*)mask;
    float* o = (float*)out + (size_t)e0 * q;
    // the paper's shape (r = 4, b = 3) has its own instance: 1.6x faster
    // than the runtime-shape form at the smoke shapes (PERF.md, section 6)
    if (r == 4 && b == 3)
      edge_probe_kernel<4, 3><<<grid, kEdgeWarps * 32, 0, s>>>(ents, qs, ix,
                                                                mk, o);
    else
      edge_probe_kernel<0, 0><<<grid, kEdgeWarps * 32, 0, s>>>(ents, qs, ix,
                                                                mk, o);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" size_t higgs_vertex_probe_workspace(int m, int q, int d,
                                               int r) {
  size_t words = 0;
  vertex_workspace(nullptr, m, q, d, r, &words);
  return words;
}

// `ws` holds higgs_vertex_probe_workspace(m, q, d, r) int32 words.
// Takes r <= kMaxPairs (cudaErrorInvalidValue otherwise): a query's r
// candidate pairs go through one launch.
extern "C" int higgs_vertex_probe(
    const void* fp, const void* w, const void* t, const void* idx,
    const void* mask, const void* fv, const void* rows, unsigned int ts,
    unsigned int te, int match_time, int dir_in, void* out, void* ws_base,
    int m, int q, int d, int b, int r, void* stream) {
  if (q <= 0) return 0;
  if (b < 1 || r < 1 || r > kMaxPairs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  size_t words = 0;
  const VertexWorkspace ws = vertex_workspace(ws_base, m, q, d, r, &words);
  const int lb = lines_per_block(d), nblk = (d + lb - 1) / lb;
  const size_t gsmem = (2 * kSeg + kHash + nblk + 32) * sizeof(int32_t);
  const size_t psmem =
      (size_t)(match_time ? 3 : 2) * lb * stage_pitch(b) * sizeof(int32_t);
  static size_t conf[3][kMaxDevices] = {};
  cudaError_t err = allow_smem(vertex_prep_kernel, gsmem, conf[2]);
  if (err == cudaSuccess)
    err = match_time ? allow_smem(vertex_probe_kernel<true>, psmem, conf[1])
                     : allow_smem(vertex_probe_kernel<false>, psmem, conf[0]);
  if (err != cudaSuccess) return (int)err;
  const int qchunk = kMaxPairs / r;
  for (int q0 = 0; q0 < q; q0 += qchunk) {
    const int qc = q - q0 < qchunk ? q - q0 : qchunk, P = qc * r;
    const int nseg = (P + kSeg - 1) / kSeg;
    const int32_t* fv_c = (const int32_t*)fv + q0;
    const int32_t* rows_c = (const int32_t*)rows + (size_t)q0 * r;
    vertex_prep_kernel<<<nseg, kSeg, gsmem, s>>>(
        fv_c, rows_c, P, r, d, ws.order, ws.cnt, ws.off, ws.rep_of);
    if (m > 0) {
      // unit slots per block: the mean units per block, plus one
      const dim3 grid(nblk, (P + kPairs * nblk - 1) / (kPairs * nblk) + 1,
                      m);
      if (match_time)
        vertex_probe_kernel<true><<<grid, kPairs, psmem, s>>>(
            (const int32_t*)fp, (const float*)w, (const int32_t*)t,
            (const int32_t*)idx, (const uint8_t*)mask, fv_c, rows_c,
            ws.order, ws.cnt, ws.off, nseg, ts, te, dir_in, ws.partial, P,
            d, b, r);
      else
        vertex_probe_kernel<false><<<grid, kPairs, psmem, s>>>(
            (const int32_t*)fp, (const float*)w, (const int32_t*)t,
            (const int32_t*)idx, (const uint8_t*)mask, fv_c, rows_c,
            ws.order, ws.cnt, ws.off, nseg, ts, te, dir_in, ws.partial, P,
            d, b, r);
    }
    vertex_sum_kernel<<<(qc + 127) / 128, 128, 0, s>>>(
        ws.partial, (const uint8_t*)mask, ws.rep_of, (float*)out + q0, m, qc,
        r);
  }
  return (int)cudaGetLastError();
}
