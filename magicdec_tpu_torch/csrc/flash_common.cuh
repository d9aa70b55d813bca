// Shared tile step of the attention kernels (flash_decode.cu,
// flash_prefill.cu): GQA attention of up to 2*MR query rows of one KV head
// against 64-slot tiles of the packed cache [L, B, S, Hkv*D], with an f32
// online softmax. Query row r attends to the slots of [0, a_r) u [lo_r, hi_r)
// (the TPU kernels' one mask form): ragged-causal decode and prefill are the
// case a = lo = 0, the StreamingLLM sink + window draft a = sink end,
// lo = window start, hi = causal end. An optional per-column bit vector of
// the sequence (the round-buffer drafts' colmask) further masks slot col
// unless its bit is set; it is shared by all rows of the CTA.
//
// Numerics the engine's invariants depend on:
//  * Every query row is computed by its own fixed sequence of operations
//    (dot products in d order, a fixed warp-shuffle tree for the row max and
//    sum, P@V in slot order), so a row's result does not depend on which
//    other rows share the CTA: a T=1 draft row equals the same row inside a
//    T=gamma+1 verify, bit for bit.
//  * Tiles start at fixed multiples of TILE slots and never depend on the
//    cache capacity S, B, T or the SM count.
//  * Masked slots get probability exactly 0, so a tile masked for every
//    row leaves (m, l, acc) as they were (alpha = exp(0) = 1, p = 0): tiles
//    past every row's bound and tiles inside every row's gap [a, lo) are
//    neither loaded nor computed, an exact identity. The two mask forms thus
//    give the same bits wherever their valid sets agree; the same holds for
//    tiles whose column bits are all 0.
//  * P is rounded to the cache dtype before the P@V product and l sums the
//    unrounded P, as the TPU kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace mdt {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;    // threads per CTA
constexpr int TILE = 64;   // cache slots per shared-memory tile
constexpr int NGRP = NT / TILE;  // row groups: thread t owns rows t/TILE + NGRP*i

// 16 bytes of T at src (16-byte aligned) -> f32 values
template <typename T>
__device__ __forceinline__ void load_vec16(const T* __restrict__ src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f32(e[i]);
}

// Shared memory of one CTA holding R = 2*MR query rows, carved from one
// dynamic allocation (all f32 but the row bounds).
template <int D>
struct Smem {
  float* q;      // [R][D]       query rows (rows >= M are zero)
  float* k;      // [TILE][D+1]  K tile (padded pitch: conflict-free column reads)
  float* v;      // [TILE][D]    V tile
  float* p;      // [R][TILE]    logits, then probabilities
  float* m;      // [R]          running row max
  float* l;      // [R]          running row sum
  float* alpha;  // [R]          this tile's rescale factor
  int* a;        // [R]          row bounds: slots of [0, a) u [lo, hi)
  int* lo;       // [R]            are attended
  int* hi;       // [R]
  int* bnd;      // [6]          min / max over the CTA's rows of a, lo, hi
  int* cm;       // [TILE]       this tile's column bits (with a colmask)

  static constexpr size_t bytes(int R) {
    return sizeof(float) * ((size_t)R * D + TILE * (D + 1) + TILE * D +
                            (size_t)R * TILE + 3 * (size_t)R) +
           sizeof(int) * (3 * (size_t)R + 6 + TILE);
  }
  __device__ explicit Smem(int R) {
    extern __shared__ float4 smem_raw[];
    float* f = reinterpret_cast<float*>(smem_raw);
    q = f;        f += R * D;
    k = f;        f += TILE * (D + 1);
    v = f;        f += TILE * D;
    p = f;        f += R * TILE;
    m = f;        f += R;
    l = f;        f += R;
    alpha = f;    f += R;
    a = reinterpret_cast<int*>(f);
    lo = a + R;
    hi = lo + R;
    bnd = hi + R;
    cm = bnd + 6;
  }
};

enum { A_MIN, A_MAX, LO_MIN, LO_MAX, HI_MIN, HI_MAX };

// Whether query row r attends to slot col, column j of the tile; cols: the
// tile's column bits in sm.cm apply.
template <int D>
__device__ __forceinline__ bool attended(const Smem<D>& sm, int r, int col,
                                         int j, bool cols) {
  return (col < sm.a[r] || (col >= sm.lo[r] && col < sm.hi[r])) &&
         (!cols || sm.cm[j] != 0);
}

// After q/a/lo/hi/m/l are filled for rows < M: the CTA's min and max of
// each row bound.
template <int D>
__device__ __forceinline__ void row_bounds(const Smem<D>& sm, int M) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* rows[3] = {sm.a, sm.lo, sm.hi};
    for (int i = 0; i < 3; ++i) {
      int mn = 0x7fffffff, mx = 0;
      for (int r = 0; r < M; ++r) {
        mn = min(mn, rows[i][r]);
        mx = max(mx, rows[i][r]);
      }
      sm.bnd[2 * i] = mn;
      sm.bnd[2 * i + 1] = mx;
    }
  }
  __syncthreads();
}

// One 64-slot tile of the online softmax for rows [0, M).
//   kb, vb: this (layer, b) slot 0 at this head's columns; row_stride = Hkv*D
//   ks:     K of slots < n_sink, read in place of kb's (the same layout;
//           null when n_sink = 0)
//   n_load: slots of the tile that are loaded (the rest are zero, masked)
//   full:   every slot of the tile is valid for every row (no mask needed)
//   cols:   the tile's column bits (sm.cm) apply
//   acc:    this thread's rows' accumulators, row = threadIdx.x/TILE + NGRP*i
template <typename T, int D, int MR>
__device__ __forceinline__ void tile_step(const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          const T* __restrict__ ks, int n_sink,
                                          int64_t row_stride, int tile_start,
                                          int n_load, bool full, bool cols,
                                          int M, float scale, const Smem<D>& sm,
                                          float (&acc)[MR]) {
  static_assert(D == TILE, "thread layout assumes head_dim == TILE");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // 16-byte vectors per slot row
  const int tid = threadIdx.x;

  // 1. stage the K and V tile (only the slots below the CTA's bound)
  for (int idx = tid; idx < TILE * VPR; idx += NT) {
    const int slot = idx / VPR, c = (idx % VPR) * VEC;
    float kv[VEC], vv[VEC];
    if (slot < n_load) {
      const int col = tile_start + slot;
      const int64_t off = (int64_t)col * row_stride + c;
      load_vec16(col < n_sink ? ks + off : kb + off, kv);
      load_vec16(vb + off, vv);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sm.k[slot * (D + 1) + c + e] = kv[e];
      sm.v[slot * D + c + e] = vv[e];
    }
  }
  __syncthreads();

  // 2. logits: thread (j, rg) computes slot j for rows rg + NGRP*i
  const int j = tid % TILE, rg = tid / TILE;
  {
    float s[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sm.k[j * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < MR; ++i) s[i] = fmaf(sm.q[(rg + NGRP * i) * D + d], kd, s[i]);
    }
    const int col = tile_start + j;
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = rg + NGRP * i;
      if (r < M)
        sm.p[r * TILE + j] = (full || attended(sm, r, col, j, cols)) ? s[i] * scale : NEG_INF;
    }
  }
  __syncthreads();

  // 3. online-softmax update, one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < M; r += NT / 32) {
    const float x0 = sm.p[r * TILE + lane], x1 = sm.p[r * TILE + lane + 32];
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, mx);
    const bool v0 = full || attended(sm, r, tile_start + lane, lane, cols);
    const bool v1 = full || attended(sm, r, tile_start + lane + 32, lane + 32, cols);
    const float p0 = v0 ? expf(x0 - m_new) : 0.f;
    const float p1 = v1 ? expf(x1 - m_new) : 0.f;
    float sum = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sm.p[r * TILE + lane] = round_to<T>(p0);
    sm.p[r * TILE + lane + 32] = round_to<T>(p1);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      sm.alpha[r] = alpha;
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();

  // 4. acc = acc * alpha + P @ V: thread (d, rg) owns column d of its rows
  {
    const int d = tid % D;
    float pv[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) pv[i] = 0.f;
    for (int jj = 0; jj < TILE; ++jj) {
      const float vj = sm.v[jj * D + d];
#pragma unroll
      for (int i = 0; i < MR; ++i) pv[i] = fmaf(sm.p[(rg + NGRP * i) * TILE + jj], vj, pv[i]);
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = rg + NGRP * i;
      if (r < M) acc[i] = acc[i] * sm.alpha[r] + pv[i];
    }
  }
  __syncthreads();
}

// Walk the tiles of [start, end) below the CTA's largest row bound, less
// the tiles inside every row's gap [a, lo). The triage reads the CTA-wide
// bounds only, so it is the same for every thread (no divergence around the
// barriers) and conservative: a tile it keeps may still be masked for a row.
// colmask (this sequence's column bits, or null): each tile's 64 bits are
// read into shared memory once; a tile whose bits are all 0 is skipped, and
// a tile counts as full only if all 64 are set (callers pass a = lo = NS
// with the top region's bits in the colmask, so the interval test alone
// would call every top-region tile full and ignore the bits).
template <typename T, int D, int MR>
__device__ __forceinline__ void attend_range(const T* __restrict__ kb,
                                             const T* __restrict__ vb,
                                             const T* __restrict__ ks, int n_sink,
                                             const int* __restrict__ colmask,
                                             int64_t row_stride, int start,
                                             int end, int M, float scale,
                                             const Smem<D>& sm, float (&acc)[MR]) {
  const int a_min = sm.bnd[A_MIN], a_max = sm.bnd[A_MAX];
  const int lo_min = sm.bnd[LO_MIN], lo_max = sm.bnd[LO_MAX];
  const int hi_min = sm.bnd[HI_MIN], hi_max = sm.bnd[HI_MAX];
  const int limit = min(end, max(a_max, hi_max));
  for (int t0 = start; t0 < limit; t0 += TILE) {
    const int t1 = t0 + TILE;
    if (t0 >= a_max && (t1 <= lo_min || t0 >= hi_max)) continue;  // all gap
    const int n_load = min(TILE, limit - t0);
    bool full = t1 <= a_min || (lo_max <= t0 && t1 <= hi_min);
    if (colmask) {
      // the previous tile_step ended on a barrier: no thread reads sm.cm now
      int bit = 0;
      if (threadIdx.x < TILE) {
        bit = threadIdx.x < n_load && colmask[t0 + threadIdx.x] != 0;
        sm.cm[threadIdx.x] = bit;
      }
      const int any = __syncthreads_or(bit);
      const int all = __syncthreads_and(threadIdx.x >= TILE || bit);
      if (!any) continue;  // every slot masked: an exact identity
      full = full && all;
    }
    tile_step<T, D, MR>(kb, vb, ks, n_sink, row_stride, t0, n_load, full,
                        colmask != nullptr, M, scale, sm, acc);
  }
}

}  // namespace mdt
