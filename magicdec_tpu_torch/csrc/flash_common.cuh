// Shared tile step of the two attention kernels (flash_decode.cu,
// flash_prefill.cu): ragged-causal GQA attention of up to 2*MR query rows
// of one KV head against 64-slot tiles of the packed stacked cache
// [L, B, S, Hkv*D], with an f32 online softmax.
//
// Numerics the engine's invariants depend on:
//  * Every query row is computed by its own fixed sequence of operations
//    (dot products in d order, a fixed warp-shuffle tree for the row max and
//    sum, P@V in slot order), so a row's result does not depend on which
//    other rows share the CTA: a T=1 draft row equals the same row inside a
//    T=gamma+1 verify, bit for bit.
//  * Tiles start at fixed multiples of TILE slots and never depend on the
//    cache capacity S, B, T or the SM count.
//  * Masked slots get probability exactly 0; tiles past every row's bound
//    are neither loaded nor computed (an identity for the online softmax).
//  * P is rounded to the cache dtype before the P@V product and l sums the
//    unrounded P, as the TPU kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdt {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;    // threads per CTA
constexpr int TILE = 64;   // cache slots per shared-memory tile
constexpr int NGRP = NT / TILE;  // row groups: thread t owns rows t/TILE + NGRP*i

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (round to nearest even), returned as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

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
// dynamic allocation (all f32 but `hi`).
template <int D>
struct Smem {
  float* q;      // [R][D]       query rows (rows >= M are zero)
  float* k;      // [TILE][D+1]  K tile (padded pitch: conflict-free column reads)
  float* v;      // [TILE][D]    V tile
  float* p;      // [R][TILE]    logits, then probabilities
  float* m;      // [R]          running row max
  float* l;      // [R]          running row sum
  float* alpha;  // [R]          this tile's rescale factor
  int* hi;       // [R]          row bound: slots < hi are attended
  int* hi_min;   // [1]          min / max of hi over the CTA's rows
  int* hi_max;   // [1]

  static constexpr size_t bytes(int R) {
    return sizeof(float) * ((size_t)R * D + TILE * (D + 1) + TILE * D +
                            (size_t)R * TILE + 3 * (size_t)R) +
           sizeof(int) * (R + 2);
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
    hi = reinterpret_cast<int*>(f);
    hi_min = hi + R;
    hi_max = hi + R + 1;
  }
};

// After q/hi/m/l are filled for rows < M: the CTA's min and max row bound.
template <int D>
__device__ __forceinline__ void row_bounds(const Smem<D>& sm, int M) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = 0x7fffffff, hi = 0;
    for (int r = 0; r < M; ++r) {
      lo = min(lo, sm.hi[r]);
      hi = max(hi, sm.hi[r]);
    }
    *sm.hi_min = lo;
    *sm.hi_max = hi;
  }
  __syncthreads();
}

// One 64-slot tile of the online softmax for rows [0, M).
//   kb, vb: this (layer, b) slot 0 at this head's columns; row_stride = Hkv*D
//   n_load: slots of the tile that are loaded (the rest are zero, masked)
//   full:   every slot of the tile is valid for every row (no mask needed)
//   acc:    this thread's rows' accumulators, row = threadIdx.x/TILE + NGRP*i
template <typename T, int D, int MR>
__device__ __forceinline__ void tile_step(const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          int64_t row_stride, int tile_start,
                                          int n_load, bool full, int M,
                                          float scale, const Smem<D>& sm,
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
      const int64_t off = (int64_t)(tile_start + slot) * row_stride + c;
      load_vec16(kb + off, kv);
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
      if (r < M) sm.p[r * TILE + j] = (full || col < sm.hi[r]) ? s[i] * scale : NEG_INF;
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
    const bool v0 = full || tile_start + lane < sm.hi[r];
    const bool v1 = full || tile_start + lane + 32 < sm.hi[r];
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

// Walk the tiles of [start, end) that lie below the CTA's largest row bound.
template <typename T, int D, int MR>
__device__ __forceinline__ void attend_range(const T* __restrict__ kb,
                                             const T* __restrict__ vb,
                                             int64_t row_stride, int start,
                                             int end, int M, float scale,
                                             const Smem<D>& sm, float (&acc)[MR]) {
  const int limit = min(end, *sm.hi_max);
  const int hi_min = *sm.hi_min;
  for (int t0 = start; t0 < limit; t0 += TILE) {
    const int n_load = min(TILE, limit - t0);
    const bool full = t0 + TILE <= hi_min;
    tile_step<T, D, MR>(kb, vb, row_stride, t0, n_load, full, M, scale, sm, acc);
  }
}

}  // namespace mdt
