// Shared tile steps of the attention kernels (flash_decode.cu,
// flash_prefill.cu): GQA attention of the query rows of one KV head against
// 64-slot tiles of the packed cache [L, B, S, Hkv*D], D in {64, 128}, with
// an f32 online softmax. Query row r attends to the slots of
// [0, a_r) u [lo_r, hi_r) (the TPU kernels' one mask form): ragged-causal
// decode and prefill are the case a = lo = 0, the StreamingLLM sink + window
// draft a = sink end, lo = window start, hi = causal end. An optional
// per-column bit vector of the sequence (the round-buffer drafts' colmask)
// further masks slot col unless its bit is set; it is shared by all rows.
//
// Two tile steps:
//  * float32 caches: tile_step, on CUDA cores with exact f32 products (the
//    f32 card checks and the f32 engines). 2*D threads; K and V tiles are
//    widened into shared memory, one fmaf at a time.
//  * bfloat16 caches: warp_tile, on the tensor cores (mma.sync m16n8k16,
//    f32 accumulate). K and V tiles stay bf16 in a ring of STAGES shared
//    stages filled by cp.async (load_tile), so the copies of the next tiles
//    are in flight while one is computed; each warp owns 16 query rows, reads
//    K with ldmatrix and V with ldmatrix.trans (rows padded by 8 elements:
//    conflict-free), and keeps P in registers between the two products;
//    its exponentials run on the SFU (exp_approx: ~2 ulp, far inside the
//    bf16 rounding the kernel checks allow).
//
// Numerics the engine's invariants depend on (both steps):
//  * Every query row is computed by its own fixed sequence of operations
//    (dot products in d order, a fixed shuffle tree for the row max and the
//    sum, P@V in slot order, one rescale per tile), so a row's result does
//    not depend on which other rows share the CTA or on its position among
//    them: a T=1 draft row equals the same row inside a T=gamma+1 verify,
//    bit for bit. (On the tensor cores each element of C is its own row of
//    A times its own column of B; chip_smoke and the card tests check the
//    bits across row positions.)
//  * Tiles start at fixed multiples of TILE slots and never depend on the
//    cache capacity S, B, T or the SM count.
//  * Masked slots get probability exactly 0, so a tile masked for every row
//    leaves (m, l, acc) as they were (alpha = exp(0) = 1, p = 0): tiles past
//    every row's bound, inside every row's gap [a, lo), or whose column bits
//    are all 0 are neither loaded nor computed, an exact identity. The mask
//    forms thus give the same bits wherever their valid sets agree; a tile
//    runs unmasked ("full") only when every slot is valid for every row.
//  * P is rounded to the cache dtype before the P@V product and l sums the
//    unrounded P, as the TPU kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace mdt {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;   // cache slots per shared-memory tile

// ===========================================================================
// float32: the CUDA-core tile step
// ===========================================================================

// Threads of an f32 CTA: 2*D, so the P@V step gives each thread one column
// d of two row groups, and the logits step (TILE slots a pass) 2*D/TILE.
template <int D>
struct F32 {
  static constexpr int NT = 2 * D;
  static constexpr int NGRP_S = NT / TILE;  // logits: thread t owns rows t/TILE + NGRP_S*i
  static constexpr int NGRP_V = NT / D;     // P@V and acc: rows t/D + NGRP_V*i (= 2)
};

// 16 bytes of T at src (16-byte aligned) -> f32 values
template <typename T>
__device__ __forceinline__ void load_vec16(const T* __restrict__ src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f32(e[i]);
}

// Shared memory of one f32 CTA holding R query rows, carved from one
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

// Whether row bounds (a, lo, hi) attend slot col.
__device__ __forceinline__ bool in_rows(int a, int lo, int hi, int col) {
  return col < a || (col >= lo && col < hi);
}

// Whether query row r attends to slot col, column j of the tile; cols: the
// tile's column bits in sm.cm apply.
template <int D>
__device__ __forceinline__ bool attended(const Smem<D>& sm, int r, int col,
                                         int j, bool cols) {
  return in_rows(sm.a[r], sm.lo[r], sm.hi[r], col) && (!cols || sm.cm[j] != 0);
}

// min and max over rows [0, M) of a, lo and hi into bnd[6] (thread 0;
// the caller synchronises around it).
__device__ __forceinline__ void bounds_of(const int* a, const int* lo,
                                          const int* hi, int M, int* bnd) {
  const int* rows[3] = {a, lo, hi};
  for (int i = 0; i < 3; ++i) {
    int mn = 0x7fffffff, mx = 0;
    for (int r = 0; r < M; ++r) {
      mn = min(mn, rows[i][r]);
      mx = max(mx, rows[i][r]);
    }
    bnd[2 * i] = mn;
    bnd[2 * i + 1] = mx;
  }
}

// After q/a/lo/hi/m/l are filled for rows < M: the CTA's min and max of
// each row bound.
template <int D>
__device__ __forceinline__ void row_bounds(const Smem<D>& sm, int M) {
  __syncthreads();
  if (threadIdx.x == 0) bounds_of(sm.a, sm.lo, sm.hi, M, sm.bnd);
  __syncthreads();
}

// One 64-slot tile of the online softmax for rows [0, M), F32<D>::NT threads.
//   kb, vb: this (layer, b) slot 0 at this head's columns; row_stride = Hkv*D
//   ks:     K of slots < n_sink, read in place of kb's (the same layout;
//           null when n_sink = 0)
//   n_load: slots of the tile that are loaded (the rest are zero, masked)
//   full:   every slot of the tile is valid for every row (no mask needed)
//   cols:   the tile's column bits (sm.cm) apply
//   acc:    this thread's rows' accumulators, row = t/D + NGRP_V*i
template <typename T, int D, int MR>
__device__ __forceinline__ void tile_step(const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          const T* __restrict__ ks, int n_sink,
                                          int64_t row_stride, int tile_start,
                                          int n_load, bool full, bool cols,
                                          int M, float scale, const Smem<D>& sm,
                                          float (&acc)[MR]) {
  constexpr int NT = F32<D>::NT, NGRP_S = F32<D>::NGRP_S, NGRP_V = F32<D>::NGRP_V;
  constexpr int R = MR * NGRP_V;
  constexpr int MS = R / NGRP_S;  // rows per thread in the logits step
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

  // 2. logits: thread (j, rg) computes slot j for rows rg + NGRP_S*i
  {
    const int j = tid % TILE, rg = tid / TILE;
    float s[MS];
#pragma unroll
    for (int i = 0; i < MS; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sm.k[j * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < MS; ++i) s[i] = fmaf(sm.q[(rg + NGRP_S * i) * D + d], kd, s[i]);
    }
    const int col = tile_start + j;
#pragma unroll
    for (int i = 0; i < MS; ++i) {
      const int r = rg + NGRP_S * i;
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
    const int d = tid % D, rg = tid / D;
    float pv[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) pv[i] = 0.f;
    for (int jj = 0; jj < TILE; ++jj) {
      const float vj = sm.v[jj * D + d];
#pragma unroll
      for (int i = 0; i < MR; ++i) pv[i] = fmaf(sm.p[(rg + NGRP_V * i) * TILE + jj], vj, pv[i]);
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = rg + NGRP_V * i;
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

// ===========================================================================
// bfloat16: the tensor-core tile step and its cp.async ring
// ===========================================================================

typedef __nv_bfloat16 bf16;

constexpr int STAGES = 3;  // ring depth: up to STAGES - 1 tiles in flight

// bf16 elements per shared row: D + 8, so the 8 rows of an ldmatrix phase
// start 4 banks apart (conflict-free) and every row is 16-byte aligned
template <int D> __host__ __device__ constexpr int pitch() { return D + 8; }

// one ring stage: the K tile, then the V tile, [TILE][pitch] bf16 each
template <int D> __host__ __device__ constexpr int stage_elems() {
  return 2 * TILE * pitch<D>();
}

// Issue the cp.async copies of one tile into a ring stage, by NT threads:
// slots [t0, t0 + n_load) of K (of ks below n_sink) and V, 16 bytes a copy;
// the slots past n_load are zero-filled without being read.
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16* st, const bf16* __restrict__ kb,
                                          const bf16* __restrict__ vb,
                                          const bf16* __restrict__ ks, int n_sink,
                                          int64_t row_stride, int t0, int n_load) {
  constexpr int P = pitch<D>(), CPR = D / 8;  // 16-byte chunks per slot row
  for (int idx = threadIdx.x; idx < TILE * CPR; idx += NT) {
    const int slot = idx / CPR, c = (idx % CPR) * 8;
    const bool ok = slot < n_load;
    const int col = t0 + (ok ? slot : 0);
    const int64_t off = (int64_t)col * row_stride + c;
    cp_async16(st + slot * P + c, (ok && col < n_sink ? ks : kb) + off, ok);
    cp_async16(st + (TILE + slot) * P + c, vb + off, ok);
  }
}

// The online-softmax state of one warp's 16 query rows: rows ra = 16w + g
// and rb = ra + 8 of this lane (g = lane / 4), each lane holding columns
// 2c, 2c+1 of every 8-column block (c = lane % 4). QS: Q's A fragments are
// read from shared memory at every tile (fewer registers) instead of being
// held in registers.
template <int D, bool QS>
struct WarpState {
  uint32_t qa[QS ? 1 : D / 16][4];  // Q as A fragments, one per 16-wide k step
  const bf16* sq;                   // with QS: this warp's 16 Q rows in shared memory
  float o[D / 8][4];       // unnormalised output: [n tile][ra c, ra c+1, rb c, rb c+1]
  float mA, mB;            // running max of rows ra, rb (scaled logits)
  float lA, lB;            // this lane's part of the running sums

  // Q rows [16w, 16w + 16) of a [*, pitch] bf16 tile in shared memory
  __device__ void init(const bf16* sQ, int w) {
    sq = sQ + 16 * w * pitch<D>();
    if constexpr (!QS) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) load_q(qa[ks], ks);
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    mA = mB = NEG_INF;
    lA = lB = 0.f;
  }

  // the A fragment of k step ks
  __device__ __forceinline__ void load_q(uint32_t (&f)[4], int ks) const {
    const int lane = threadIdx.x & 31;
    ldmatrix_x4(f, sq + (lane & 15) * pitch<D>() + ks * 16 + (lane >> 4) * 8);
  }

  // the row sums, reduced over the four lanes of each row
  __device__ void reduce_l() {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lA += __shfl_xor_sync(0xffffffffu, lA, off);
      lB += __shfl_xor_sync(0xffffffffu, lB, off);
    }
  }
};

// Row bounds of one lane's two rows.
struct RowPair {
  int aA, loA, hiA, aB, loB, hiB;
};

// One 64-slot tile of one warp's 16 rows: S = Q K^T (scaled), the mask
// unless full (row bounds, and with cols the tile's column bits), the
// online-softmax update, O = O alpha + P V. sK/sV: the tile's ring stage.
template <int D, bool QS>
__device__ __forceinline__ void warp_tile(WarpState<D, QS>& w, const bf16* sK,
                                          const bf16* sV, int t0, bool full,
                                          const RowPair& rp, bool cols,
                                          uint64_t bits, float scale) {
  constexpr int P = pitch<D>();
  const int lane = threadIdx.x & 31, c = lane & 3;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  // S = Q K^T: k steps in d order; each ldmatrix.x4 of K gives the B
  // fragments of two 8-slot n tiles
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t qa[4];
    if constexpr (QS) {
      w.load_q(qa, ks);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = w.qa[ks][i];
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sK + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * P + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qa, kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
    }
  }
  // scale, mask, row max over the quad of lanes sharing a row
  uint32_t valid = 0xffffffffu;  // bit 2 nt + e: row ra; bit 16 + 2 nt + e: row rb
  float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + 2 * c + e, col = t0 + j;
      bool vA = true, vB = true;
      if (!full) {
        const bool bit = !cols || ((bits >> j) & 1ull);
        vA = bit && in_rows(rp.aA, rp.loA, rp.hiA, col);
        vB = bit && in_rows(rp.aB, rp.loB, rp.hiB, col);
        if (!vA) valid &= ~(1u << (2 * nt + e));
        if (!vB) valid &= ~(1u << (16 + 2 * nt + e));
      }
      s[nt][e] = vA ? s[nt][e] * scale : NEG_INF;
      s[nt][2 + e] = vB ? s[nt][2 + e] * scale : NEG_INF;
      mxA = fmaxf(mxA, s[nt][e]);
      mxB = fmaxf(mxB, s[nt][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
  }
  const float mnA = fmaxf(w.mA, mxA), mnB = fmaxf(w.mB, mxB);
  const float alA = exp_approx(w.mA - mnA), alB = exp_approx(w.mB - mnB);
  w.mA = mnA;
  w.mB = mnB;
  w.lA *= alA;
  w.lB *= alB;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    w.o[nt][0] *= alA;
    w.o[nt][1] *= alA;
    w.o[nt][2] *= alB;
    w.o[nt][3] *= alB;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pa = (valid >> (2 * nt + e)) & 1u ? exp_approx(s[nt][e] - mnA) : 0.f;
      const float pb = (valid >> (16 + 2 * nt + e)) & 1u ? exp_approx(s[nt][2 + e] - mnB) : 0.f;
      w.lA += pa;
      w.lB += pb;
      s[nt][e] = pa;
      s[nt][2 + e] = pb;
    }
  }
  // O += P V: P (rounded to bf16) is the A operand straight from registers;
  // V's B fragments by ldmatrix.trans, two 8-wide n tiles a load
#pragma unroll
  for (int ks = 0; ks < TILE / 16; ++ks) {
    const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                            pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                            pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                            pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sV + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                np * 16 + (lane >> 4) * 8);
      mma_bf16(w.o[2 * np], pa, vf[0], vf[1]);
      mma_bf16(w.o[2 * np + 1], pa, vf[2], vf[3]);
    }
  }
}

}  // namespace mdt
