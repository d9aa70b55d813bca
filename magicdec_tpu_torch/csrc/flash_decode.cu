// Flash decode for Hopper (sm_90a): GQA decode attention of a small query
// block (T*G <= 64 rows per KV head) against one layer of the packed cache
// [L, B, S, Hkv*D], query row r attending to slots [0, a_r) u [lo_r, hi_r),
// optionally only where a per-(layer, b, column) bit is set.
//
// One split kernel serves three TPU kernels of magicdec_tpu/ops/pallas/
// flash_decode.py: flash_decode_stacked (pallas_call at :488; ragged-causal,
// a = lo = 0, read straight out of the stacked cache),
// flash_decode_intervals (pallas_call at :370; flat [B, S, Hkv*D] cache =
// L = 1, the StreamingLLM sink + window mask) and
// flash_decode_stacked_masked (pallas_call at :738; the Quest round buffer
// [L, B, NS + Wcap, Hkv*D] with a = lo = NS and the colmask [L, B, 1, R]
// int32 gating the gathered top region). Sharing it is what makes a
// sink + window draft at full budget give the verify's bits. The TPU
// kernels' block-diagonal query embedding (an MXU workaround) is gone: each
// CTA takes one KV head's columns. The intervals form may also read the K
// of slots < n_sink from a separate [B, n_sink, Hkv*D] tensor (the draft's
// rope-twisted sink rows), so no per-step copy of the cache layer is made.
// The stacked and intervals forms also serve the TPU kernels' return_lse
// outputs (:486-499 and :395-398, the GliDe tree verify and tree draft):
// the merge kernel already holds each row's merged softmax state (m, l) in
// the TPU kernel's units (m the max of the scaled logits, natural base; l
// the sum of exp(s - m)) and writes it to two optional f32 outputs; the
// context output keeps its bits whether they are asked for or not.
// Bound on the H100: bytes. Each call streams the K and V of every valid
// slot once (B * len * Hkv*D * 2 * itemsize) and does ~2*T*G*D FLOPs per
// slot and head, far below the card's ~295 FLOP/byte ridge. Design against
// that bound:
//  * Split-KV: one CTA per (KV split, KV head, b), so B=8 x Hkv=8 fills the
//    132 SMs; a second kernel merges the splits. Each CTA reads its head's
//    columns of its slot range exactly once (16-byte vector loads), and all
//    G*T query rows of the head share that read.
//  * The layer is a pointer offset, not a copy; no slot at or past the
//    CTA's largest row bound is read, so rolled-back tails cost nothing, and
//    tiles inside every row's gap [a, lo) are skipped, and so are tiles
//    whose column bits are all 0 (pad pages of the Quest top region).
// Numerics (the full-budget acceptance == 1.0 invariant):
//  * Splits sit at fixed multiples of SPLIT slots and tiles at multiples of
//    TILE, independent of S, B, T and the SM count, so a draft cache of
//    capacity budget+64 and a target cache of capacity max_len holding the
//    same prefix give the same bits.
//  * Splits merge as unnormalised (acc, m, l) in split order, dividing once
//    at the end; an empty split (l == 0) is skipped, an exact identity.
//  * Rows are independent (see flash_common.cuh).
#include "flash_common.cuh"

namespace mdt {

constexpr int SPLIT = 512;  // slots per KV split: a global constant

// grid (nsplit, Hkv, B). Partials: acc [B, Hkv, nsplit, M, D], ml [.., M, 2].
// a_rows / lo_rows [B, T] may be null (= 0); ksink [B, n_sink, Hkv*D] may be
// null when n_sink = 0; cm_layer [B, S] (this layer's colmask) may be null.
template <typename T, int D, int MR>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_layer,
                    const T* __restrict__ v_layer, const int* __restrict__ a_rows,
                    const int* __restrict__ lo_rows, const int* __restrict__ hi_rows,
                    const T* __restrict__ ksink, int n_sink,
                    const int* __restrict__ cm_layer,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int T_, int Hq, int Hkv, int S, int s_extent, float scale) {
  constexpr int R = 2 * MR;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int G = Hq / Hkv, M = T_ * G;
  Smem<D> sm(R);

  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < M) {
      const int t = r / G, g = r % G;
      x = to_f32(q[(((int64_t)b * T_ + t) * Hq + h * G + g) * D + d]);
    }
    sm.q[idx] = x;
  }
  for (int r = threadIdx.x; r < M; r += NT) {
    const int i = b * T_ + r / G;
    sm.a[r] = a_rows ? min(a_rows[i], s_extent) : 0;
    sm.lo[r] = lo_rows ? lo_rows[i] : 0;
    sm.hi[r] = min(hi_rows[i], s_extent);
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.f;
  }
  row_bounds(sm, M);

  float acc[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) acc[i] = 0.f;
  const int64_t row_stride = (int64_t)Hkv * D;
  const T* kb = k_layer + (int64_t)b * S * row_stride + h * D;
  const T* vb = v_layer + (int64_t)b * S * row_stride + h * D;
  const T* ks = ksink ? ksink + (int64_t)b * n_sink * row_stride + h * D : nullptr;
  const int* cm = cm_layer ? cm_layer + (int64_t)b * S : nullptr;
  const int start = sp * SPLIT;
  attend_range<T, D, MR>(kb, vb, ks, n_sink, cm, row_stride, start,
                         min(start + SPLIT, s_extent), M, scale, sm, acc);

  const int64_t base = (((int64_t)b * Hkv + h) * nsplit + sp) * M;
  const int d = threadIdx.x % D, rg = threadIdx.x / D;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = rg + NGRP * i;
    if (r < M) part_acc[(base + r) * D + d] = acc[i];
  }
  for (int r = threadIdx.x; r < M; r += NT) {
    part_ml[(base + r) * 2] = sm.m[r];
    part_ml[(base + r) * 2 + 1] = sm.l[r];
  }
}

// grid (M, Hkv, B), D threads: merge the splits of one query row in order.
// out_m / out_l [B, T, Hq] (both null, or both set: the return_lse form)
// take the row's merged softmax state: m the max of the scaled logits, l the
// sum of exp(s - m); an empty row gives m = NEG_INF, l = 0 and out = 0.
template <typename T, int D>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out, float* __restrict__ out_m,
                                    float* __restrict__ out_l, int T_, int Hq,
                                    int Hkv, int nsplit) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int M = gridDim.x, G = Hq / Hkv;
  float m = NEG_INF, l = 0.f, a = 0.f;
  bool any = false;
  for (int sp = 0; sp < nsplit; ++sp) {
    const int64_t row = (((int64_t)b * Hkv + h) * nsplit + sp) * M + r;
    const float l_i = part_ml[row * 2 + 1];
    if (l_i == 0.f) continue;  // empty split: identity
    const float m_i = part_ml[row * 2], a_i = part_acc[row * D + d];
    if (!any) {
      m = m_i; l = l_i; a = a_i; any = true;
    } else {
      const float mn = fmaxf(m, m_i);
      const float ca = expf(m - mn), cb = expf(m_i - mn);
      a = a * ca + a_i * cb;
      l = l * ca + l_i * cb;
      m = mn;
    }
  }
  const int t = r / G, g = r % G;
  const int64_t row = ((int64_t)b * T_ + t) * Hq + h * G + g;
  out[row * D + d] = from_f32<T>(any ? a / l : 0.f);
  if (out_m && d == 0) {
    out_m[row] = m;
    out_l[row] = l;
  }
}

// The bounds, the sink rows and the column bits of one call.
struct Rows {
  const int* a;
  const int* lo;
  const int* hi;
  const void* ksink;
  int n_sink;
  const int* colmask;  // [L, B, 1, S] or null
};

template <typename T, int MR>
int launch_decode(const void* q, const void* k, const void* v, Rows rows,
                  void* out, float* out_m, float* out_l, float* part_acc,
                  float* part_ml, int layer, int B,
                  int T_, int Hq, int Hkv, int S, int s_extent, cudaStream_t stream) {
  constexpr int D = 64;
  const size_t smem = Smem<D>::bytes(2 * MR);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, D, MR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nsplit = (s_extent + SPLIT - 1) / SPLIT;
  const int64_t layer_off = (int64_t)layer * B * S * Hkv * D;
  const int* cm_layer = rows.colmask ? rows.colmask + (int64_t)layer * B * S : nullptr;
  const float scale = 1.0f / sqrtf((float)D);
  decode_split_kernel<T, D, MR><<<dim3(nsplit, Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k) + layer_off,
      static_cast<const T*>(v) + layer_off, rows.a, rows.lo, rows.hi,
      static_cast<const T*>(rows.ksink), rows.n_sink, cm_layer, part_acc, part_ml,
      T_, Hq, Hkv, S, s_extent, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int M = T_ * (Hq / Hkv);
  decode_merge_kernel<T, D><<<dim3(M, Hkv, B), D, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), out_m, out_l, T_, Hq, Hkv, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const void* q, const void* k, const void* v, Rows rows,
                  void* out, float* out_m, float* out_l, float* part_acc,
                  float* part_ml, int layer, int B,
                  int T_, int Hq, int Hkv, int S, int s_extent, cudaStream_t stream) {
  const int rows_per_group = (T_ * (Hq / Hkv) + NGRP - 1) / NGRP;
#define MDT_LAUNCH(MR)                                                            \
  return launch_decode<T, MR>(q, k, v, rows, out, out_m, out_l, part_acc,        \
                              part_ml, layer, B, T_, Hq, Hkv, S, s_extent, stream)
  if (rows_per_group <= 2) MDT_LAUNCH(2);
  if (rows_per_group <= 4) MDT_LAUNCH(4);
  if (rows_per_group <= 8) MDT_LAUNCH(8);
  if (rows_per_group <= 16) MDT_LAUNCH(16);
  if (rows_per_group <= 32) MDT_LAUNCH(32);
#undef MDT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Shapes: q and out
// [B, T, Hq, 64]; k, v [L, B, S, Hkv*64]; a, lo, hi [B, T] int32 (a and lo
// may be null: 0); ksink [B, n_sink, Hkv*64] or null with n_sink = 0;
// colmask [L, B, 1, S] int32 (slot col of sequence b attended only where
// colmask[layer, b, 0, col] != 0) or null; out_m, out_l [B, T, Hq] f32 (the
// return_lse form: each row's merged m and l) or both null;
// part_acc [B, Hkv, nsplit, T*Hq/Hkv, 64] and part_ml [.., 2] f32 scratch
// with nsplit = ceil(s_extent / 512). Returns the CUDA error code (0 =
// success).
extern "C" int mdt_split_slots() { return mdt::SPLIT; }

extern "C" int mdt_flash_decode(int dtype, const void* q, const void* k,
                                const void* v, const int* a, const int* lo,
                                const int* hi, const void* ksink, int n_sink,
                                const int* colmask, void* out, float* out_m,
                                float* out_l, float* part_acc, float* part_ml,
                                int layer, int B, int T, int Hq, int Hkv, int S,
                                int s_extent, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mdt::Rows rows{a, lo, hi, ksink, n_sink, colmask};
  if (dtype == 0)
    return mdt::dispatch_rows<float>(q, k, v, rows, out, out_m, out_l, part_acc,
                                     part_ml, layer, B, T, Hq, Hkv, S, s_extent, st);
  if (dtype == 1)
    return mdt::dispatch_rows<__nv_bfloat16>(q, k, v, rows, out, out_m, out_l,
                                             part_acc, part_ml, layer, B, T, Hq, Hkv,
                                             S, s_extent, st);
  return (int)cudaErrorInvalidValue;
}
