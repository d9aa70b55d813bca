// flash_prefill for Hopper (sm_90a): causal attention of a prefill chunk
// (T = 128 tokens) over the stacked packed cache [L, B, S, Hkv*D], bounded by
// a static power-of-2 s_cap.
//
// Replaces magicdec_tpu/ops/pallas/flash_decode.py flash_prefill
// (pallas_call at :646). Bound on the H100: at a 128-token chunk each K/V
// byte feeds 2*T*G*D FLOPs per slot and head against 2*D*itemsize bytes, so
// late chunks (thousands of slots) are bound by FLOPs and early ones by
// neither (launch-sized). Design: one CTA per (64-row query tile, KV head,
// b), the rows being 16 consecutive tokens x G query heads of one KV head,
// so each K/V tile loaded into shared memory serves 64 rows. Tiles are
// triaged as the TPU kernel's blocks were: tiles past the CTA's causal
// frontier (and s_cap) are neither loaded nor computed, tiles below every
// row's bound run without a mask, only the diagonal tiles are masked.
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulate; each
// warp owns 16 query rows, FlashAttention-2 style: P stays in registers
// between the two products). f32 runs the CUDA-core tile step of
// flash_common.cuh (exact f32 products, as the tests want). Both are simple
// first versions: no cp.async/TMA pipelining, no wgmma.
#include "flash_common.cuh"

namespace mdt {

constexpr int QROWS = 64;  // query rows per CTA
constexpr int PMR = QROWS / NGRP;

// grid (ceil(T*G / QROWS), Hkv, B)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_layer,
               const T* __restrict__ v_layer, const int* __restrict__ valid,
               T* __restrict__ out, int T_, int Hq, int Hkv, int S, int s_extent,
               float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int r0 = qt * QROWS;
  const int M = min(QROWS, T_ * G - r0);
  Smem<D> sm(QROWS);

  for (int idx = threadIdx.x; idx < QROWS * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < M) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      x = to_f32(q[(((int64_t)b * T_ + t) * Hq + h * G + g) * D + d]);
    }
    sm.q[idx] = x;
  }
  for (int r = threadIdx.x; r < M; r += NT) {
    sm.a[r] = 0;
    sm.lo[r] = 0;
    sm.hi[r] = min(valid[b * T_ + (r0 + r) / G], s_extent);
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.f;
  }
  row_bounds(sm, M);

  float acc[PMR];
#pragma unroll
  for (int i = 0; i < PMR; ++i) acc[i] = 0.f;
  const int64_t row_stride = (int64_t)Hkv * D;
  const T* kb = k_layer + (int64_t)b * S * row_stride + h * D;
  const T* vb = v_layer + (int64_t)b * S * row_stride + h * D;
  attend_range<T, D, PMR>(kb, vb, nullptr, 0, nullptr, row_stride, 0, s_extent, M,
                          scale, sm, acc);

  const int d = threadIdx.x % D, rg = threadIdx.x / D;
#pragma unroll
  for (int i = 0; i < PMR; ++i) {
    const int r = rg + NGRP * i;
    if (r < M) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      const float l = sm.l[r];
      out[(((int64_t)b * T_ + t) * Hq + h * G + g) * D + d] =
          from_f32<T>(l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

// ---- bf16 on the tensor cores -------------------------------------------
constexpr int PITCH = 72;  // bf16 per shared row: 64 + 8, conflict-free fragments

// grid (ceil(T*G / QROWS), Hkv, B), 4 warps; warp w owns rows 16w..16w+15.
// Fragment layouts (PTX m16n8k16): lane = 4*g + c; A holds rows g, g+8 and
// k 2c, 2c+1 (+8); B holds k 2c, 2c+1 (+8) of column g; C rows g, g+8, cols
// 2c, 2c+1.
__global__ void __launch_bounds__(NT)
prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_layer,
                   const __nv_bfloat16* __restrict__ v_layer,
                   const int* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                   int T_, int Hq, int Hkv, int S, int s_extent, float scale) {
  constexpr int D = 64;
  __shared__ __align__(16) __nv_bfloat16 sQ[QROWS * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sK[TILE * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[TILE * PITCH];
  __shared__ int sHi[QROWS];
  __shared__ int sHiMin, sHiMax;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int r0 = qt * QROWS;
  const int M = min(QROWS, T_ * G - r0);

  for (int idx = tid; idx < QROWS * (D / 8); idx += NT) {
    const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < M) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      val = *reinterpret_cast<const uint4*>(
          q + (((int64_t)b * T_ + t) * Hq + h * G + g) * D + c8);
    }
    *reinterpret_cast<uint4*>(sQ + r * PITCH + c8) = val;
  }
  for (int r = tid; r < QROWS; r += NT)
    sHi[r] = r < M ? min(valid[b * T_ + (r0 + r) / G], s_extent) : 0;
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff, hi = 0;
    for (int r = 0; r < M; ++r) {
      lo = min(lo, sHi[r]);
      hi = max(hi, sHi[r]);
    }
    sHiMin = lo;
    sHiMax = hi;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int ra = warp * 16 + g, rb = ra + 8;
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const __nv_bfloat16* base = sQ + ra * PITCH + ks * 16 + 2 * c;
    qa[ks][0] = ld32(base);
    qa[ks][1] = ld32(base + 8 * PITCH);
    qa[ks][2] = ld32(base + 8);
    qa[ks][3] = ld32(base + 8 * PITCH + 8);
  }
  const int hiA = sHi[ra], hiB = sHi[rb];
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;

  const int64_t row_stride = (int64_t)Hkv * D;
  const __nv_bfloat16* kb = k_layer + (int64_t)b * S * row_stride + h * D;
  const __nv_bfloat16* vb = v_layer + (int64_t)b * S * row_stride + h * D;
  const int limit = min(s_extent, sHiMax), hi_min = sHiMin;
  const unsigned short* v16 = reinterpret_cast<const unsigned short*>(sV);

  for (int t0 = 0; t0 < limit; t0 += TILE) {
    const int n_load = min(TILE, limit - t0);
    const bool full = t0 + TILE <= hi_min;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TILE * (D / 8); idx += NT) {
      const int slot = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (slot < n_load) {
        const int64_t off = (int64_t)(t0 + slot) * row_stride + c8;
        kv = *reinterpret_cast<const uint4*>(kb + off);
        vv = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(sK + slot * PITCH + c8) = kv;
      *reinterpret_cast<uint4*>(sV + slot * PITCH + c8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 slots
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * PITCH + 2 * c;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_bf16(s[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }
    // mask, row max over the quad of lanes sharing a row
    float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t0 + nt * 8 + 2 * c + e;
        s[nt][e] = (full || col < hiA) ? s[nt][e] * scale : NEG_INF;
        s[nt][2 + e] = (full || col < hiB) ? s[nt][2 + e] * scale : NEG_INF;
        mxA = fmaxf(mxA, s[nt][e]);
        mxB = fmaxf(mxB, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    const float alA = expf(mA - mnA), alB = expf(mB - mnB);
    mA = mnA;
    mB = mnB;
    lA *= alA;
    lB *= alB;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= alA;
      o[nt][1] *= alA;
      o[nt][2] *= alB;
      o[nt][3] *= alB;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t0 + nt * 8 + 2 * c + e;
        const float pa = (full || col < hiA) ? expf(s[nt][e] - mA) : 0.f;
        const float pb = (full || col < hiB) ? expf(s[nt][2 + e] - mB) : 0.f;
        lA += pa;
        lB += pb;
        s[nt][e] = pa;
        s[nt][2 + e] = pb;
      }
    }
    // O += P V: P (rounded to bf16) is the A operand straight from registers
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const int k0 = ks * 16 + 2 * c;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + g;
        const uint32_t b0 = (uint32_t)v16[k0 * PITCH + n] |
                            ((uint32_t)v16[(k0 + 1) * PITCH + n] << 16);
        const uint32_t b1 = (uint32_t)v16[(k0 + 8) * PITCH + n] |
                            ((uint32_t)v16[(k0 + 9) * PITCH + n] << 16);
        mma_bf16(o[nt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float inA = lA > 0.f ? 1.f / lA : 0.f, inB = lB > 0.f ? 1.f / lB : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= M) continue;
    const float inv = half ? inB : inA;
    const int t = (r0 + r) / G, gq = (r0 + r) % G;
    __nv_bfloat16* dst = out + (((int64_t)b * T_ + t) * Hq + h * G + gq) * D + 2 * c;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(o[nt][2 * half] * inv, o[nt][2 * half + 1] * inv);
  }
}

template <typename T>
int launch_prefill(const void* q, const void* k, const void* v, const int* valid,
                   void* out, int layer, int B, int T_, int Hq, int Hkv, int S,
                   int s_extent, cudaStream_t stream) {
  constexpr int D = 64;
  const size_t smem = Smem<D>::bytes(QROWS);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(prefill_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_qt = (T_ * (Hq / Hkv) + QROWS - 1) / QROWS;
  const int64_t layer_off = (int64_t)layer * B * S * Hkv * D;
  const float scale = 1.0f / sqrtf((float)D);
  prefill_kernel<T, D><<<dim3(n_qt, Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k) + layer_off,
      static_cast<const T*>(v) + layer_off, valid, static_cast<T*>(out), T_, Hq, Hkv,
      S, s_extent, scale);
  return (int)cudaGetLastError();
}

int launch_prefill_mma(const void* q, const void* k, const void* v, const int* valid,
                       void* out, int layer, int B, int T_, int Hq, int Hkv, int S,
                       int s_extent, cudaStream_t stream) {
  constexpr int D = 64;
  const int n_qt = (T_ * (Hq / Hkv) + QROWS - 1) / QROWS;
  const int64_t layer_off = (int64_t)layer * B * S * Hkv * D;
  const float scale = 1.0f / sqrtf((float)D);
  prefill_mma_kernel<<<dim3(n_qt, Hkv, B), NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k) + layer_off,
      static_cast<const __nv_bfloat16*>(v) + layer_off, valid,
      static_cast<__nv_bfloat16*>(out), T_, Hq, Hkv, S, s_extent, scale);
  return (int)cudaGetLastError();
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Shapes: q and out
// [B, T, Hq, 64]; k, v [L, B, S, Hkv*64]; valid [B, T] int32 causal bounds,
// slots < min(valid, s_extent) attended. Returns the CUDA error code.
extern "C" int mdt_flash_prefill(int dtype, const void* q, const void* k, const void* v,
                                 const int* valid, void* out, int layer, int B, int T,
                                 int Hq, int Hkv, int S, int s_extent, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mdt::launch_prefill<float>(q, k, v, valid, out, layer, B, T, Hq, Hkv, S,
                                      s_extent, st);
  if (dtype == 1)
    return mdt::launch_prefill_mma(q, k, v, valid, out, layer, B, T, Hq, Hkv, S,
                                   s_extent, st);
  return (int)cudaErrorInvalidValue;
}
