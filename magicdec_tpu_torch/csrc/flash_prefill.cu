// flash_prefill for Hopper (sm_90a): causal attention of a prefill chunk
// (T = 128 tokens) over the stacked packed cache [L, B, S, Hkv*D], D in
// {64, 128}, bounded by a static power-of-2 s_cap.
//
// Replaces magicdec_tpu/ops/pallas/flash_decode.py flash_prefill
// (pallas_call at :646). Bound on the H100: at a 128-token chunk each K/V
// byte feeds 2*T*G*D FLOPs per slot and head against 2*D*itemsize bytes, so
// late chunks (thousands of slots) are bound by FLOPs and early ones by
// neither (launch-sized). Design: tiles are triaged as the TPU kernel's
// blocks were: tiles past the CTA's causal frontier (and s_cap) are neither
// loaded nor computed, tiles below every row's bound run without a mask,
// only the diagonal tiles are masked.
//  * bf16 (every engine's cache): one CTA per (128-row query tile, KV head,
//    b), the rows being 32 consecutive tokens x G query heads of one KV
//    head, so each K/V tile in shared memory serves 128 rows. Eight warps,
//    16 rows each, on the tensor cores (mma.sync m16n8k16, f32 accumulate;
//    flash_common.cuh warp_tile: K by ldmatrix, V by ldmatrix.trans, P in
//    registers between the two products). K and V tiles stream through a
//    STAGES-deep cp.async ring of bf16 stages, one barrier a tile, so the
//    copies of the next STAGES - 1 tiles are in flight while one is
//    computed; Q passes through the last stage into registers before the
//    ring starts. A warp skips a tile past all of its own rows' bounds (an
//    exact identity: every slot is masked for it).
//  * float32: the CUDA-core tile step of flash_common.cuh (exact f32
//    products, as the tests want), 64 rows a CTA, 2*D threads.
#include "flash_common.cuh"
#include "tma.cuh"

namespace mdt {

constexpr int QROWS = 64;   // query rows per f32 CTA
constexpr int PQ = 128;     // query rows per bf16 CTA
constexpr int PRE_NT = 256; // threads of a bf16 CTA: 8 warps x 16 rows
static_assert(PQ <= 2 * TILE, "Q is staged through one ring stage");

// The bf16 kernel's shape per head_dim, so that two CTAs (16 warps) fit an
// SM in registers (<= 128 a thread) and shared memory: at D = 64 Q lives in
// registers and the ring has STAGES stages; at D = 128 Q stays in shared
// memory (its A fragments re-read at every tile) and the ring has 2.
template <int D>
struct PrefillCfg {
  static constexpr bool QS = D > 64;
  static constexpr int RING = QS ? 2 : STAGES;
  // the ring, Q's own region when QS, the row bounds and their min / max
  static constexpr size_t smem() {
    return sizeof(bf16) * (RING * stage_elems<D>() + (QS ? PQ * pitch<D>() : 0)) +
           sizeof(int) * (PQ + 2);
  }
};

// ---- float32: CUDA cores --------------------------------------------------

// grid (ceil(T*G / QROWS), Hkv, B), F32<D>::NT threads
template <int D>
__global__ void __launch_bounds__(F32<D>::NT)
prefill_kernel(const float* __restrict__ q, const float* __restrict__ k_layer,
               const float* __restrict__ v_layer, const int* __restrict__ valid,
               float* __restrict__ out, int T_, int Hq, int Hkv, int S, int s_extent,
               float scale) {
  constexpr int NT = F32<D>::NT, NGRP_V = F32<D>::NGRP_V, PMR = QROWS / NGRP_V;
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
      x = q[(((int64_t)b * T_ + t) * Hq + h * G + g) * D + d];
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
  const float* kb = k_layer + (int64_t)b * S * row_stride + h * D;
  const float* vb = v_layer + (int64_t)b * S * row_stride + h * D;
  attend_range<float, D, PMR>(kb, vb, nullptr, 0, nullptr, row_stride, 0, s_extent, M,
                              scale, sm, acc);

  const int d = threadIdx.x % D, rg = threadIdx.x / D;
#pragma unroll
  for (int i = 0; i < PMR; ++i) {
    const int r = rg + NGRP_V * i;
    if (r < M) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      const float l = sm.l[r];
      out[(((int64_t)b * T_ + t) * Hq + h * G + g) * D + d] = l > 0.f ? acc[i] / l : 0.f;
    }
  }
}

// ---- bfloat16: tensor cores, cp.async ring --------------------------------

// grid (ceil(T*G / PQ), Hkv, B), PRE_NT threads; warp w owns rows
// 16w..16w+15 of the CTA's PQ. fault = 1 plants a pipeline fault for the
// card checks: the last tile is copied but not computed.
template <int D>
__global__ void __launch_bounds__(PRE_NT, 2)
prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_layer,
                   const bf16* __restrict__ v_layer, const int* __restrict__ valid,
                   bf16* __restrict__ out, int T_, int Hq, int Hkv, int S, int s_extent,
                   float scale, int fault) {
  constexpr int P = pitch<D>(), CPR = D / 8;
  constexpr bool QS = PrefillCfg<D>::QS;
  constexpr int RING = PrefillCfg<D>::RING;
  extern __shared__ float4 smem_raw[];  // the f32 kernels' declaration too
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  // Q: its own region (QS), or the last ring stage until the loop's first issue
  bf16* sQ = ring + (RING - (QS ? 0 : 1)) * stage_elems<D>();
  int* sHi = reinterpret_cast<int*>(sQ + (QS ? PQ * P : stage_elems<D>()));  // [PQ]
  int* sLim = sHi + PQ;                                                     // min, max
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int r0 = qt * PQ;
  const int M = min(PQ, T_ * G - r0);

  // 1. Q rows into shared memory
  for (int idx = tid; idx < PQ * CPR; idx += PRE_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < M) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      val = *reinterpret_cast<const uint4*>(q + (((int64_t)b * T_ + t) * Hq + h * G + g) * D + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * P + c) = val;
  }
  for (int r = tid; r < PQ; r += PRE_NT)
    sHi[r] = r < M ? min(valid[b * T_ + (r0 + r) / G], s_extent) : 0;
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff, hi = 0;
    for (int r = 0; r < M; ++r) {
      lo = min(lo, sHi[r]);
      hi = max(hi, sHi[r]);
    }
    sLim[0] = lo;
    sLim[1] = hi;
  }
  __syncthreads();
  const int hi_min = sLim[0], limit = min(s_extent, sLim[1]);
  const int n = (limit + TILE - 1) / TILE;

  const int64_t row_stride = (int64_t)Hkv * D;
  const bf16* kb = k_layer + (int64_t)b * S * row_stride + h * D;
  const bf16* vb = v_layer + (int64_t)b * S * row_stride + h * D;

  // 2. the ring's prologue
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < n)
      load_tile<D, PRE_NT>(ring + i * stage_elems<D>(), kb, vb, kb, 0, row_stride,
                           i * TILE, min(TILE, limit - i * TILE));
    cp_async_commit();
  }

  // 3. this warp's Q fragments, row bounds and largest bound
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2;
  WarpState<D, QS> ws;
  ws.init(sQ, warp);
  const int ra = warp * 16 + g, rb = ra + 8;
  const RowPair rp{0, 0, sHi[ra], 0, 0, sHi[rb]};
  int warp_hi = max(rp.hiA, rp.hiB);
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
    warp_hi = max(warp_hi, __shfl_xor_sync(0xffffffffu, warp_hi, off));

  // 4. the tiles: wait for tile i, refill the stage tile i-1 used, compute i
  for (int i = 0; i < n; ++i) {
    cp_async_wait<RING - 2>();
    __syncthreads();
    const int nx = i + RING - 1;
    if (nx < n)
      load_tile<D, PRE_NT>(ring + (nx % RING) * stage_elems<D>(), kb, vb, kb, 0,
                           row_stride, nx * TILE, min(TILE, limit - nx * TILE));
    cp_async_commit();
    const int t0 = i * TILE;
    if (t0 >= warp_hi || (fault == 1 && i == n - 1)) continue;
    const bf16* st = ring + (i % RING) * stage_elems<D>();
    warp_tile(ws, st, st + TILE * P, t0, t0 + TILE <= hi_min, rp, false, ~0ull, scale);
  }
  cp_async_wait<0>();

  // 5. normalise and write the warp's rows
  ws.reduce_l();
  const int c = lane & 3;
  const float inA = ws.lA > 0.f ? 1.f / ws.lA : 0.f, inB = ws.lB > 0.f ? 1.f / ws.lB : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= M) continue;
    const float inv = half ? inB : inA;
    const int t = (r0 + r) / G, gq = (r0 + r) % G;
    bf16* dst = out + (((int64_t)b * T_ + t) * Hq + h * G + gq) * D + 2 * c;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(ws.o[nt][2 * half] * inv, ws.o[nt][2 * half + 1] * inv);
  }
}

// ---- launchers ------------------------------------------------------------

template <int D>
int launch_prefill_f32(const void* q, const void* k, const void* v, const int* valid,
                       void* out, int layer, int B, int T_, int Hq, int Hkv, int S,
                       int s_extent, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes(QROWS);
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)prefill_kernel<D>, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (T_ * (Hq / Hkv) + QROWS - 1) / QROWS;
  const int64_t layer_off = (int64_t)layer * B * S * Hkv * D;
  prefill_kernel<D><<<dim3(n_qt, Hkv, B), F32<D>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k) + layer_off,
      static_cast<const float*>(v) + layer_off, valid, static_cast<float*>(out), T_, Hq,
      Hkv, S, s_extent, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_prefill_mma(const void* q, const void* k, const void* v, const int* valid,
                       void* out, int layer, int B, int T_, int Hq, int Hkv, int S,
                       int s_extent, int fault, cudaStream_t stream) {
  constexpr size_t smem = PrefillCfg<D>::smem();
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)prefill_mma_kernel<D>, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (T_ * (Hq / Hkv) + PQ - 1) / PQ;
  const int64_t layer_off = (int64_t)layer * B * S * Hkv * D;
  prefill_mma_kernel<D><<<dim3(n_qt, Hkv, B), PRE_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k) + layer_off,
      static_cast<const bf16*>(v) + layer_off, valid, static_cast<bf16*>(out), T_, Hq, Hkv,
      S, s_extent, 1.0f / sqrtf((float)D), fault);
  return (int)cudaGetLastError();
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16; D: head_dim, 64
// or 128. Shapes: q and out [B, T, Hq, D]; k, v [L, B, S, Hkv*D]; valid
// [B, T] int32 causal bounds, slots < min(valid, s_extent) attended. fault:
// 0, or 1 (bf16 only) to plant the skipped-last-tile fault of the card
// checks. Returns the CUDA error code.
extern "C" int mdt_flash_prefill(int dtype, int D, const void* q, const void* k,
                                 const void* v, const int* valid, void* out, int layer,
                                 int B, int T, int Hq, int Hkv, int S, int s_extent,
                                 int fault, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MDT_ARGS q, k, v, valid, out, layer, B, T, Hq, Hkv, S, s_extent
  if (dtype == 0 && fault == 0) {
    if (D == 64) return mdt::launch_prefill_f32<64>(MDT_ARGS, st);
    if (D == 128) return mdt::launch_prefill_f32<128>(MDT_ARGS, st);
  }
  if (dtype == 1) {
    if (D == 64) return mdt::launch_prefill_mma<64>(MDT_ARGS, fault, st);
    if (D == 128) return mdt::launch_prefill_mma<128>(MDT_ARGS, fault, st);
  }
#undef MDT_ARGS
  return (int)cudaErrorInvalidValue;
}
