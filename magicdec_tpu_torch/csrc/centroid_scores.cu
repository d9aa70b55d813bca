// Centroid scores for Hopper (sm_90a): for each (sequence b, KV head h),
// the softmax over the C centroids of q . centroid * D^-1/2 of each of the
// T*G query rows that share head h, summed over those rows:
//   out[b, h, c] = sum_r softmax_c(q[b, r] . cent[b, h, c] * D^-1/2)
// with q [B, T, Hq, D] (float32 or bfloat16, read as float32), centroids
// [B, Hkv, C, D] float32 given by strides, out [B, Hkv, C] float32.
//
// Replaces magicdec_tpu/ops/pallas/gemm_softmax.py centroid_scores
// (pallas_call at :50), which the RetroInfer draft runs once per layer at
// the start of each round to rank the clusters. The TPU kernel pads the T*G
// rows to 8 sublanes and subtracts the pad rows' uniform mass; here the rows
// are not padded. Bound on the H100: at the main path's shapes (B=8, Hkv=8,
// G=4, D=64, C=130) the work is ~2.2 MB (mostly the float32 centroids) and
// ~4.3 MFLOP, so the bound is under a microsecond and the launch itself
// dominates.
// Design (simple and correct first):
//  * one CTA per (h, b); the T*G query rows go to shared memory as float32;
//  * the centroids are staged into shared memory in tiles of up to 16384
//    floats, every thread keeping 16 independent loads in flight, rows
//    padded to D + 1 floats so that a warp reading 32 rows at one column
//    hits 32 banks;
//  * one thread per logit (query row, centroid): a loop over D, unrolled
//    (D is a template parameter: 64 or 128), with the query row broadcast
//    across the warp, the scaled logits written to shared memory [T*G, C].
//    With 64 CTAs on 132 SMs each CTA's instruction stream sets the pace:
//    a warp per centroid (dependent loads, shuffle reductions) or a runtime
//    D (divisions, an unpipelined loop) ran 2-3x slower on an H100
//    (PERF.md);
//  * one warp per row for the max / sum of the softmax over C (C need not be
//    a multiple of 32; 130 on the main path);
//  * one thread per centroid sums its probabilities over the rows;
//  * the centroids are read through strides, so the port's [L, B, C, Hkv*D]
//    layout is read in place (no transposed copy per round and layer).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <cmath>

namespace mdt {

constexpr int CS_THREADS = 512;
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr int CS_TILE_FLOATS = 16384;   // centroid floats staged per pass
constexpr int CS_LOADS = 16;            // loads in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (Hkv, B); dynamic shared memory: q rows [M, D], a centroid tile
// [tile, D + 1], logits [M, C], row max and 1/sum [M] each (M = T*G).
template <typename QT, int D>
__global__ void __launch_bounds__(CS_THREADS)
centroid_scores_kernel(const QT* __restrict__ q, const float* __restrict__ cent,
                       float* __restrict__ out, int T, int G, int C,
                       int64_t q_b, int64_t q_t, int64_t q_h, int64_t c_b,
                       int64_t c_h, int64_t c_c, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int M = T * G;
  const int tile = min(C, CS_TILE_FLOATS / (D + 1));
  float* qs = smem;                 // [M, D]
  float* ct = qs + M * D;           // [tile, D + 1]
  float* s = ct + tile * (D + 1);   // [M, C]
  float* row_m = s + M * C;         // [M]
  float* row_inv = row_m + M;       // [M]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // query row r = t * G + g is q[b, t, h * G + g, :]
  for (int i = threadIdx.x; i < M * D; i += CS_THREADS) {
    const int r = i / D, d = i % D;
    const int t = r / G, g = r % G;
    qs[i] = to_f32(q[b * q_b + t * q_t + (int64_t)(h * G + g) * q_h + d]);
  }
  __syncthreads();

  const float* cent_bh = cent + b * c_b + h * c_h;
  for (int c0 = 0; c0 < C; c0 += tile) {
    const int n = min(tile, C - c0) * D;
    for (int i0 = threadIdx.x; i0 < n; i0 += CS_LOADS * CS_THREADS) {
      float v[CS_LOADS];
#pragma unroll
      for (int u = 0; u < CS_LOADS; ++u) {
        const int i = i0 + u * CS_THREADS;
        v[u] = i < n ? cent_bh[(c0 + i / D) * c_c + i % D] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < CS_LOADS; ++u) {
        const int i = i0 + u * CS_THREADS;
        if (i < n) ct[(i / D) * (D + 1) + i % D] = v[u];
      }
    }
    __syncthreads();
    const int nc = n / D;
    for (int e = threadIdx.x; e < M * nc; e += CS_THREADS) {
      const int r = e / nc, c = e % nc;
      const float* qr = qs + r * D;
      const float* cr = ct + c * (D + 1);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc += qr[d] * cr[d];
      s[r * C + c0 + c] = acc * scale;
    }
    __syncthreads();
  }

  for (int r = warp; r < M; r += CS_WARPS) {
    const float* sr = s + r * C;
    float m = -FLT_MAX;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, sr[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < C; c += 32) l += expf(sr[c] - m);
    l = warp_sum(l);
    if (lane == 0) {
      row_m[r] = m;
      row_inv[r] = 1.f / l;
    }
  }
  __syncthreads();

  float* out_bh = out + ((int64_t)b * gridDim.x + h) * C;
  for (int c = threadIdx.x; c < C; c += CS_THREADS) {
    float acc = 0.f;
    for (int r = 0; r < M; ++r) acc += expf(s[r * C + c] - row_m[r]) * row_inv[r];
    out_bh[c] = acc;
  }
}

template <typename QT, int D>
int launch(const void* q, const float* cent, float* out, int B, int T, int Hq,
           int Hkv, int C, long long q_b, long long q_t, long long q_h,
           long long c_b, long long c_h, long long c_c, cudaStream_t stream) {
  const int G = Hq / Hkv, M = T * G;
  const int tile = C < CS_TILE_FLOATS / (D + 1) ? C : CS_TILE_FLOATS / (D + 1);
  const size_t smem = sizeof(float) * ((size_t)M * D + (size_t)tile * (D + 1) +
                                       (size_t)M * C + 2 * (size_t)M);
  auto kernel = centroid_scores_kernel<QT, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  centroid_scores_kernel<QT, D><<<dim3(Hkv, B), CS_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), cent, out, T, G, C, q_b, q_t, q_h, c_b, c_h,
      c_c, (float)(1.0 / std::sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_d(const void* q, const float* cent, float* out, int B, int T,
             int Hq, int Hkv, int D, int C, long long q_b, long long q_t,
             long long q_h, long long c_b, long long c_h, long long c_c,
             cudaStream_t stream) {
  if (D == 64)
    return launch<QT, 64>(q, cent, out, B, T, Hq, Hkv, C, q_b, q_t, q_h, c_b,
                          c_h, c_c, stream);
  if (D == 128)
    return launch<QT, 128>(q, cent, out, B, T, Hq, Hkv, C, q_b, q_t, q_h, c_b,
                           c_h, c_c, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32 q, 1 = bfloat16 q. Strides are in
// elements; the D axis of q and of the centroids is contiguous. D is 64 or
// 128; Hq is a multiple of Hkv. Returns the CUDA error code (0 = success).
extern "C" int mdt_centroid_scores(int dtype, const void* q, const float* cent,
                                   float* out, int B, int T, int Hq, int Hkv,
                                   int D, int C, long long q_b, long long q_t,
                                   long long q_h, long long c_b, long long c_h,
                                   long long c_c, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || C <= 0 || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mdt::launch_d<float>(q, cent, out, B, T, Hq, Hkv, D, C, q_b, q_t,
                                q_h, c_b, c_h, c_c, s);
  if (dtype == 1)
    return mdt::launch_d<__nv_bfloat16>(q, cent, out, B, T, Hq, Hkv, D, C, q_b,
                                        q_t, q_h, c_b, c_h, c_c, s);
  return (int)cudaErrorInvalidValue;
}
