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
// are not padded. Bound on the H100 by the float32 centroids' bytes: at the
// main path's shapes (B=8, Hkv=8, G=4, D=64, C=130) ~2.2 MB, under a
// microsecond, so the launch itself dominates; C = max_len / 32 grows with
// the context (1024 at P=32768: 16.8 MB, ~5 us).
//
// Design: C is split over a thread-block cluster. Grid (S, Hkv, B), clusters
// of (S, 1, 1); the wrapper's plan (ops/gemm_softmax.py `scores_plan`, from C
// and D alone) gives S <= 8 and each CTA's chunk of centroids. One CTA per
// (h, b) staged and scored all C alone, so its time grew linearly with C
// (64 CTAs on 132 SMs: 0.0339 ms at C=1024 on an H100, PERF.md). A CTA is
// 128 threads, so that every cluster of a call is resident at once (with
// 512-thread CTAs the clusters of C=1024 ran in two waves, the last CTAs
// starting ~16 us after the first: a probe of per-CTA %globaltimer stamps,
// PERF.md). CTA s:
//  * stages its chunk's centroids in tiles of up to 128 x 132 floats by
//    cp.async, 16 bytes a copy and every copy of a tile in flight at once,
//    rows padded to D + 4 floats; the centroids are read through strides,
//    so the port's [L, B, C, Hkv*D] layout is read in place (no transposed
//    copy per round and layer). The T*G query rows are staged (as float32,
//    transposed: qT[d][r]) while the first tile's copies are in flight;
//  * one thread per (centroid, 4 query rows): a loop over D, unrolled (D is
//    a template parameter: 64 or 128), 4 centroid values a 16-byte read,
//    each used for the 4 rows, the rows' values in one 16-byte broadcast
//    read (one thread per logit read shared memory twice a multiply-add, and
//    that bound the kernel at large C). A warp per centroid (dependent loads,
//    shuffle reductions) or a runtime D (divisions, an unpipelined loop) ran
//    2-3x slower on an H100 (PERF.md);
//  * one warp per row for the chunk's (max, sum of exp) of each row;
//  * after a cluster barrier, reads every rank's (m, l) in rank order
//    through distributed shared memory and forms the row's (m, l) over all
//    C: m = max_s m_s, l = sum_s l_s exp(m_s - m); it arrives on the next
//    cluster barrier at once and waits on it only before it exits (a
//    cluster of one CTA skips both cluster barriers);
//  * one thread per centroid of its chunk sums its probabilities over the
//    rows, in row order.
// Nothing of the launch depends on B, Hkv or T, and a (b, h)'s cluster
// never reads another's data, so a head's scores have the same bits in a
// call on a shard of the heads (centroid_scores_sharded) as in the whole.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <cmath>

#include "mma.cuh"
#include "tma.cuh"

namespace mdt {

constexpr int CS_THREADS = 128;
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr int CS_TILE_FLOATS = 128 * 132;  // centroid floats staged per pass
constexpr int CS_MAX_SPLITS = 8;           // the portable cluster size

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

// rows of centroids [0, rows) of a tile, 16-byte piece i = (row i / (D /
// 4), its column 4 (i % (D / 4))), copied into ct at a row pitch of D + 4
// floats by cp.async (no register holds them; every piece of the tile is in
// flight at once). The caller waits (cp_async_wait<0>) and syncs.
template <int D>
__device__ __forceinline__ void stage_tile(float* ct, const float* src, int64_t c_c, int rows) {
  constexpr int Q = D / 4;
  for (int i = threadIdx.x; i < rows * Q; i += CS_THREADS)
    cp_async16(ct + (i / Q) * (D + 4) + 4 * (i % Q), src + (i / Q) * c_c + 4 * (i % Q), true);
  cp_async_commit();
}

// grid (S, Hkv, B), clusters of (S, 1, 1); CTA s scores centroids [s chunk,
// min(C, (s + 1) chunk)). Dynamic shared memory: the query rows transposed,
// qT [D][MP] (M = T*G rows padded to MP, a multiple of 4, with zeros), a
// centroid tile [tile][D + 4], logits [M][chunk], and per row the chunk's
// max and sum of exp, then the max and 1 / sum over C [M] each. fault 1
// leaves the last rank out of the (m, l) combine (a planted fault the
// checks must reject).
template <typename QT, int D>
__global__ void __launch_bounds__(CS_THREADS)
centroid_scores_kernel(const QT* __restrict__ q, const float* __restrict__ cent,
                       float* __restrict__ out, int T, int G, int C, int chunk,
                       int64_t q_b, int64_t q_t, int64_t q_h, int64_t c_b,
                       int64_t c_h, int64_t c_c, float scale, int fault) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x, S = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int M = T * G, MP = (M + 3) & ~3;
  const int c_lo = split * chunk, n_own = max(0, min(C, c_lo + chunk) - c_lo);
  const int tile = min(chunk, CS_TILE_FLOATS / (D + 4));
  float* qT = smem;                  // [D][MP]
  float* ct = qT + D * MP;           // [tile][D + 4]
  float* s = ct + tile * (D + 4);    // [M][chunk]
  float* part_m = s + M * chunk;     // [M]: the chunk's max of each row
  float* part_l = part_m + M;        // [M]: the chunk's sum of exp
  float* row_m = part_l + M;         // [M]: the max over C
  float* row_inv = row_m + M;        // [M]: 1 / the sum of exp over C
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const float* cent_bh = cent + b * c_b + h * c_h + (int64_t)c_lo * c_c;
  for (int c0 = 0; c0 < n_own; c0 += tile) {
    const int rows = min(tile, n_own - c0);
    stage_tile<D>(ct, cent_bh + (int64_t)c0 * c_c, c_c, rows);
    if (c0 == 0)  // query row r = t * G + g is q[b, t, h * G + g, :], as qT[d][r]
      for (int i = threadIdx.x; i < MP * D; i += CS_THREADS) {
        const int r = i / D, d = i % D;
        const int t = r / G, g = r % G;
        qT[d * MP + r] =
            r < M ? to_f32(q[b * q_b + t * q_t + (int64_t)(h * G + g) * q_h + d]) : 0.f;
      }
    cp_async_wait<0>();
    __syncthreads();
    // a thread a (centroid, group of 4 rows): 4 centroid values in one
    // 16-byte read (the D + 4 pitch puts the 8 rows of a quarter warp on
    // distinct banks), each value used for 4 rows, the rows' 4 values in one
    // 16-byte read (a broadcast); the products in the order of d
    for (int e = threadIdx.x; e < (MP / 4) * rows; e += CS_THREADS) {
      const int g4 = e / rows, c = e % rows;
      const float4* cr = reinterpret_cast<const float4*>(ct + c * (D + 4));
      const float4* q4 = reinterpret_cast<const float4*>(qT) + g4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 c4 = cr[d4];
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 qv = q4[(4 * d4 + k) * (MP / 4)];
          acc[0] += qv.x * cv[k];
          acc[1] += qv.y * cv[k];
          acc[2] += qv.z * cv[k];
          acc[3] += qv.w * cv[k];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g4 + j < M) s[(4 * g4 + j) * chunk + c0 + c] = acc[j] * scale;
    }
    __syncthreads();
  }

  // the chunk's (max, sum of exp) of each row (an empty chunk: -FLT_MAX, 0)
  for (int r = warp; r < M; r += CS_WARPS) {
    const float* sr = s + r * chunk;
    float m = -FLT_MAX;
    for (int c = lane; c < n_own; c += 32) m = fmaxf(m, sr[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < n_own; c += 32) l += expf(sr[c] - m);
    l = warp_sum(l);
    if (lane == 0) {
      part_m[r] = m;
      part_l[r] = l;
    }
  }
  // every rank's (m, l) is in its shared memory (a cluster of one CTA needs
  // only its own barrier)
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1)
    cluster.sync();
  else
    __syncthreads();

  // each row's (m, l) over C, from the ranks' in rank order
  const int nsum = fault && S > 1 ? S - 1 : S;
  for (int r = threadIdx.x; r < M; r += CS_THREADS) {
    float ms[CS_MAX_SPLITS], ls[CS_MAX_SPLITS];
    float m = -FLT_MAX;
#pragma unroll
    for (int k = 0; k < CS_MAX_SPLITS; ++k)
      if (k < nsum) {
        ms[k] = *cluster.map_shared_rank(part_m + r, k);
        ls[k] = *cluster.map_shared_rank(part_l + r, k);
        m = fmaxf(m, ms[k]);
      }
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < CS_MAX_SPLITS; ++k)
      if (k < nsum) l += ls[k] * expf(ms[k] - m);
    row_m[r] = m;
    row_inv[r] = 1.f / l;
  }
  // this rank is done reading the others' (m, l); it waits for them to be
  // done with its own only before it exits
  if (S > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  float* out_bh = out + ((int64_t)b * gridDim.y + h) * C + c_lo;
  for (int c = threadIdx.x; c < n_own; c += CS_THREADS) {
    float acc = 0.f;
    for (int r = 0; r < M; ++r) acc += expf(s[r * chunk + c] - row_m[r]) * row_inv[r];
    out_bh[c] = acc;
  }
  if (S > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename QT, int D>
int launch(const void* q, const float* cent, float* out, int B, int T, int Hq,
           int Hkv, int C, int S, int chunk, long long q_b, long long q_t,
           long long q_h, long long c_b, long long c_h, long long c_c, int fault,
           cudaStream_t stream) {
  const int G = Hq / Hkv, M = T * G, MP = (M + 3) & ~3;
  const int tile = chunk < CS_TILE_FLOATS / (D + 4) ? chunk : CS_TILE_FLOATS / (D + 4);
  const size_t smem = sizeof(float) * ((size_t)MP * D + (size_t)tile * (D + 4) +
                                       (size_t)M * chunk + 4 * (size_t)M);
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)centroid_scores_kernel<QT, D>, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ex(centroid_scores_kernel<QT, D>, dim3(S, Hkv, B), dim3(CS_THREADS),
                        (int)smem, stream, S, false, static_cast<const QT*>(q), cent, out,
                        T, G, C, chunk, (int64_t)q_b, (int64_t)q_t, (int64_t)q_h,
                        (int64_t)c_b, (int64_t)c_h, (int64_t)c_c,
                        (float)(1.0 / std::sqrt((double)D)), fault);
}

template <typename QT>
int launch_d(const void* q, const float* cent, float* out, int B, int T,
             int Hq, int Hkv, int D, int C, int S, int chunk, long long q_b,
             long long q_t, long long q_h, long long c_b, long long c_h,
             long long c_c, int fault, cudaStream_t stream) {
  if (D == 64)
    return launch<QT, 64>(q, cent, out, B, T, Hq, Hkv, C, S, chunk, q_b, q_t,
                          q_h, c_b, c_h, c_c, fault, stream);
  if (D == 128)
    return launch<QT, 128>(q, cent, out, B, T, Hq, Hkv, C, S, chunk, q_b, q_t,
                           q_h, c_b, c_h, c_c, fault, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32 q, 1 = bfloat16 q. Strides are in
// elements; the D axis of q and of the centroids is contiguous, and each
// centroid starts 16-byte aligned (copied 16 bytes at a time). D is 64 or
// 128; Hq is a multiple of Hkv. The plan (ops/gemm_softmax.py
// `scores_plan`): S in [1, 8] CTAs a cluster, each scoring `chunk`
// centroids, with (S - 1) chunk < C <= S chunk. fault 1 leaves the last rank
// out of each row's (max, sum) (checks only). Returns the CUDA error code
// (0 = success).
extern "C" int mdt_centroid_scores(int dtype, const void* q, const float* cent,
                                   float* out, int B, int T, int Hq, int Hkv,
                                   int D, int C, int S, int chunk, long long q_b,
                                   long long q_t, long long q_h, long long c_b,
                                   long long c_h, long long c_c, int fault,
                                   void* stream) {
  if (Hkv <= 0 || Hq % Hkv || C <= 0 || B <= 0 || T <= 0 || S < 1 ||
      S > mdt::CS_MAX_SPLITS || chunk < 1 || (long long)(S - 1) * chunk >= C ||
      (long long)S * chunk < C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mdt::launch_d<float>(q, cent, out, B, T, Hq, Hkv, D, C, S, chunk,
                                q_b, q_t, q_h, c_b, c_h, c_c, fault, s);
  if (dtype == 1)
    return mdt::launch_d<__nv_bfloat16>(q, cent, out, B, T, Hq, Hkv, D, C, S,
                                        chunk, q_b, q_t, q_h, c_b, c_h, c_c,
                                        fault, s);
  return (int)cudaErrorInvalidValue;
}
