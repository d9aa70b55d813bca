// The fused decode block for Hopper (sm_90a): the weight products around a
// decoder layer's attention with their norms, residuals and SwiGLU.
//
//   fused_qkv:       qkv = rmsnorm(x) @ wqkv (+ bqkv)
//   fused_post_attn: t = x + ctx @ wo;  out = t + swiglu(rmsnorm(t)) @ w_down
//
// Replaces magicdec_tpu/ops/pallas/fused_block.py fused_qkv (pallas_call at
// :96) and fused_post_attn (pallas_call at :191), with their rounding points
// (fused_block.py:62-75, 116-159): RMSNorm normalizes in f32, rounds to x's
// dtype and multiplies by the norm weight in x's dtype; products sum in f32
// and round to x's dtype; t = x + round(acc - x) with acc = x + ctx @ wo in
// f32; a = round(silu(gate)) * round(up), a product in x's dtype;
// out = t + round(a @ w_down).
//
// Bound on the H100: at decode (M = 8 or 56 rows) by the weights' bytes
// (llama-3.2-1b bf16, per layer: fused_qkv 12.6 MB, 3.8 us at 3.35 TB/s;
// fused_post_attn 109 MB, 32.6 us). The TPU kernel carries t, h and the
// accumulator across a sequential grid; Hopper's CTAs run in parallel and in
// no order, so each pass over a weight is its own kernel: fused_qkv issues
// two kernels (the RMSNorm, the product with the bias in its epilogue) and
// fused_post_attn four (the wo product with the residual, the RMSNorm of t,
// the gate/up product with SwiGLU, the w_down product with the residual).
//
// Design: one GEMM kernel, a CTA of 4 warps per 64 rows and two 16-column
// blocks of the weight (columns c0.. and c1..: adjacent for a plain product,
// c1 = c0 + I for gate/up, so a CTA holds the gate and up columns SwiGLU
// pairs). It walks K in order through a cp.async ring of 64-row stages and
// chooses no tile from M, and the RMSNorm sums each row in a fixed order, so
// a row's bits do not depend on how many rows share the call (the draft's
// M = B and the verify's M = B * (gamma + 1)). bf16 runs on mma.sync m16n8k16
// with f32 accumulation (warp w owns one 8-column tile for all 64 rows), f32
// (the exact tests) on CUDA cores (a thread one column of 16 rows, sequential
// FMAs). The accumulators pass through a shared-memory tile to the epilogue,
// which sees both column blocks of a row. Rows past M are zero-filled by the
// copies, never read from memory. A simple first version: no wgmma or TMA.
#include <type_traits>

#include "mma.cuh"

namespace mdt {

constexpr int BM = 64;    // rows per CTA
constexpr int HALF = 16;  // columns per column block (two per CTA)
constexpr int BK = 64;    // K rows per stage
constexpr int NTH = 128;  // threads per GEMM CTA
constexpr int NORM_THREADS = 256;

enum Epilogue { QKV = 0, WO = 1, GATE_UP = 2, DOWN = 3 };

template <typename T>
struct Gemm {
  static constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int STAGES = MMA ? 4 : 2;
  static constexpr int VEC = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int AP = BK + VEC;            // A row pitch (elements)
  static constexpr int WP = 2 * HALF + VEC;      // W row pitch (elements)
  static constexpr int A_BYTES = BM * AP * sizeof(T);
  static constexpr int W_BYTES = BK * WP * sizeof(T);
  static constexpr int STAGE = A_BYTES + W_BYTES;  // a multiple of 16
  static constexpr int CP = 2 * HALF + 1;        // accumulator tile pitch (floats)
  static constexpr int BYTES = STAGES * STAGE + BM * CP * 4;
};

template <typename T>
struct GemmArgs {
  const T* a;    // [M, K], row stride lda
  const T* w;    // [K, ldw]
  const T* aux;  // QKV: bias [N] or null; WO: x [M, N]; DOWN: t [M, N]
  T* out;        // [M, ldo]
  int M, K, lda, ldw, ldo;
  int cstep;     // columns between the c0 of neighbouring CTAs
  int pair;      // c1 - c0
  int mode;      // Epilogue
};

template <typename T>
__device__ __forceinline__ void load_stage(char* st, const GemmArgs<T>& p, int m0, int c0,
                                           int c1, int kc, int tid) {
  using C = Gemm<T>;
  T* sa = reinterpret_cast<T*>(st);
  T* sw = reinterpret_cast<T*>(st + C::A_BYTES);
  constexpr int CPR = BK / C::VEC;    // 16-byte chunks per A row
  constexpr int CPH = HALF / C::VEC;  // 16-byte chunks per column block row
  const int k0 = kc * BK;
  for (int i = tid; i < BM * CPR; i += NTH) {
    const int r = i / CPR, cc = i % CPR;
    const bool ok = m0 + r < p.M;
    const T* src = ok ? p.a + (int64_t)(m0 + r) * p.lda + k0 + cc * C::VEC : p.a;
    cp_async16(sa + r * C::AP + cc * C::VEC, src, ok);
  }
  for (int i = tid; i < BK * 2 * CPH; i += NTH) {
    const int k = i / (2 * CPH), blk = (i / CPH) % 2, cc = i % CPH;
    const int cb = blk ? c1 : c0;
    const bool ok = cb < p.ldw;
    const T* src = ok ? p.w + (int64_t)(k0 + k) * p.ldw + cb + cc * C::VEC : p.w;
    cp_async16(sw + k * C::WP + blk * HALF + cc * C::VEC, src, ok);
  }
}

// acc += A tile @ W tile on the tensor cores; acc[4 * mt + e] is the C
// fragment element e of m-tile mt of this warp's 8 columns
__device__ __forceinline__ void stage_mma(const char* st, float (&acc)[16], int tid) {
  using C = Gemm<__nv_bfloat16>;
  const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(st);
  const unsigned short* sw = reinterpret_cast<const unsigned short*>(st + C::A_BYTES);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int bcol = warp * 8 + g;  // this lane's B column within the 32 of the tile
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    const int k = ks * 16 + 2 * c;
    const uint32_t b0 = (uint32_t)sw[k * C::WP + bcol] |
                        ((uint32_t)sw[(k + 1) * C::WP + bcol] << 16);
    const uint32_t b1 = (uint32_t)sw[(k + 8) * C::WP + bcol] |
                        ((uint32_t)sw[(k + 9) * C::WP + bcol] << 16);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* base = sa + (mt * 16 + g) * C::AP + ks * 16 + 2 * c;
      const uint32_t a[4] = {ld32(base), ld32(base + 8 * C::AP), ld32(base + 8),
                             ld32(base + 8 * C::AP + 8)};
      float* d = acc + 4 * mt;
      mma_bf16(*reinterpret_cast<float(*)[4]>(d), a, b0, b1);
    }
  }
}

// acc[r] += sum_k A[16 * (t / 32) + r][k] W[k][t % 32], CUDA cores (f32)
__device__ __forceinline__ void stage_f32(const char* st, float (&acc)[16], int tid) {
  using C = Gemm<float>;
  const float* sa = reinterpret_cast<const float*>(st);
  const float* sw = reinterpret_cast<const float*>(st + C::A_BYTES);
  const int j = tid % 32, r0 = (tid / 32) * 16;
  for (int k = 0; k < BK; ++k) {
    const float w = sw[k * C::WP + j];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = fmaf(sa[(r0 + r) * C::AP + k], w, acc[r]);
  }
}

// grid (column blocks, ceil(M / 64)), NTH threads, Gemm<T>::BYTES of dynamic
// shared memory
template <typename T>
__global__ void __launch_bounds__(NTH) gemm_kernel(const GemmArgs<T> p) {
  using C = Gemm<T>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, m0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * p.cstep, c1 = c0 + p.pair;
  const int NK = p.K / BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < NK) load_stage<T>(smem + s * C::STAGE, p, m0, c0, c1, s, tid);
    cp_async_commit();
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < NK; ++kc) {
    cp_async_wait<C::STAGES - 2>();  // stage kc has landed
    __syncthreads();                 // ... for every thread; kc - 1 is consumed
    const int nx = kc + C::STAGES - 1;
    if (nx < NK) load_stage<T>(smem + (nx % C::STAGES) * C::STAGE, p, m0, c0, c1, nx, tid);
    cp_async_commit();
    const char* st = smem + (kc % C::STAGES) * C::STAGE;
    if constexpr (C::MMA)
      stage_mma(st, acc, tid);
    else
      stage_f32(st, acc, tid);
  }
  cp_async_wait<0>();

  // accumulators -> shared tile [64][32] (column j < 16: block c0, else c1)
  float* cs = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);
  if constexpr (C::MMA) {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cs[(mt * 16 + g + 8 * (e >> 1)) * C::CP + warp * 8 + 2 * c + (e & 1)] =
            acc[4 * mt + e];
  } else {
    const int j = tid % 32, r0 = (tid / 32) * 16;
#pragma unroll
    for (int r = 0; r < 16; ++r) cs[(r0 + r) * C::CP + j] = acc[r];
  }
  __syncthreads();

  if (p.mode == GATE_UP) {  // out [M, I] = round(silu(gate)) * round(up)
    for (int i = tid; i < BM * HALF; i += NTH) {
      const int r = i / HALF, j = i % HALF, row = m0 + r;
      if (row >= p.M) continue;
      const float gate = cs[r * C::CP + j], up = cs[r * C::CP + HALF + j];
      const float silu = (1.f / (1.f + expf(-gate))) * gate;
      p.out[(int64_t)row * p.ldo + c0 + j] =
          from_f32<T>(round_to<T>(silu) * round_to<T>(up));
    }
    return;
  }
  for (int i = tid; i < BM * 2 * HALF; i += NTH) {
    const int r = i / (2 * HALF), j = i % (2 * HALF), row = m0 + r;
    const int col = j < HALF ? c0 + j : c1 + j - HALF;
    if (row >= p.M || col >= p.ldw) continue;
    const float acc_v = cs[r * C::CP + j];
    float v;
    if (p.mode == QKV) {
      v = round_to<T>(acc_v);
      if (p.aux) v += to_f32(p.aux[col]);
    } else if (p.mode == WO) {  // acc = x + ctx @ wo; t = x + round(acc - x)
      const float x = to_f32(p.aux[(int64_t)row * p.ldo + col]);
      v = x + round_to<T>((x + acc_v) - x);
    } else {                    // DOWN: out = t + round(a @ w_down)
      v = to_f32(p.aux[(int64_t)row * p.ldo + col]) + round_to<T>(acc_v);
    }
    p.out[(int64_t)row * p.ldo + col] = from_f32<T>(v);
  }
}

// h[r] = round(round(x[r] * rsqrt(mean(x[r]^2) + eps)) * w), one CTA per row;
// the sum of squares runs in a fixed order (strided per thread, then a fixed
// shuffle tree and the warps' partial sums in order)
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ h, int D,
               float eps) {
  __shared__ float part[NORM_THREADS / 32];
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* hr = h + (int64_t)blockIdx.x * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += NORM_THREADS) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_THREADS / 32; ++i) total += part[i];
  const float inv = __frsqrt_rn(total / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += NORM_THREADS)
    hr[i] = from_f32<T>(round_to<T>(to_f32(xr[i]) * inv) * to_f32(w[i]));
}

template <typename T>
int set_attributes() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gemm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Gemm<T>::BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  return 0;
}

template <typename T>
int gemm(const GemmArgs<T>& p, int n_blocks, cudaStream_t stream) {
  const dim3 grid(n_blocks, (p.M + BM - 1) / BM);
  gemm_kernel<T><<<grid, NTH, Gemm<T>::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int rmsnorm(const void* x, const void* w, void* h, int M, int D, float eps,
            cudaStream_t stream) {
  rmsnorm_kernel<T><<<M, NORM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(h), D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_qkv(const void* x, const void* norm, const void* w, const void* bias, void* h,
              void* out, int M, int D, int O, float eps, cudaStream_t stream) {
  int rc = set_attributes<T>();
  if (!rc) rc = rmsnorm<T>(x, norm, h, M, D, eps, stream);
  if (rc) return rc;
  const GemmArgs<T> p{static_cast<const T*>(h), static_cast<const T*>(w),
                      static_cast<const T*>(bias), static_cast<T*>(out),
                      M, D, D, O, O, 2 * HALF, HALF, QKV};
  return gemm<T>(p, (O + 2 * HALF - 1) / (2 * HALF), stream);
}

template <typename T>
int fused_post_attn(const void* x, const void* ctx, const void* wo, const void* norm,
                    const void* w_gate_up, const void* w_down, void* t, void* h, void* a,
                    void* out, int M, int D, int HqD, int I, float eps,
                    cudaStream_t stream) {
  int rc = set_attributes<T>();
  if (rc) return rc;
  const GemmArgs<T> p_wo{static_cast<const T*>(ctx), static_cast<const T*>(wo),
                         static_cast<const T*>(x), static_cast<T*>(t),
                         M, HqD, HqD, D, D, 2 * HALF, HALF, WO};
  if ((rc = gemm<T>(p_wo, (D + 2 * HALF - 1) / (2 * HALF), stream))) return rc;
  if ((rc = rmsnorm<T>(t, norm, h, M, D, eps, stream))) return rc;
  // w_gate_up [D, 2, I] read as [D, 2I]: gate column i, up column I + i
  const GemmArgs<T> p_gu{static_cast<const T*>(h), static_cast<const T*>(w_gate_up),
                         nullptr, static_cast<T*>(a),
                         M, D, D, 2 * I, I, HALF, I, GATE_UP};
  if ((rc = gemm<T>(p_gu, I / HALF, stream))) return rc;
  const GemmArgs<T> p_down{static_cast<const T*>(a), static_cast<const T*>(w_down),
                           static_cast<const T*>(t), static_cast<T*>(out),
                           M, I, I, D, D, 2 * HALF, HALF, DOWN};
  return gemm<T>(p_down, (D + 2 * HALF - 1) / (2 * HALF), stream);
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16 (every operand).
// Contraction lengths (D, HqD, I) multiples of 64, output widths multiples of
// 16; contiguous, 16-byte aligned operands; h, t, a are scratch of [M, D],
// [M, D], [M, I]. Each returns the CUDA error code of its launches.
extern "C" int mdt_fused_qkv(int dtype, const void* x, const void* norm, const void* w,
                             const void* bias, void* h, void* out, int M, int D, int O,
                             float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D % mdt::BK || O % mdt::HALF) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return mdt::fused_qkv<float>(x, norm, w, bias, h, out, M, D, O, eps, st);
  if (dtype == 1)
    return mdt::fused_qkv<__nv_bfloat16>(x, norm, w, bias, h, out, M, D, O, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mdt_fused_post_attn(int dtype, const void* x, const void* ctx,
                                   const void* wo, const void* norm,
                                   const void* w_gate_up, const void* w_down, void* t,
                                   void* h, void* a, void* out, int M, int D, int HqD,
                                   int I, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D % mdt::BK || HqD % mdt::BK || I % mdt::BK)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return mdt::fused_post_attn<float>(x, ctx, wo, norm, w_gate_up, w_down, t, h, a, out,
                                       M, D, HqD, I, eps, st);
  if (dtype == 1)
    return mdt::fused_post_attn<__nv_bfloat16>(x, ctx, wo, norm, w_gate_up, w_down, t, h,
                                               a, out, M, D, HqD, I, eps, st);
  return (int)cudaErrorInvalidValue;
}
