// int4_matmul for Hopper (sm_90a): out [M, N] = x [M, K] @ W, W an int4
// weight packed as biased column-pair nibbles with one f32 scale per 128-row
// group of K and output column.
//
// Replaces magicdec_tpu/ops/pallas/int4_matmul.py int4_matmul (pallas_call at
// :131). What it computes (int4_matmul.py:60-99): byte q4[k, n] holds column n
// in its low nibble and column n + N/2 in its high one, each the code q + 8 in
// [0, 15]; per 128-row group g of K the product is
//     s_g * (x_g . Qu_g - 8 * rowsum(x_g)),
// summed over the groups in f32 and rounded to x's dtype. The TPU kernel's
// tiling (n_block/k_block, the interleaved scale rows, the split-halves output
// and its concatenate) is not carried over: the kernel writes [M, N] directly.
//
// Bound on the H100: at decode (M = 64 padded rows) by the packed weight's
// bytes, K*N/2 + 4*K*N/128 (llama-3.2-1b: wqkv 3.34 MB, 1.0 us at 3.35 TB/s;
// w_gate_up 17.8 MB, 5.3 us; 0.154 ms for the four products of 16 layers); in
// prefill (M = 1024) by the tensor cores, 2*M*K*N operations.
//
// Design: one CTA of 4 warps per (16 packed columns = 32 outputs, 64 rows). It
// walks K in order, one 128-row group per stage of a cp.async ring (the x
// tile, the q4 tile and the group's 32 scales), and chooses no tile from M, so
// a row's bits do not depend on how many rows share the call. bf16 x runs on
// mma.sync m16n8k16 with f32 accumulation: warp w owns 8 output columns of the
// low (w < 2) or high (w >= 2) nibbles for all 64 rows; the nibbles (0..15,
// exact in bf16) are unpacked into B fragments in registers, and each group's
// row sums come from the same tensor cores as the product with a B of ones.
// f32 x (the exact tests) runs on CUDA cores: each thread one output column of
// 16 rows, sequential f32 FMAs. A simple first version: no wgmma or TMA, and
// at decode only N/32 CTAs (32 to 512) stream the weight.
#include <type_traits>

#include "mma.cuh"

namespace mdt {

constexpr int GROUP = 128;  // K rows per scale group
constexpr int BM = 64;      // rows per CTA
constexpr int BN2 = 16;     // packed columns per CTA (32 outputs)
constexpr int NTH = 128;    // threads per CTA

template <typename T>
struct I4 {
  static constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int STAGES = MMA ? 4 : 2;
  static constexpr int VEC = 16 / sizeof(T);          // elements per 16 bytes
  static constexpr int XP = GROUP + VEC;              // x row pitch (elements)
  static constexpr int X_BYTES = BM * XP * sizeof(T);
  static constexpr int Q_BYTES = GROUP * BN2;
  static constexpr int S_BYTES = 2 * BN2 * 4;
  static constexpr int STAGE = X_BYTES + Q_BYTES + S_BYTES;  // a multiple of 16
  static constexpr int BYTES = STAGES * STAGE;
};

// stage <- group gi: x rows [m0, m0 + 64) (rows >= M zero), q4 rows of the
// group at packed columns [n0, n0 + 16), and the group's scales of output
// columns n0.. (low nibbles) and N2 + n0.. (high nibbles)
template <typename T>
__device__ __forceinline__ void load_group(char* st, const T* __restrict__ x,
                                           const int8_t* __restrict__ q4,
                                           const float* __restrict__ s4, int M, int K,
                                           int N2, int m0, int n0, int gi, int tid) {
  using C = I4<T>;
  T* xs = reinterpret_cast<T*>(st);
  char* qs = st + C::X_BYTES;
  float* ss = reinterpret_cast<float*>(st + C::X_BYTES + C::Q_BYTES);
  constexpr int CPR = GROUP / C::VEC;  // 16-byte chunks per x row
  const int k0 = gi * GROUP;
  for (int i = tid; i < BM * CPR; i += NTH) {
    const int r = i / CPR, cc = i % CPR;
    const bool ok = m0 + r < M;
    const T* src = ok ? x + (int64_t)(m0 + r) * K + k0 + cc * C::VEC : x;
    cp_async16(xs + r * C::XP + cc * C::VEC, src, ok);
  }
  for (int i = tid; i < GROUP; i += NTH)
    cp_async16(qs + i * BN2, q4 + (int64_t)(k0 + i) * N2 + n0, true);
  if (tid < 2 * BN2) {
    const int col = n0 + tid + (tid < BN2 ? 0 : N2 - BN2);
    cp_async4(ss + tid, s4 + (int64_t)gi * 2 * N2 + col, true);
  }
}

// acc += this group's term, tensor cores (bf16 x). acc[4 * mt + e] is the C
// fragment element e of m-tile mt.
__device__ __forceinline__ void group_mma(const char* st, float (&acc)[16], int tid) {
  using C = I4<__nv_bfloat16>;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
  const uint8_t* qs = reinterpret_cast<const uint8_t*>(st + C::X_BYTES);
  const float* ss = reinterpret_cast<const float*>(st + C::X_BYTES + C::Q_BYTES);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int hi = warp >> 1, sub = warp & 1;
  const int bcol = sub * 8 + g;  // packed column of this lane's B fragment
  const int shift = hi * 4;
  constexpr uint32_t ONES = 0x3F803F80u;  // bf16 1.0, twice
  float p[4][4], rs[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[mt][e] = rs[mt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < GROUP / 16; ++ks) {
    const int k = ks * 16 + 2 * c;
    const float q0 = (float)((qs[k * BN2 + bcol] >> shift) & 15);
    const float q1 = (float)((qs[(k + 1) * BN2 + bcol] >> shift) & 15);
    const float q8 = (float)((qs[(k + 8) * BN2 + bcol] >> shift) & 15);
    const float q9 = (float)((qs[(k + 9) * BN2 + bcol] >> shift) & 15);
    const uint32_t b0 = pack_bf16(q0, q1), b1 = pack_bf16(q8, q9);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* base = xs + (mt * 16 + g) * C::XP + ks * 16 + 2 * c;
      const uint32_t a[4] = {ld32(base), ld32(base + 8 * C::XP), ld32(base + 8),
                             ld32(base + 8 * C::XP + 8)};
      mma_bf16(p[mt], a, b0, b1);
      mma_bf16(rs[mt], a, ONES, ONES);
    }
  }
  // C columns 2c, 2c+1 of this warp's n8 tile
  const float s0 = ss[hi * BN2 + sub * 8 + 2 * c], s1 = ss[hi * BN2 + sub * 8 + 2 * c + 1];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    acc[4 * mt + 0] += (p[mt][0] - 8.f * rs[mt][0]) * s0;
    acc[4 * mt + 1] += (p[mt][1] - 8.f * rs[mt][1]) * s1;
    acc[4 * mt + 2] += (p[mt][2] - 8.f * rs[mt][2]) * s0;
    acc[4 * mt + 3] += (p[mt][3] - 8.f * rs[mt][3]) * s1;
  }
}

// acc += this group's term, CUDA cores (f32 x): thread t owns output column
// t % 32 of the CTA (16 low-nibble columns, then 16 high) for rows
// 16 * (t / 32) .. + 15
__device__ __forceinline__ void group_f32(const char* st, float (&acc)[16], int tid) {
  using C = I4<float>;
  const float* xs = reinterpret_cast<const float*>(st);
  const uint8_t* qs = reinterpret_cast<const uint8_t*>(st + C::X_BYTES);
  const float* ss = reinterpret_cast<const float*>(st + C::X_BYTES + C::Q_BYTES);
  const int j = tid % 32, shift = (j / BN2) * 4, jb = j % BN2, r0 = (tid / 32) * 16;
  float p[16], rs[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) p[r] = rs[r] = 0.f;
  for (int k = 0; k < GROUP; ++k) {
    const float w = (float)((qs[k * BN2 + jb] >> shift) & 15);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float xv = xs[(r0 + r) * C::XP + k];
      p[r] = fmaf(xv, w, p[r]);
      rs[r] += xv;
    }
  }
  const float s = ss[j];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r] += (p[r] - 8.f * rs[r]) * s;
}

// grid (N2 / 16, ceil(M / 64)), NTH threads, I4<T>::BYTES of dynamic shared memory
template <typename T>
__global__ void __launch_bounds__(NTH)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q4,
                   const float* __restrict__ s4, T* __restrict__ out, int M, int K,
                   int N2) {
  using C = I4<T>;
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * BN2, m0 = blockIdx.y * BM, tid = threadIdx.x;
  const int NG = K / GROUP;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < NG) load_group<T>(smem + s * C::STAGE, x, q4, s4, M, K, N2, m0, n0, s, tid);
    cp_async_commit();
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int gi = 0; gi < NG; ++gi) {
    cp_async_wait<C::STAGES - 2>();  // group gi has landed
    __syncthreads();                 // ... for every thread; gi - 1 is consumed
    const int nx = gi + C::STAGES - 1;
    if (nx < NG)
      load_group<T>(smem + (nx % C::STAGES) * C::STAGE, x, q4, s4, M, K, N2, m0, n0,
                    nx, tid);
    cp_async_commit();
    const char* st = smem + (gi % C::STAGES) * C::STAGE;
    if constexpr (C::MMA)
      group_mma(st, acc, tid);
    else
      group_f32(st, acc, tid);
  }
  cp_async_wait<0>();

  const int64_t N = 2 * (int64_t)N2;
  if constexpr (C::MMA) {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    const int col = (warp >> 1) * N2 + n0 + (warp & 1) * 8 + 2 * c;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mt * 16 + g + 8 * half;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + row * N + col) =
              pack_bf16(acc[4 * mt + 2 * half], acc[4 * mt + 2 * half + 1]);
      }
  } else {
    const int j = tid % 32, r0 = (tid / 32) * 16;
    const int col = (j / BN2) * N2 + n0 + j % BN2;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (m0 + r0 + r < M) out[(m0 + r0 + r) * N + col] = from_f32<T>(acc[r]);
  }
}

template <typename T>
int launch_int4(const void* x, const void* q4, const void* s4, void* out, int M, int K,
                int N2, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(int4_matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         I4<T>::BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(N2 / BN2, (M + BM - 1) / BM);
  int4_matmul_kernel<T><<<grid, NTH, I4<T>::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q4),
      static_cast<const float*>(s4), static_cast<T*>(out), M, K, N2);
  return (int)cudaGetLastError();
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16 (x and out). x [M, K]
// with K a multiple of 128; q4 [K, N2] int8 with N2 a multiple of 16; s4
// [K / 128, 2 * N2] f32; out [M, 2 * N2]. All contiguous, 16-byte aligned.
// Returns the CUDA error code of the launch.
extern "C" int mdt_int4_matmul(int dtype, const void* x, const void* q4, const void* s4,
                               void* out, int M, int K, int N2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % mdt::GROUP || N2 % mdt::BN2 || M <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return mdt::launch_int4<float>(x, q4, s4, out, M, K, N2, st);
  if (dtype == 1) return mdt::launch_int4<__nv_bfloat16>(x, q4, s4, out, M, K, N2, st);
  return (int)cudaErrorInvalidValue;
}
