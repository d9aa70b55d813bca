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
// fused_post_attn 109 MB, 32.6 us; llama-3.1-8b: 50 MB and 386 MB). The TPU
// kernel carries t, h and the accumulator across a sequential grid; Hopper's
// CTAs run in parallel and in no order, so each pass over a weight is its
// own kernel.
//
// bf16 fused_post_attn (post_kernel): three kernels of one weight-streaming
// design, the wo product with the residual (t), the gate/up product with the
// RMSNorm of t folded into its operand and SwiGLU in its epilogue (a), and the
// w_down product with the residual (out). A CTA of 8 warps owns 64 rows and 128
// output columns (gate/up: 64 gate columns and the matching 64 up columns, I
// apart) and walks one split's range of 64-row K stages through a 4-stage ring
// in shared memory: one thread loads a stage by TMA (the two 64-column weight
// boxes and the activation box, each 128-byte swizzled) on the stage's
// mbarrier, so 64 KB of weight are in flight a CTA. The product runs transposed
// on wgmma m64n64k16 (f32 accumulation) with both operands read from the
// swizzled boxes: D [columns][rows] = W^T (the weight box as the MN-major A
// operand) . act^T (the activation box as the K-major B); each warpgroup owns
// one 64-column box, all 64 rows (rows past M are the TMA's zeros). (An
// mma.sync form with ldmatrix.trans, 8 warps of 16 columns that skipped row
// tiles past M, ran the gate/up pass at M = 56 in 0.0499 ms against 0.0324 on
// wgmma: PERF.md.) K is split by the wrapper's plan (ops/fused_block.py
// `launch_plan`, from K and N alone) over a thread-block cluster: each CTA
// leaves its f32 partial tile in shared memory, and CTA r of the cluster sums
// rows r, r + S, ... of the S partials in split order through distributed
// shared memory, then applies the epilogue and rounds once. The RMSNorm rides
// on the two kernels around it: the wo epilogue leaves each row's sum of
// squares of t by 128-column block (ssq, [M, D / 128] f32: a lane's 4 columns
// in order, then a butterfly over the warp), and each gate/up CTA sums a row's
// blocks in order, takes the inverse RMS, and turns each stage's t box into h =
// round(round(t * inv) * w) in place before its product. The order depends on D
// alone, so every CTA forms the same h at any M, and no RMSNorm kernel and no h
// buffer remain. (Each gate/up CTA reading its rows of t whole took 24 us more
// than the pass's bytes at M = 56: PERF.md.) The three launches use
// programmatic dependent launch: the wo kernel waits for the kernel before it
// (griddepcontrol.wait) before it reads or writes anything, then lets the next
// kernel start; the gate/up and down kernels let the next kernel start at once,
// fetch their first weight stages (which no kernel of the call writes), then
// wait before they read t or a. Two CTAs fit an SM (~97 KB of shared memory
// each, <= 128 registers a thread), so a dependent CTA fills its ring beside a
// running one. Nothing of the launch is chosen from M and a row's products
// never mix with another row's, so a row's bits do not depend on how many rows
// share the call.
//
// fused_qkv (both dtypes) and the f32 fused_post_attn (the exact checks):
// the first port's kernels. One GEMM kernel, a CTA of 4 warps per 64 rows
// and two 16-column blocks of the weight, K walked in order through a
// cp.async ring of 64-row stages; bf16 on mma.sync with f32 accumulation,
// f32 on CUDA cores (a thread one column of 16 rows, sequential FMAs); the
// RMSNorm its own kernel (one CTA a row, a fixed order). fused_qkv issues
// two kernels (the RMSNorm, the product with the bias in its epilogue), the
// f32 fused_post_attn four (wo, the RMSNorm of t, gate/up, w_down).
#include <cooperative_groups.h>

#include <type_traits>
#include <vector>

#include "mma.cuh"
#include "tma.cuh"

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
int gemm(const GemmArgs<T>& p, int n_blocks, cudaStream_t stream) {
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)gemm_kernel<T>, Gemm<T>::BYTES);
  if (e != cudaSuccess) return (int)e;
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
  int rc = rmsnorm<T>(x, norm, h, M, D, eps, stream);
  if (rc) return rc;
  const GemmArgs<T> p{static_cast<const T*>(h), static_cast<const T*>(w),
                      static_cast<const T*>(bias), static_cast<T*>(out),
                      M, D, D, O, O, 2 * HALF, HALF, QKV};
  return gemm<T>(p, (O + 2 * HALF - 1) / (2 * HALF), stream);
}

int fused_post_attn_f32(const void* x, const void* ctx, const void* wo, const void* norm,
                        const void* w_gate_up, const void* w_down, void* t, void* h, void* a,
                        void* out, int M, int D, int HqD, int I, float eps,
                        cudaStream_t stream) {
  using T = float;
  int rc;
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

// ---------------------------------------------------------------------------
// bf16 fused_post_attn: TMA weight streaming, K split over a cluster
// ---------------------------------------------------------------------------

namespace pa {
constexpr int BM = 64;                    // activation rows per CTA
constexpr int BK = 64;                    // K rows per stage
constexpr int BOX = 64;                   // columns per weight box (128 bytes)
constexpr int WARPS = 8;                  // warp w owns columns 16 w .. 16 w + 15
constexpr int NTH = 32 * WARPS;
constexpr int STAGES = 4;
constexpr int MAX_SPLITS = 8;             // the portable cluster size
constexpr int W_BOX = BK * 128;           // bytes of a weight box [64 k][64 columns]
constexpr int A_BOX = BM * 128;           // bytes of the activation box [64 rows][64 k]
constexpr int STAGE = 2 * W_BOX + A_BOX;  // 24 KB: a multiple of the swizzle's 1024
constexpr int RING = STAGES * STAGE;
constexpr int BYTES = RING + 1024;        // + the base's alignment (gate/up: + the norm)
constexpr int PP = 2 * BOX + 4;           // the partial tile's row pitch, f32
static_assert(BM * PP * 4 <= RING, "the partial tile reuses the ring");
}  // namespace pa

// stage boundaries of the splits: split s walks stages [s[s], s[s + 1])
struct PostSplits {
  int s[pa::MAX_SPLITS + 1];
};

// the TMA's views: the activation [M, K] in boxes of [64 rows][64 k] (rows
// past M arrive as zeros, unread) and the weight [K, W] in boxes of [64 k][64
// columns] (columns past W as zeros), both 128-byte swizzled
struct PostMaps {
  CUtensorMap act, w;
};

struct PostArgs {
  const __nv_bfloat16* aux;   // WO: x [M, N]; DOWN: t [M, N]
  const __nv_bfloat16* norm;  // GATE_UP: the norm weight [K]
  __nv_bfloat16* out;         // [M, N]: t, a or out
  float* ssq;                 // [M, nb]: t's sums of squares by column block (WO
                              // writes them, GATE_UP reads them)
  int nb;
  int M, N, K;
  int col_step;  // columns between the first boxes of neighbouring column blocks
  int second;    // a CTA's second box starts this many columns after its first
  float eps;
  int fault;     // 1: the cluster sum leaves the last split's partial out
};

__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// a stage's weight boxes (columns c0.. and c1.., K rows k0..) and its
// activation box (rows m0.., k0..), completing on the stage's barrier
__device__ __forceinline__ void post_load_w(uint32_t st, uint32_t bar, const PostMaps& maps,
                                            int c0, int c1, int k0) {
  tma_2d(st, &maps.w, bar, c0, k0);
  tma_2d(st + pa::W_BOX, &maps.w, bar, c1, k0);
}
__device__ __forceinline__ void post_load_act(uint32_t st, uint32_t bar, const PostMaps& maps,
                                              int m0, int k0) {
  tma_2d(st + 2 * pa::W_BOX, &maps.act, bar, k0, m0);
}

// d += a . b on wgmma m64n64k16 with both operands in shared memory: A (64
// x 16) MN-major (the transpose flag), B (16 x 64) K-major
__device__ __forceinline__ void wgmma_ss_tn(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// acc += one stage's product for warpgroup wg's weight box, transposed:
// D [64 columns][64 rows] = W^T (the weight box, MN-major: each k row holds
// the box's 64 columns) . act^T (the activation box, K-major). A k16 step
// starts 16 rows (2048 bytes) into the weight box and 32 bytes into the
// activation box's rows. acc[4 n + e] is D element (column 16 w + g + 8 (e /
// 2), row 8 n + 2 c + e % 2) for lane (g, c) of warp w of the warpgroup.
__device__ __forceinline__ void post_stage_mma(uint32_t st, float (&acc)[32], int wg) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < pa::BK / 16; ++ks)
    wgmma_ss_tn(acc, desc_sw128(st + wg * pa::W_BOX + ks * 2048, 1024),
                desc_sw128(st + 2 * pa::W_BOX + ks * 32));
  wgmma_commit();
  wgmma_wait<0>();
}

// round(round(t * inv) * w) of the two bf16 in t2 and w2: t * inv in f32,
// rounded to a bf16 pair in one cvt, then one bf16x2 multiply (the exact
// product of two bf16 rounded once, as a product in x's dtype rounds)
__device__ __forceinline__ uint32_t norm_pair(uint32_t t2, uint32_t w2, float inv) {
  const uint32_t h = pack_bf16(__uint_as_float(t2 << 16) * inv,
                               __uint_as_float(t2 & 0xFFFF0000u) * inv);
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(h), "r"(w2));
  return r;
}

// the stage's activation box, t rows [0, rows) at k0.., turned into h in
// place; w points at the norm weight of k0
__device__ __forceinline__ void to_h(char* abox, const __nv_bfloat16* w, const float* inv,
                                     int rows, int tid) {
  for (int i = tid; i < rows * 8; i += pa::NTH) {
    const int r = i / 8, pc = i % 8;
    uint4* p = reinterpret_cast<uint4*>(abox + r * 128 + pc * 16);
    const uint4 wv = *reinterpret_cast<const uint4*>(w + 8 * (pc ^ (r % 8)));
    const float s = inv[r];
    uint4 v = *p;
    v.x = norm_pair(v.x, wv.x, s);
    v.y = norm_pair(v.y, wv.y, s);
    v.z = norm_pair(v.z, wv.z, s);
    v.w = norm_pair(v.w, wv.w, s);
    *p = v;
  }
}

// the sum of squares of one row's 128 columns of a column block, the lane
// holding 4 of them (v, in column order): each lane's four in order, then a
// butterfly over the warp (every lane ends with the same bits). The order
// depends on nothing but the column block's width.
__device__ __forceinline__ float block_ssq(const float (&v)[4]) {
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) ss += v[e] * v[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return ss;
}

// the sum of the first n ranks' f32 x 4 at `local`, in rank order
__device__ __forceinline__ float4 cluster_sum(cooperative_groups::cluster_group& cluster,
                                              float* local, int n) {
  float4 sum = *reinterpret_cast<const float4*>(cluster.map_shared_rank(local, 0));
  for (int s = 1; s < n; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(local, s));
    sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
  }
  return sum;
}

__device__ __forceinline__ float swiglu(float gate, float up) {
  const float silu = (1.f / (1.f + expf(-gate))) * gate;
  return round_to<__nv_bfloat16>(silu) * round_to<__nv_bfloat16>(up);
}

// grid (S, column blocks, ceil(M / 64)), clusters of (S, 1, 1), pa::NTH
// threads, pa::BYTES (+ 2 K for GATE_UP) of dynamic shared memory
template <int MODE>
__global__ void __launch_bounds__(pa::NTH, 2)
post_kernel(const __grid_constant__ PostMaps maps, const PostArgs p, const PostSplits splits) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ __align__(8) uint64_t full[pa::STAGES];
  __shared__ float inv[pa::BM];
  char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t ring = smem_u32(smem);
  __nv_bfloat16* norm_s = reinterpret_cast<__nv_bfloat16*>(smem + pa::RING);
  const int S = gridDim.x, split = blockIdx.x;
  const int c0 = blockIdx.y * p.col_step, c1 = c0 + p.second, m0 = blockIdx.z * pa::BM;
  const int rows = min(pa::BM, p.M - m0);  // rows of this tile that exist (>= 1)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the split's stages, read by constant index (a dynamic index into the
  // parameter block would go through local memory)
  int s0 = 0, s1 = 0;
#pragma unroll
  for (int s = 0; s < pa::MAX_SPLITS; ++s)
    if (s == split) s0 = splits.s[s], s1 = splits.s[s + 1];
  const int NS = s1 - s0, first = min(pa::STAGES, NS);

  if (MODE == WO) {  // the kernel before is not one of these three
    grid_dep_wait();
    grid_dep_launch();
  } else {
    grid_dep_launch();
  }
  if (tid == 0) {
    for (int s = 0; s < pa::STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < first; ++s) {
      const uint32_t bar = smem_u32(&full[s]);
      mbar_expect_tx(bar, pa::STAGE);
      post_load_w(ring + s * pa::STAGE, bar, maps, c0, c1, (s0 + s) * pa::BK);
    }
  }
  if (MODE == GATE_UP)
    for (int i = tid; i < p.K / 8; i += pa::NTH)
      reinterpret_cast<uint4*>(norm_s)[i] = reinterpret_cast<const uint4*>(p.norm)[i];
  if (MODE != WO) grid_dep_wait();  // t (gate/up) or a and t (down) are written
  if (tid == 0)
    for (int s = 0; s < first; ++s)
      post_load_act(ring + s * pa::STAGE, smem_u32(&full[s]), maps, m0, (s0 + s) * pa::BK);
  if (MODE == GATE_UP && tid < rows) {  // the column blocks' sums in order
    float ss = 0.f;
    for (int b = 0; b < p.nb; ++b) ss += p.ssq[(int64_t)(m0 + tid) * p.nb + b];
    inv[tid] = __frsqrt_rn(ss / (float)p.K + p.eps);
  }
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int i = 0; i < NS; ++i) {
    const int st = i % pa::STAGES;
    char* sp = smem + st * pa::STAGE;
    mbar_wait(smem_u32(&full[st]), (i / pa::STAGES) & 1);  // stage i has landed
    if (MODE == GATE_UP) {
      to_h(sp + 2 * pa::W_BOX, norm_s + (s0 + i) * pa::BK, inv, rows, tid);
      // the generic-proxy writes are ordered before wgmma's reads and the
      // stage's next TMA load (both the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    post_stage_mma(ring + st * pa::STAGE, acc, warp / 4);
    __syncthreads();  // every warp is done with stage i: its slot is free
    const int nx = i + pa::STAGES;
    if (tid == 0 && nx < NS) {
      const uint32_t bar = smem_u32(&full[st]);
      mbar_expect_tx(bar, pa::STAGE);
      post_load_w(ring + st * pa::STAGE, bar, maps, c0, c1, (s0 + nx) * pa::BK);
      post_load_act(ring + st * pa::STAGE, bar, maps, m0, (s0 + nx) * pa::BK);
    }
  }

  // partial tile [64 rows][128 columns] in the ring, which holds no load in
  // flight now
  float* part = reinterpret_cast<float*>(smem);
  {
    const int g = lane / 4, c = lane % 4;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // warp w's 16 columns are 16 w.. of the CTA's 128
        part[(8 * n + 2 * c + (e & 1)) * pa::PP + 16 * warp + g + 8 * (e >> 1)] = acc[4 * n + e];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in its CTA's shared memory

  // CTA `split` sums rows split, split + S, ... of the partials in split
  // order, four adjacent columns a thread, and writes them through the
  // epilogue
  const int nsum = p.fault && S > 1 ? S - 1 : S;
  const int nrows = (rows - split + S - 1) / S;
  constexpr int GROUPS = (MODE == GATE_UP ? pa::BOX : 2 * pa::BOX) / 4;
  for (int i = tid; i < nrows * GROUPS; i += pa::NTH) {
    // a warp's lanes hold the GROUPS column groups of one row, in order
    const int row = split + S * (i / GROUPS), col = 4 * (i % GROUPS);
    const int64_t o = (int64_t)(m0 + row) * p.N;
    const float4 v = cluster_sum(cluster, part + row * pa::PP + col, nsum);
    if (MODE == GATE_UP) {  // a [M, I] = round(silu(gate)) * round(up)
      const float4 u = cluster_sum(cluster, part + row * pa::PP + pa::BOX + col, nsum);
      *reinterpret_cast<uint2*>(p.out + o + c0 + col) =
          uint2{pack_bf16(swiglu(v.x, u.x), swiglu(v.y, u.y)),
                pack_bf16(swiglu(v.z, u.z), swiglu(v.w, u.w))};
      continue;
    }
    const int gc = col < pa::BOX ? c0 + col : c1 + col - pa::BOX;
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    if (gc < p.N) {
      const uint2 xr = *reinterpret_cast<const uint2*>(p.aux + o + gc);
      const float xv[4] = {__uint_as_float(xr.x << 16), __uint_as_float(xr.x & 0xFFFF0000u),
                           __uint_as_float(xr.y << 16), __uint_as_float(xr.y & 0xFFFF0000u)};
      const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)  // WO: acc = x + sum; t = x + round(acc - x)
        r[e] = round_to<__nv_bfloat16>(
            MODE == WO ? xv[e] + round_to<__nv_bfloat16>((xv[e] + sv[e]) - xv[e])
                       : xv[e] + round_to<__nv_bfloat16>(sv[e]));
      *reinterpret_cast<uint2*>(p.out + o + gc) =
          uint2{pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3])};
    }
    if (MODE == WO) {  // the RMSNorm's sum of squares of t's row in this block
      const float ss = block_ssq(r);
      if (lane == 0) p.ssq[(int64_t)(m0 + row) * p.nb + blockIdx.y] = ss;
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

// one pass: act [M, K] @ w [K, W] through the epilogue MODE into out [M, N],
// the K stages cut at bounds[0..S]
template <int MODE>
int post_pass(const void* act, const void* w, int W, const void* aux, const void* norm,
              void* out, float* ssq, int nb, int M, int N, int K, int col_step, int second,
              int n_blocks, const int* bounds, int S, float eps, int fault,
              cudaStream_t stream) {
  static SmemLimit limit;
  const int bytes = pa::BYTES + (MODE == GATE_UP ? 2 * K : 0);
  const cudaError_t e = limit.ensure((const void*)post_kernel<MODE>, bytes);
  if (e != cudaSuccess) return (int)e;
  EncodeTiled enc = encode_tiled();
  PostMaps maps;
  if (!enc ||
      !map_2d(&maps.act, enc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, act, K, M, 2 * (uint64_t)K,
              pa::BK, pa::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&maps.w, enc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, W, K, 2 * (uint64_t)W,
              pa::BOX, pa::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  PostSplits splits = {};
  for (int s = 0; s <= S; ++s) splits.s[s] = bounds[s];
  const PostArgs args{static_cast<const __nv_bfloat16*>(aux),
                      static_cast<const __nv_bfloat16*>(norm),
                      static_cast<__nv_bfloat16*>(out), ssq, nb, M, N, K, col_step, second,
                      eps, fault};
  const dim3 grid(S, n_blocks, (M + pa::BM - 1) / pa::BM);
  return (int)launch_ex(post_kernel<MODE>, grid, dim3(pa::NTH), bytes, stream, S, true, maps,
                        args, splits);
}

// the three passes (those whose bit is set in `passes`: 1 wo, 2 gate/up, 4
// down); plans[p] the stage bounds of pass p's splits, S[p] their count
int fused_post_attn_bf16(const void* x, const void* ctx, const void* wo, const void* norm,
                         const void* w_gate_up, const void* w_down, void* t, void* a,
                         float* ssq, void* out, int M, int D, int HqD, int I, float eps,
                         const int (*plans)[pa::MAX_SPLITS + 1], const int* S, int fault,
                         int passes, cudaStream_t stream) {
  const int nb = (D + 2 * pa::BOX - 1) / (2 * pa::BOX);
  int rc = 0;
  if (passes & 1)
    rc = post_pass<WO>(ctx, wo, D, x, nullptr, t, ssq, nb, M, D, HqD, 2 * pa::BOX, pa::BOX,
                       nb, plans[0], S[0], eps, fault, stream);
  // w_gate_up [D, 2, I] read as [D, 2I]: gate column i, up column I + i
  if (!rc && (passes & 2))
    rc = post_pass<GATE_UP>(t, w_gate_up, 2 * I, nullptr, norm, a, ssq, nb, M, I, D, pa::BOX,
                            I, I / pa::BOX, plans[1], S[1], eps, fault, stream);
  if (!rc && (passes & 4))
    rc = post_pass<DOWN>(a, w_down, D, t, nullptr, out, nullptr, nb, M, D, I, 2 * pa::BOX,
                         pa::BOX, nb, plans[2], S[2], eps, fault, stream);
  return rc;
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

// bf16: nsplit[3] and bounds[3][9] are the K stage plans of the wo, gate/up
// and down passes (ops/fused_block.py `launch_plan`): nsplit[p] in [1, 8],
// 0 = bounds[p][0] < ... < bounds[p][nsplit[p]] = that product's K / 64;
// fault 1 leaves each split pass's last partial out of its sum (a planted
// fault the checks must reject); passes (1 wo, 2 gate/up, 4 down) selects
// the passes launched (7: the whole call; one bit times one pass). ssq is
// f32 scratch of [M, ceil(D / 128)] (t's sums of squares by column block);
// h is unused. f32 uses h and not ssq, ignores the plans and needs fault 0
// and passes 7.
extern "C" int mdt_fused_post_attn(int dtype, const void* x, const void* ctx,
                                   const void* wo, const void* norm,
                                   const void* w_gate_up, const void* w_down, void* t,
                                   void* h, void* a, void* ssq, void* out, int M, int D,
                                   int HqD, int I, float eps, const int* nsplit,
                                   const int* bounds, int fault, int passes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D % mdt::BK || HqD % mdt::BK || I % mdt::BK)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (fault || passes != 7) return (int)cudaErrorInvalidValue;
    return mdt::fused_post_attn_f32(x, ctx, wo, norm, w_gate_up, w_down, t, h, a, out, M, D,
                                    HqD, I, eps, st);
  }
  if (dtype != 1 || passes < 1 || passes > 7) return (int)cudaErrorInvalidValue;
  constexpr int W = mdt::pa::MAX_SPLITS + 1;
  const int stages[3] = {HqD / mdt::pa::BK, D / mdt::pa::BK, I / mdt::pa::BK};
  int plans[3][W] = {};
  for (int p = 0; p < 3; ++p) {
    const int n = nsplit[p];
    if (n < 1 || n > mdt::pa::MAX_SPLITS || bounds[p * W] != 0 || bounds[p * W + n] != stages[p])
      return (int)cudaErrorInvalidValue;
    for (int s = 0; s <= n; ++s) {
      if (s > 0 && bounds[p * W + s] <= bounds[p * W + s - 1]) return (int)cudaErrorInvalidValue;
      plans[p][s] = bounds[p * W + s];
    }
  }
  return mdt::fused_post_attn_bf16(x, ctx, wo, norm, w_gate_up, w_down, t, a,
                                   static_cast<float*>(ssq), out, M, D, HqD, I, eps, plans,
                                   nsplit, fault, passes, st);
}

// The edges of a CUDA graph (a cudaGraph_t, e.g. a captured call): the
// total into *total and those of the programmatic type (programmatic
// dependent launch kept by the capture) into *programmatic. Returns the
// CUDA error code.
extern "C" int mdt_graph_edges(void* graph, int* total, int* programmatic) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  cudaError_t e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  if (e != cudaSuccess) return (int)e;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &n);
#else
  e = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n);
#endif
  if (e != cudaSuccess) return (int)e;
  int prog = 0;
  for (size_t i = 0; i < n; ++i) prog += data[i].type == cudaGraphDependencyTypeProgrammatic;
  *total = (int)n;
  *programmatic = prog;
  return 0;
}
