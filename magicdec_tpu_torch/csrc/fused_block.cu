// The fused decode block for Hopper (sm_90a): the weight products around a
// decoder layer's attention with their norms, residuals and SwiGLU.
//
//   fused_qkv:       qkv = rmsnorm(x) @ wqkv (+ bqkv)
//   fused_post_attn: t = x + ctx @ wo;  out = t + swiglu(rmsnorm(t)) @ w_down
//
// Replaces magicdec_tpu/ops/pallas/fused_block.py fused_qkv (pallas_call at
// :96) and fused_post_attn (pallas_call at :191), with their rounding points
// (fused_block.py:62-93, 116-159): RMSNorm normalizes in f32, rounds to x's
// dtype and multiplies by the norm weight in x's dtype; products sum in f32
// and round to x's dtype; the bias is added in x's dtype; t = x + round(acc -
// x) with acc = x + ctx @ wo in f32; a = round(silu(gate)) * round(up), a
// product in x's dtype; out = t + round(a @ w_down).
//
// Bound on the H100: at decode (M = 8 or 56 rows) by the weights' bytes
// (llama-3.2-1b bf16, per layer: fused_qkv 12.6 MB, 3.8 us at 3.35 TB/s;
// fused_post_attn 109 MB, 32.6 us; llama-3.1-8b: 50 MB and 386 MB). The TPU
// kernel carries t, h and the accumulator across a sequential grid; Hopper's
// CTAs run in parallel and in no order, so each pass over a weight is its
// own kernel.
//
// bf16 (block_gemm_kernel): four passes of one weight-streaming design: the
// qkv product with the RMSNorm of x folded into its operand and the bias in its
// epilogue; the wo product with the residual (t); the gate/up product with
// the RMSNorm of t folded into its operand and SwiGLU in its epilogue (a);
// the w_down product with the residual (out). A CTA of 8 warps owns 64 rows
// and 128 output columns (gate/up: 64 gate columns and the matching 64 up
// columns, I apart) and walks one split's range of 64-row K stages through a
// 4-stage ring in shared memory: one thread loads a stage by TMA (the two
// 64-column weight boxes and the activation box, each 128-byte swizzled) on
// the stage's mbarrier, so 64 KB of weight are in flight a CTA. The product
// runs transposed on wgmma m64n64k16 (f32 accumulation) with both operands
// read from the swizzled boxes: D [columns][rows] = W^T (the weight box as
// the MN-major A operand) . act^T (the activation box as the K-major B); each
// warpgroup owns one 64-column box, all 64 rows (rows past M are the TMA's
// zeros). (An mma.sync form with ldmatrix.trans, 8 warps of 16 columns that
// skipped row tiles past M, ran the gate/up pass at M = 56 in 0.0499 ms
// against 0.0324 on wgmma: PERF.md.) K is split by the wrapper's plan
// (ops/fused_block.py `launch_plan`, `qkv_plan`: from K and N alone) over a thread-block
// cluster: each CTA leaves its f32 partial tile in shared memory, and CTA r
// of the cluster sums rows r, r + S, ... of the S partials in split order
// through distributed shared memory, then applies the epilogue and rounds
// once. The RMSNorms ride on sums of squares by 128-column block (ssq, [M, D
// / 128] f32: a lane's 4 columns in order, then a butterfly over the warp):
// for fused_qkv a small kernel (ssq_kernel, a warp a row and block) takes
// x's before the product, for fused_post_attn the wo epilogue leaves t's.
// Each normed CTA sums a row's blocks in order, takes the inverse RMS, and
// turns each stage's activation box into h = round(round(x * inv) * w) in
// place before its product. The order depends on D alone, so every CTA forms
// the same h at any M, and no h buffer remains. (Each gate/up CTA reading
// its rows of t whole took 24 us more than the pass's bytes at M = 56:
// PERF.md.) The launches use programmatic dependent launch: the ssq and wo
// kernels (whose kernel before is another call's) wait (griddepcontrol.wait)
// before they read or write anything; the ssq kernel lets the qkv product
// start at once, the wo kernel lets gate/up start after its wait; the qkv,
// gate/up and down kernels let the next kernel start at once, fetch their
// first weight stages (which no kernel of the call writes), then wait before
// they read their activation or sums of squares. Two CTAs fit an SM (~97 KB
// of shared memory each, <= 128 registers a thread), so a dependent CTA
// fills its ring beside a running one. Nothing of the launch but the number
// of 64-row tiles is chosen from M, and those run one after another within
// a column block in launch order (so a verify's tiles share each weight box
// in L2); a row's products never mix with another row's, so a row's bits do
// not depend on how many rows share the call.
//
// f32 (the exact checks): the first port's kernels. One GEMM kernel, a CTA of
// 4 warps per 64 rows and two 16-column blocks of the weight, K walked in
// order through a cp.async ring of 64-row stages on CUDA cores (a thread one
// column of 16 rows, sequential FMAs); the RMSNorm its own kernel (one CTA a
// row, a fixed order). fused_qkv issues two kernels (the RMSNorm, the product
// with the bias in its epilogue), fused_post_attn four (wo, the RMSNorm of t,
// gate/up, w_down).
#include <cooperative_groups.h>

#include <vector>

#include "mma.cuh"
#include "tma.cuh"

namespace mdt {

constexpr int BK = 64;  // K rows per stage (both designs)

enum Epilogue { QKV = 0, WO = 1, GATE_UP = 2, DOWN = 3 };

// ---------------------------------------------------------------------------
// f32: the exact checks' kernels
// ---------------------------------------------------------------------------

namespace f32 {
constexpr int BM = 64;                       // rows per CTA
constexpr int HALF = 16;                     // columns per column block (two per CTA)
constexpr int NTH = 128;                     // threads per GEMM CTA
constexpr int NORM_THREADS = 256;
constexpr int STAGES = 2;
constexpr int VEC = 4;                       // floats per 16 bytes
constexpr int AP = BK + VEC;                 // A row pitch (floats)
constexpr int WP = 2 * HALF + VEC;           // W row pitch (floats)
constexpr int A_BYTES = BM * AP * 4;
constexpr int W_BYTES = BK * WP * 4;
constexpr int STAGE = A_BYTES + W_BYTES;     // a multiple of 16
constexpr int CP = 2 * HALF + 1;             // accumulator tile pitch (floats)
constexpr int BYTES = STAGES * STAGE + BM * CP * 4;
}  // namespace f32

struct GemmArgs {
  const float* a;    // [M, K], row stride lda
  const float* w;    // [K, ldw]
  const float* aux;  // QKV: bias [N] or null; WO: x [M, N]; DOWN: t [M, N]
  float* out;        // [M, ldo]
  int M, K, lda, ldw, ldo;
  int cstep;         // columns between the c0 of neighbouring CTAs
  int pair;          // c1 - c0
  int mode;          // Epilogue
};

__device__ __forceinline__ void load_stage(char* st, const GemmArgs& p, int m0, int c0, int c1,
                                           int kc, int tid) {
  using namespace f32;
  float* sa = reinterpret_cast<float*>(st);
  float* sw = reinterpret_cast<float*>(st + A_BYTES);
  constexpr int CPR = BK / VEC;    // 16-byte chunks per A row
  constexpr int CPH = HALF / VEC;  // 16-byte chunks per column block row
  const int k0 = kc * BK;
  for (int i = tid; i < BM * CPR; i += NTH) {
    const int r = i / CPR, cc = i % CPR;
    const bool ok = m0 + r < p.M;
    const float* src = ok ? p.a + (int64_t)(m0 + r) * p.lda + k0 + cc * VEC : p.a;
    cp_async16(sa + r * AP + cc * VEC, src, ok);
  }
  for (int i = tid; i < BK * 2 * CPH; i += NTH) {
    const int k = i / (2 * CPH), blk = (i / CPH) % 2, cc = i % CPH;
    const int cb = blk ? c1 : c0;
    const bool ok = cb < p.ldw;
    const float* src = ok ? p.w + (int64_t)(k0 + k) * p.ldw + cb + cc * VEC : p.w;
    cp_async16(sw + k * WP + blk * HALF + cc * VEC, src, ok);
  }
}

// acc[r] += sum_k A[16 * (t / 32) + r][k] W[k][t % 32], CUDA cores
__device__ __forceinline__ void stage_f32(const char* st, float (&acc)[16], int tid) {
  using namespace f32;
  const float* sa = reinterpret_cast<const float*>(st);
  const float* sw = reinterpret_cast<const float*>(st + A_BYTES);
  const int j = tid % 32, r0 = (tid / 32) * 16;
  for (int k = 0; k < BK; ++k) {
    const float w = sw[k * WP + j];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = fmaf(sa[(r0 + r) * AP + k], w, acc[r]);
  }
}

// grid (column blocks, ceil(M / 64)), f32::NTH threads, f32::BYTES of
// dynamic shared memory
__global__ void __launch_bounds__(f32::NTH) gemm_kernel(const GemmArgs p) {
  using namespace f32;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, m0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * p.cstep, c1 = c0 + p.pair;
  const int NK = p.K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < NK) load_stage(smem + s * STAGE, p, m0, c0, c1, s, tid);
    cp_async_commit();
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < NK; ++kc) {
    cp_async_wait<STAGES - 2>();  // stage kc has landed
    __syncthreads();              // ... for every thread; kc - 1 is consumed
    const int nx = kc + STAGES - 1;
    if (nx < NK) load_stage(smem + (nx % STAGES) * STAGE, p, m0, c0, c1, nx, tid);
    cp_async_commit();
    stage_f32(smem + (kc % STAGES) * STAGE, acc, tid);
  }
  cp_async_wait<0>();

  // accumulators -> shared tile [64][32] (column j < 16: block c0, else c1)
  float* cs = reinterpret_cast<float*>(smem + STAGES * STAGE);
  {
    const int j = tid % 32, r0 = (tid / 32) * 16;
#pragma unroll
    for (int r = 0; r < 16; ++r) cs[(r0 + r) * CP + j] = acc[r];
  }
  __syncthreads();

  if (p.mode == GATE_UP) {  // out [M, I] = silu(gate) * up
    for (int i = tid; i < BM * HALF; i += NTH) {
      const int r = i / HALF, j = i % HALF, row = m0 + r;
      if (row >= p.M) continue;
      const float gate = cs[r * CP + j], up = cs[r * CP + HALF + j];
      const float silu = (1.f / (1.f + expf(-gate))) * gate;
      p.out[(int64_t)row * p.ldo + c0 + j] = silu * up;
    }
    return;
  }
  for (int i = tid; i < BM * 2 * HALF; i += NTH) {
    const int r = i / (2 * HALF), j = i % (2 * HALF), row = m0 + r;
    const int col = j < HALF ? c0 + j : c1 + j - HALF;
    if (row >= p.M || col >= p.ldw) continue;
    const float acc_v = cs[r * CP + j];
    float v;
    if (p.mode == QKV) {
      v = acc_v;
      if (p.aux) v += p.aux[col];
    } else if (p.mode == WO) {  // acc = x + ctx @ wo; t = x + (acc - x)
      const float x = p.aux[(int64_t)row * p.ldo + col];
      v = x + ((x + acc_v) - x);
    } else {                    // DOWN: out = t + a @ w_down
      v = p.aux[(int64_t)row * p.ldo + col] + acc_v;
    }
    p.out[(int64_t)row * p.ldo + col] = v;
  }
}

// h[r] = x[r] * rsqrt(mean(x[r]^2) + eps) * w, one CTA per row; the sum of
// squares runs in a fixed order (strided per thread, then a fixed shuffle
// tree and the warps' partial sums in order)
__global__ void __launch_bounds__(f32::NORM_THREADS)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ h,
               int D, float eps) {
  constexpr int NT = f32::NORM_THREADS;
  __shared__ float part[NT / 32];
  const float* xr = x + (int64_t)blockIdx.x * D;
  float* hr = h + (int64_t)blockIdx.x * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float v = xr[i];
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) total += part[i];
  const float inv = __frsqrt_rn(total / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += NT) hr[i] = xr[i] * inv * w[i];
}

int gemm(const GemmArgs& p, int n_blocks, cudaStream_t stream) {
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)gemm_kernel, f32::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_blocks, (p.M + f32::BM - 1) / f32::BM);
  gemm_kernel<<<grid, f32::NTH, f32::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

int rmsnorm(const void* x, const void* w, void* h, int M, int D, float eps,
            cudaStream_t stream) {
  rmsnorm_kernel<<<M, f32::NORM_THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(h), D,
      eps);
  return (int)cudaGetLastError();
}

int fused_qkv_f32(const void* x, const void* norm, const void* w, const void* bias, void* h,
                  void* out, int M, int D, int O, float eps, cudaStream_t stream) {
  using namespace f32;
  const int rc = rmsnorm(x, norm, h, M, D, eps, stream);
  if (rc) return rc;
  const GemmArgs p{static_cast<const float*>(h), static_cast<const float*>(w),
                   static_cast<const float*>(bias), static_cast<float*>(out),
                   M, D, D, O, O, 2 * HALF, HALF, QKV};
  return gemm(p, (O + 2 * HALF - 1) / (2 * HALF), stream);
}

int fused_post_attn_f32(const void* x, const void* ctx, const void* wo, const void* norm,
                        const void* w_gate_up, const void* w_down, void* t, void* h, void* a,
                        void* out, int M, int D, int HqD, int I, float eps,
                        cudaStream_t stream) {
  using namespace f32;
  using T = float;
  int rc;
  const GemmArgs p_wo{static_cast<const T*>(ctx), static_cast<const T*>(wo),
                      static_cast<const T*>(x), static_cast<T*>(t),
                      M, HqD, HqD, D, D, 2 * HALF, HALF, WO};
  if ((rc = gemm(p_wo, (D + 2 * HALF - 1) / (2 * HALF), stream))) return rc;
  if ((rc = rmsnorm(t, norm, h, M, D, eps, stream))) return rc;
  // w_gate_up [D, 2, I] read as [D, 2I]: gate column i, up column I + i
  const GemmArgs p_gu{static_cast<const T*>(h), static_cast<const T*>(w_gate_up),
                      nullptr, static_cast<T*>(a),
                      M, D, D, 2 * I, I, HALF, I, GATE_UP};
  if ((rc = gemm(p_gu, I / HALF, stream))) return rc;
  const GemmArgs p_down{static_cast<const T*>(a), static_cast<const T*>(w_down),
                        static_cast<const T*>(t), static_cast<T*>(out),
                        M, I, I, D, D, 2 * HALF, HALF, DOWN};
  return gemm(p_down, (D + 2 * HALF - 1) / (2 * HALF), stream);
}

// ---------------------------------------------------------------------------
// bf16: TMA weight streaming, K split over a cluster
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
constexpr int BYTES = RING + 1024;        // + the base's alignment (normed: + the norm)
constexpr int PP = 2 * BOX + 4;           // the partial tile's row pitch, f32
static_assert(BM * PP * 4 <= RING, "the partial tile reuses the ring");
constexpr int SSQ_THREADS = 256;          // ssq_kernel: a warp a (row, column block)
}  // namespace pa

// the passes whose activation box is turned into h = rmsnorm(act) in place
__host__ __device__ constexpr bool normed(int mode) { return mode == QKV || mode == GATE_UP; }

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
  const __nv_bfloat16* aux;   // QKV: the bias [N] or null; WO: x [M, N]; DOWN: t [M, N]
  const __nv_bfloat16* norm;  // QKV, GATE_UP: the norm weight [K]
  __nv_bfloat16* out;         // [M, N]: qkv, t, a or out
  float* ssq;                 // [M, nb]: the normed activation's sums of squares by
                              // column block (QKV reads x's, which ssq_kernel
                              // writes; WO writes t's, GATE_UP reads them)
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

// a stage's weight boxes (columns c0.. and, with two, c1..; K rows k0..)
// and its activation box (rows m0.., k0..), completing on the stage's
// barrier
__device__ __forceinline__ void post_load_w(uint32_t st, uint32_t bar, const PostMaps& maps,
                                            int c0, int c1, bool two, int k0) {
  tma_2d(st, &maps.w, bar, c0, k0);
  if (two) tma_2d(st + pa::W_BOX, &maps.w, bar, c1, k0);
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

// grid (S, ceil(M / 64), column blocks), clusters of (S, 1, 1), pa::NTH
// threads, pa::BYTES (+ 2 K for the normed passes) of dynamic shared memory.
// The row tile runs faster than the column block in launch order, so the
// row tiles of one column block are resident together and stream its weight
// boxes through L2 once: a verify's or a tree verify's rows read the weight
// from HBM about once, not once a row tile.
template <int MODE>
__global__ void __launch_bounds__(pa::NTH, 2)
block_gemm_kernel(const __grid_constant__ PostMaps maps, const PostArgs p,
                  const PostSplits splits) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ __align__(8) uint64_t full[pa::STAGES];
  __shared__ float inv[pa::BM];
  char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t ring = smem_u32(smem);
  __nv_bfloat16* norm_s = reinterpret_cast<__nv_bfloat16*>(smem + pa::RING);
  const int S = gridDim.x, split = blockIdx.x;
  const int block = blockIdx.z;  // the column block
  const int c0 = block * p.col_step, c1 = c0 + p.second, m0 = blockIdx.y * pa::BM;
  const int rows = min(pa::BM, p.M - m0);  // rows of this tile that exist (>= 1)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the split's stages, read by constant index (a dynamic index into the
  // parameter block would go through local memory)
  int s0 = 0, s1 = 0;
#pragma unroll
  for (int s = 0; s < pa::MAX_SPLITS; ++s)
    if (s == split) s0 = splits.s[s], s1 = splits.s[s + 1];
  const int NS = s1 - s0, first = min(pa::STAGES, NS);
  // the second weight box lies inside the weight (gate/up: always)
  const bool two = MODE == GATE_UP || c1 < p.N;
  const uint32_t tx = two ? pa::STAGE : pa::STAGE - pa::W_BOX;

  if (MODE == WO) {  // the kernel before is another call's
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
      mbar_expect_tx(bar, tx);
      post_load_w(ring + s * pa::STAGE, bar, maps, c0, c1, two, (s0 + s) * pa::BK);
    }
  }
  if (normed(MODE))
    for (int i = tid; i < p.K / 8; i += pa::NTH)
      reinterpret_cast<uint4*>(norm_s)[i] = reinterpret_cast<const uint4*>(p.norm)[i];
  // x's sums of squares (qkv), t (gate/up), or a and t (down) are written
  if (MODE != WO) grid_dep_wait();
  if (tid == 0)
    for (int s = 0; s < first; ++s)
      post_load_act(ring + s * pa::STAGE, smem_u32(&full[s]), maps, m0, (s0 + s) * pa::BK);
  if (normed(MODE) && tid < rows) {  // the column blocks' sums in order
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
    if (normed(MODE)) {
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
      mbar_expect_tx(bar, tx);
      post_load_w(ring + st * pa::STAGE, bar, maps, c0, c1, two, (s0 + nx) * pa::BK);
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
    if (MODE == QKV) {  // qkv = round(sum) (+ bias, a sum in bf16)
      if (gc >= p.N) continue;
      const float sv[4] = {v.x, v.y, v.z, v.w};
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = round_to<__nv_bfloat16>(sv[e]);
      if (p.aux) {
        const uint2 br = *reinterpret_cast<const uint2*>(p.aux + gc);
        r[0] += __uint_as_float(br.x << 16), r[1] += __uint_as_float(br.x & 0xFFFF0000u);
        r[2] += __uint_as_float(br.y << 16), r[3] += __uint_as_float(br.y & 0xFFFF0000u);
      }
      *reinterpret_cast<uint2*>(p.out + o + gc) =
          uint2{pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3])};
      continue;
    }
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
      if (lane == 0) p.ssq[(int64_t)(m0 + row) * p.nb + block] = ss;
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

// ssq [M, nb] = the sums of squares of x [M, D] by 128-column block, each by
// block_ssq (the order the wo epilogue sums t's in): a warp a (row, block),
// lane l columns 4 l .. 4 l + 3 of the block. The kernel before is another
// call's, so it waits before it reads x or writes ssq; the product may start
// at once (it fetches weights only before its own wait).
__global__ void __launch_bounds__(pa::SSQ_THREADS)
ssq_kernel(const __nv_bfloat16* x, float* ssq, int M, int D, int nb) {
  grid_dep_launch();
  grid_dep_wait();
  const int w = blockIdx.x * (pa::SSQ_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= M * nb) return;  // a whole warp
  const int row = w / nb, col = 2 * pa::BOX * (w % nb) + 4 * lane;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < D) {
    const uint2 xr = *reinterpret_cast<const uint2*>(x + (int64_t)row * D + col);
    v[0] = __uint_as_float(xr.x << 16), v[1] = __uint_as_float(xr.x & 0xFFFF0000u);
    v[2] = __uint_as_float(xr.y << 16), v[3] = __uint_as_float(xr.y & 0xFFFF0000u);
  }
  const float ss = block_ssq(v);
  if (lane == 0) ssq[w] = ss;
}

// one pass: act [M, K] @ w [K, W] through the epilogue MODE into out [M, N],
// the K stages cut at bounds[0..S]
template <int MODE>
int block_gemm_pass(const void* act, const void* w, int W, const void* aux, const void* norm,
                    void* out, float* ssq, int nb, int M, int N, int K, int col_step,
                    int second, int n_blocks, const int* bounds, int S, float eps, int fault,
                    cudaStream_t stream) {
  static SmemLimit limit;
  const int bytes = pa::BYTES + (normed(MODE) ? 2 * K : 0);
  const cudaError_t e = limit.ensure((const void*)block_gemm_kernel<MODE>, bytes);
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
  const dim3 grid(S, (M + pa::BM - 1) / pa::BM, n_blocks);
  return (int)launch_ex(block_gemm_kernel<MODE>, grid, dim3(pa::NTH), bytes, stream, S, true,
                        maps, args, splits);
}

// the two kernels (those whose bit is set in `passes`: 1 the sums of
// squares, 2 the product); bounds the stage bounds of the product's S splits
int fused_qkv_bf16(const void* x, const void* norm, const void* w, const void* bias,
                   float* ssq, void* out, int M, int D, int O, float eps, const int* bounds,
                   int S, int fault, int passes, cudaStream_t stream) {
  const int nb = (D + 2 * pa::BOX - 1) / (2 * pa::BOX);
  if (passes & 1) {
    constexpr int WARPS = pa::SSQ_THREADS / 32;
    const cudaError_t e = launch_ex(ssq_kernel, dim3((M * nb + WARPS - 1) / WARPS),
                                    dim3(pa::SSQ_THREADS), 0, stream, 1, true,
                                    static_cast<const __nv_bfloat16*>(x), ssq, M, D, nb);
    if (e != cudaSuccess) return (int)e;
  }
  if (!(passes & 2)) return 0;
  return block_gemm_pass<QKV>(x, w, O, bias, norm, out, ssq, nb, M, O, D, 2 * pa::BOX,
                              pa::BOX, (O + 2 * pa::BOX - 1) / (2 * pa::BOX), bounds, S, eps,
                              fault, stream);
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
    rc = block_gemm_pass<WO>(ctx, wo, D, x, nullptr, t, ssq, nb, M, D, HqD, 2 * pa::BOX,
                             pa::BOX, nb, plans[0], S[0], eps, fault, stream);
  // w_gate_up [D, 2, I] read as [D, 2I]: gate column i, up column I + i
  if (!rc && (passes & 2))
    rc = block_gemm_pass<GATE_UP>(t, w_gate_up, 2 * I, nullptr, norm, a, ssq, nb, M, I, D,
                                  pa::BOX, I, I / pa::BOX, plans[1], S[1], eps, fault, stream);
  if (!rc && (passes & 4))
    rc = block_gemm_pass<DOWN>(a, w_down, D, t, nullptr, out, nullptr, nb, M, D, I, 2 * pa::BOX,
                               pa::BOX, nb, plans[2], S[2], eps, fault, stream);
  return rc;
}

// the stage bounds of a K split plan of n splits over `stages` stages,
// copied into out[0..n]: false unless 1 <= n <= MAX_SPLITS and 0 = bounds[0]
// < ... < bounds[n] = stages
bool read_plan(const int* bounds, int n, int stages, int* out) {
  if (n < 1 || n > pa::MAX_SPLITS || bounds[0] != 0 || bounds[n] != stages) return false;
  for (int s = 0; s <= n; ++s) {
    if (s > 0 && bounds[s] <= bounds[s - 1]) return false;
    out[s] = bounds[s];
  }
  return true;
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16 (every operand).
// Contraction lengths (D, HqD, I) multiples of 64, output widths multiples of
// 16; contiguous, 16-byte aligned operands. Plans (bf16): nsplit in [1, 8]
// and bounds [nsplit + 1] with 0 = bounds[0] < ... < bounds[nsplit] = the
// product's K / 64 (ops/fused_block.py `launch_plan`, `qkv_plan`); fault 1 leaves the
// last split's partial out of each split product's sum (a planted fault the
// checks must reject). Each returns the CUDA error code of its launches.

// bf16: ssq is f32 scratch of [M, ceil(D / 128)] (x's sums of squares by
// column block); passes (1 the sums of squares, 2 the product) selects the
// kernels launched (3: the whole call); h is unused. f32: h is scratch of
// [M, D], ssq and the plan are unused, fault 0 and passes 3.
extern "C" int mdt_fused_qkv(int dtype, const void* x, const void* norm, const void* w,
                             const void* bias, void* h, void* ssq, void* out, int M, int D,
                             int O, float eps, int nsplit, const int* bounds, int fault,
                             int passes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D % mdt::BK || O % 16) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (fault || passes != 3) return (int)cudaErrorInvalidValue;
    return mdt::fused_qkv_f32(x, norm, w, bias, h, out, M, D, O, eps, st);
  }
  int plan[mdt::pa::MAX_SPLITS + 1];
  if (dtype != 1 || passes < 1 || passes > 3 || !mdt::read_plan(bounds, nsplit, D / mdt::BK, plan))
    return (int)cudaErrorInvalidValue;
  return mdt::fused_qkv_bf16(x, norm, w, bias, static_cast<float*>(ssq), out, M, D, O, eps,
                             plan, nsplit, fault, passes, st);
}

// bf16: nsplit[3] and bounds[3][9] are the plans of the wo, gate/up and down
// products; passes (1 wo, 2 gate/up, 4 down) selects the passes launched (7:
// the whole call; one bit times one pass). ssq is f32 scratch of [M, ceil(D
// / 128)] (t's sums of squares by column block); h is unused. f32: t, h and a
// are scratch of [M, D], [M, D], [M, I]; ssq and the plans are unused, fault
// 0 and passes 7.
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
  for (int p = 0; p < 3; ++p)
    if (!mdt::read_plan(bounds + p * W, nsplit[p], stages[p], plans[p]))
      return (int)cudaErrorInvalidValue;
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
