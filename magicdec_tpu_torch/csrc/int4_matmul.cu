// int4_matmul for Hopper (sm_90a): out [M, N] = x [M, K] @ W, W an int4
// weight packed as biased column-pair nibbles with one f32 scale per 128-row
// group of K and output column.
//
// Replaces magicdec_tpu/ops/pallas/int4_matmul.py int4_matmul (pallas_call at
// :131). What it computes (int4_matmul.py:60-99): byte q4[k, n] holds column n
// in its low nibble and column n + N/2 in its high one, each the code q + 8 in
// [0, 15]; per 128-row group g of K the product is s_g * (x_g . (Qu_g - 8)),
// summed over the groups in f32 and rounded once to x's dtype. The TPU
// kernel's tiling (n_block/k_block, the interleaved scale rows, the
// split-halves output and its concatenate) is not carried over: the kernel
// writes [M, N] directly.
//
// Bound on the H100: by the packed weight's bytes, K*N/2 + 4*K*N/128, at up
// to ~64 rows (llama-3.2-1b w_gate_up: 17.8 MB, 5.3 us at 3.35 TB/s), and by
// the tensor cores' 2*M*K*N operations from about 128 rows on: the decode
// buckets the model pads to (256 rows at B=8, 512 at B=16) and the 1024-row
// prefill chunks.
//
// bf16 x (int4_bf16_kernel). A CTA of 8 warps (two warpgroups) owns 64
// rows and 128 packed columns, both nibble halves (256 outputs), and walks
// one split's range of K groups through a ring of STAGES groups in shared
// memory. One thread fills a stage with four TMA loads on the stage's
// mbarrier: the x tile (loaded once and used for all 256 outputs) and the
// q4 tile, both 128-byte swizzled, and the 256 scales. A stage is refilled
// as soon as both warpgroups are done with it, so STAGES groups are in
// flight without spending registers or instructions per byte.
// The product runs transposed on wgmma (m64n64k16, f32 accumulation):
// D [outputs][rows] = A (the weight, dequantized in registers) . B (the x
// tile, read by the tensor cores from shared memory in the TMA's swizzled
// layout). Each warpgroup owns two of the CTA's four 64-output tiles. The
// weight is unpacked from 32-bit shared loads with bit arithmetic: prmt
// pairs the bytes of rows k and k + 1 of one packed column, a mask keeps a
// nibble in each half, OR-ing in 0x4300 makes the bf16 128 + nibble, and
// one bf16x2 fma subtracts 136: the signed code q - 8 in [-8, 7], exact in
// bf16, so there is no row-sum term. One 32-bit load per row of k serves a
// lane's four packed columns, whose low and high nibbles are the A rows g
// and g + 8 of the four tiles. The A registers of two k16 steps alternate,
// so a step's unpack overlaps the previous step's wgmma. Each group's
// product is kept apart in f32 and folded as acc += s_g * p once per group.
//
// Splits: the K groups are cut into S contiguous ranges (S from K and N/2
// only, by the wrapper's launch plan, ops/int4_matmul.py `launch_plan`),
// one CTA each, the S CTAs of a column block and row tile forming one
// thread-block cluster. Each CTA leaves its f32 partial tile in its shared
// memory; after a cluster barrier CTA r sums the rows r, r + S, ... of all S
// partials in split order 0..S-1 through distributed shared memory, rounds
// once and writes them. Nothing of the launch (tile, splits, order) is
// chosen from M, and a row's products never mix with another row's, so a
// row's bits do not depend on how many rows share the call. Rows past M and
// packed columns past N/2 arrive from the TMA as zeros without being read;
// the m16 tiles past M are skipped and the columns past N/2 not written.
//
// f32 x (int4_f32_kernel, the exact checks): CUDA cores, one CTA of 4 warps
// per (64 rows, 16 packed columns = 32 outputs) walking all of K in order;
// each thread one output column of 16 rows, sequential f32 FMAs, each group
// as s_g * (x_g . Qu_g - 8 * rowsum(x_g)).
#include <cooperative_groups.h>

#include "mma.cuh"
#include "tma.cuh"

namespace mdt {

constexpr int GROUP = 128;  // K rows per scale group

// ---------------------------------------------------------------------------
// bf16 x: tensor cores, split K over a thread-block cluster
// ---------------------------------------------------------------------------

namespace i4 {
constexpr int BM = 64;                 // rows per CTA
constexpr int BN2 = 128;               // packed columns per CTA (256 outputs)
constexpr int WARPS = 8;
constexpr int NTH = 32 * WARPS;
constexpr int STAGES = 5;              // groups in the ring
constexpr int MAX_SPLITS = 8;          // the portable cluster size
// a stage: the x tile as two 128-byte-swizzled boxes [64 rows][64 k], the q4
// tile as one 128-byte-swizzled box [128 k][128 bytes], and the scales
// [2 halves][128] (dense); each box 1024-byte aligned, as the swizzle needs
constexpr int X_BOX = BM * 128;        // bytes of one x box
constexpr int X_BYTES = 2 * X_BOX;
constexpr int Q_BYTES = GROUP * BN2;
constexpr int S_BYTES = 2 * BN2 * 4;
constexpr int TX = X_BYTES + Q_BYTES + S_BYTES;      // bytes a stage receives
constexpr int STAGE = (TX + 1023) / 1024 * 1024;
constexpr int BYTES = STAGES * STAGE + 1024;        // + the base's alignment
constexpr int PP = 2 * BN2 + 4;        // the partial tile's row pitch, f32
static_assert(BM * PP * 4 <= STAGES * STAGE, "the partial tile reuses the ring");
}  // namespace i4

// group boundaries of the splits: split s walks groups [g[s], g[s + 1])
struct Splits {
  int g[i4::MAX_SPLITS + 1];
};

// the TMA's views: x [M, K] bf16 in boxes of [64 rows][64 k]; q4 [K, N2]
// bytes in boxes of [128 k][128 bytes]; s4 as [2 G, N2] f32 (row 2 g the
// low nibbles' scales of group g, 2 g + 1 the high ones') in boxes of
// [2][128]. Rows past M and columns past N2 arrive as zeros.
struct Maps {
  CUtensorMap x, q4, s4;
};

// stage <- group gi (one thread): x rows [m0, m0 + 64), q4 rows of the group
// at packed columns [n0, n0 + 128), and the group's 2 x 128 scales
__device__ __forceinline__ void load_bf16_stage(uint32_t st, uint32_t bar, const Maps& maps,
                                                int m0, int n0, int gi) {
  using namespace i4;
  mbar_expect_tx(bar, TX);
  tma_2d(st, &maps.x, bar, gi * GROUP, m0);
  tma_2d(st + X_BOX, &maps.x, bar, gi * GROUP + 64, m0);
  tma_2d(st + X_BYTES, &maps.q4, bar, n0, gi * GROUP);
  tma_2d(st + X_BYTES + Q_BYTES, &maps.s4, bar, n0, 2 * gi);
}

// byte t of a (row k) and byte t of b (row k + 1) side by side, as bytes 0
// and 2; sel = pair_sel(t)
__device__ __forceinline__ uint32_t pair_sel(int t) {
  return t | (t << 4) | ((t + 4) << 8) | ((t + 4) << 12);
}
__device__ __forceinline__ uint32_t byte_pair(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t u;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(u) : "r"(a), "r"(b), "r"(sel));
  return u;
}

// the low nibbles of bytes 0 and 2 as the bf16x2 signed codes (q - 8):
// (u & 0x000F000F) | 0x43004300 is the bf16 128 + v twice, exact, in one
// lop3 (both constants in registers: a lop3 takes one immediate), and the
// fma subtracts 136 exactly
__device__ __forceinline__ uint32_t signed_codes(uint32_t u) {
  uint32_t v, r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(v) : "r"(u), "r"(0x000F000Fu), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(v), "r"(0x3F803F80u) /* 1, 1 */, "r"(0xC308C308u) /* -136, -136 */);
  return r;
}

// the 32-bit word at byte b (a multiple of 4) of row k of the swizzled q4
// tile: 16-byte chunk j of row k sits at chunk j ^ (k % 8)
__device__ __forceinline__ uint32_t q4_word(const uint8_t* qs, int k, int b) {
  return *reinterpret_cast<const uint32_t*>(qs + k * i4::BN2 +
                                            ((((b >> 4) ^ k) & 7) << 4) + (b & 15));
}

// d (+)= a . b for a 64 x 16 A in registers (bf16, mma.m16n8k16's A layout,
// warp w of the warpgroup rows 16 w..) and a 16 x 64 B in shared memory
// (K-major, desc); scale_d = 0 starts a new sum
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keep r in its register up to here (the compiler sees a use and a new value)
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// acc += s_g * ((q_g - 8) . x_g) for this warpgroup's two m64 tiles, the
// product transposed: D [64 outputs][64 rows] = A (the weight, from
// registers) . B (the x tile, from shared memory). Lane (g, c) of warp w
// of warpgroup j holds A rows g and g + 8 of tile t (t = 2j, 2j + 1): the
// low and the high nibble of packed column 32 w + 4 g + t, both from the
// same bytes. acc[i][4 n + e] is D element (row 16 w + g + 8 (e / 2),
// column 8 n + 2 c + e % 2) of tile 2j + i.
__device__ __forceinline__ void bf16_group(const char* st, uint32_t st_u32,
                                           float (&acc)[2][32], int wg, int warp, int lane) {
  using namespace i4;
  const uint8_t* qs = reinterpret_cast<const uint8_t*>(st + X_BYTES);
  const float* ss = reinterpret_cast<const float*>(st + X_BYTES + Q_BYTES);
  const int g = lane / 4, c = lane % 4, w = warp % 4, qb = 32 * w + 4 * g;
  const uint32_t sel[2] = {pair_sel(2 * wg), pair_sel(2 * wg + 1)};
  float p[2][32];
  uint32_t a[2][2][4];  // [buffer][tile][fragment register]
#pragma unroll
  for (int ks = 0; ks < GROUP / 16; ++ks) {
    const int k = ks * 16 + 2 * c, buf = ks % 2;
    const uint32_t w0 = q4_word(qs, k, qb), w1 = q4_word(qs, k + 1, qb);
    const uint32_t w2 = q4_word(qs, k + 8, qb), w3 = q4_word(qs, k + 9, qb);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t u01 = byte_pair(w0, w1, sel[i]), u23 = byte_pair(w2, w3, sel[i]);
      a[buf][i][0] = signed_codes(u01);
      a[buf][i][1] = signed_codes(u01 >> 4);
      a[buf][i][2] = signed_codes(u23);
      a[buf][i][3] = signed_codes(u23 >> 4);
    }
    // B: k 16 ks.. of the x tile, in box ks / 4 at 32 (ks % 4) bytes
    const uint64_t desc = desc_sw128(st_u32 + (ks / 4) * X_BOX + (ks % 4) * 32);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i) wgmma_rs(p[i], a[buf][i], desc, ks > 0);
    wgmma_commit();
    if (ks > 0) {
      wgmma_wait<1>();  // step ks - 1 is done: its A registers may be rewritten
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(a[1 - buf][i][r]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) reg_fence(a[1][i][r]);
#pragma unroll
    for (int e = 0; e < 32; ++e) reg_fence(p[i][e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * wg + i;
    const float s_lo = ss[qb + t], s_hi = ss[BN2 + qb + t];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[i][4 * n + 0] += p[i][4 * n + 0] * s_lo;
      acc[i][4 * n + 1] += p[i][4 * n + 1] * s_lo;
      acc[i][4 * n + 2] += p[i][4 * n + 2] * s_hi;
      acc[i][4 * n + 3] += p[i][4 * n + 3] * s_hi;
    }
  }
}

// grid (S, ceil(N2 / 128), ceil(M / 64)), clusters of (S, 1, 1), NTH threads,
// i4::BYTES of dynamic shared memory
__global__ void __launch_bounds__(i4::NTH, 1)
int4_bf16_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ out, int M,
                 int N2, Splits splits) {
  using namespace i4;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t ring = smem_u32(smem);
  const int S = gridDim.x, split = blockIdx.x;
  const int n0 = blockIdx.y * BN2, m0 = blockIdx.z * BM, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = M - m0;  // rows of this tile that exist (>= 1)
  // the split's groups, read by constant index (a dynamic index into the
  // parameter block would go through local memory)
  int g0 = 0, g1 = 0;
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    if (s == split) g0 = splits.g[s], g1 = splits.g[s + 1];
  const int NG = g1 - g0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < NG; ++s)
      load_bf16_stage(ring + s * STAGE, smem_u32(&full[s]), maps, m0, n0, g0 + s);
  }
  __syncthreads();
  const int wg = warp / 4;
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  for (int gi = 0; gi < NG; ++gi) {
    const int st = gi % STAGES;
    mbar_wait(smem_u32(&full[st]), (gi / STAGES) & 1);  // group gi has landed
    bf16_group(smem + st * STAGE, ring + st * STAGE, acc, wg, warp, lane);
    __syncthreads();  // every warpgroup is done with group gi: its stage is free
    const int nx = gi + STAGES;
    if (tid == 0 && nx < NG)
      load_bf16_stage(ring + st * STAGE, smem_u32(&full[st]), maps, m0, n0, g0 + nx);
  }

  // partial tile [64 rows][256 outputs: low nibbles' 128, then high], in
  // the ring, which holds no load in flight now
  float* part = reinterpret_cast<float*>(smem);
  {
    const int g = lane / 4, c = lane % 4, w = warp % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = 8 * (e / 4) + 2 * c + e % 2;
        const int col = ((e / 2) % 2) * BN2 + 32 * w + 4 * g + 2 * wg + i;
        part[row * PP + col] = acc[i][e];
      }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in its CTA's shared memory

  // CTA `split` sums rows split, split + S, ... of the S partials in split
  // order; each thread 4 adjacent outputs of a row at a time
  const int64_t N = 2 * (int64_t)N2;
  const int nrows = (BM - split + S - 1) / S;
  for (int i = tid; i < nrows * (2 * BN2 / 4); i += NTH) {
    const int row = split + S * (i / (2 * BN2 / 4)), col = 4 * (i % (2 * BN2 / 4));
    const int half = col / BN2, pc = n0 + col % BN2;
    if (row >= rows || pc >= N2) continue;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part + row * PP + col, 0));
    for (int s = 1; s < S; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part + row * PP + col, s));
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    uint2 packed = {pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w)};
    *reinterpret_cast<uint2*>(out + (int64_t)(m0 + row) * N + half * N2 + pc) = packed;
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

int launch_bf16(const void* x, const void* q4, const void* s4, void* out, int M, int K, int N2,
                const Splits& splits, int S, cudaStream_t stream) {
  static SmemLimit limit;
  cudaError_t e = limit.ensure((const void*)int4_bf16_kernel, i4::BYTES);
  if (e != cudaSuccess) return (int)e;
  EncodeTiled enc = encode_tiled();
  Maps maps;
  if (!enc ||
      !map_2d(&maps.x, enc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2 * (uint64_t)K, 64,
              i4::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&maps.q4, enc, CU_TENSOR_MAP_DATA_TYPE_UINT8, q4, N2, K, N2, i4::BN2, GROUP,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&maps.s4, enc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s4, N2, 2 * (K / GROUP),
              4 * (uint64_t)N2, i4::BN2, 2, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(S, (N2 + i4::BN2 - 1) / i4::BN2, (M + i4::BM - 1) / i4::BM);
  return (int)launch_ex(int4_bf16_kernel, grid, dim3(i4::NTH), i4::BYTES, stream, S, false,
                        maps, static_cast<__nv_bfloat16*>(out), M, N2, splits);
}

// ---------------------------------------------------------------------------
// f32 x: CUDA cores, all of K in one CTA
// ---------------------------------------------------------------------------

namespace f4 {
constexpr int BM = 64;      // rows per CTA
constexpr int BN2 = 16;     // packed columns per CTA (32 outputs)
constexpr int NTH = 128;
constexpr int STAGES = 2;
constexpr int XP = GROUP + 4;                 // x row pitch (f32)
constexpr int X_BYTES = BM * XP * 4;
constexpr int Q_BYTES = GROUP * BN2;
constexpr int S_BYTES = 2 * BN2 * 4;
constexpr int STAGE = X_BYTES + Q_BYTES + S_BYTES;  // a multiple of 16
constexpr int BYTES = STAGES * STAGE;
}  // namespace f4

// stage <- group gi: x rows [m0, m0 + 64) (rows >= M zero), q4 rows of the
// group at packed columns [n0, n0 + 16), and the group's scales of output
// columns n0.. (low nibbles) and N2 + n0.. (high nibbles)
__device__ __forceinline__ void load_f32_stage(char* st, const float* __restrict__ x,
                                               const int8_t* __restrict__ q4,
                                               const float* __restrict__ s4, int M, int K,
                                               int N2, int m0, int n0, int gi, int tid) {
  using namespace f4;
  float* xs = reinterpret_cast<float*>(st);
  char* qs = st + X_BYTES;
  float* ss = reinterpret_cast<float*>(st + X_BYTES + Q_BYTES);
  constexpr int CPR = GROUP / 4;  // 16-byte chunks per x row
  const int k0 = gi * GROUP;
  for (int i = tid; i < BM * CPR; i += NTH) {
    const int r = i / CPR, cc = i % CPR;
    const bool ok = m0 + r < M;
    const float* src = ok ? x + (int64_t)(m0 + r) * K + k0 + cc * 4 : x;
    cp_async16(xs + r * XP + cc * 4, src, ok);
  }
  for (int i = tid; i < GROUP; i += NTH)
    cp_async16(qs + i * BN2, q4 + (int64_t)(k0 + i) * N2 + n0, true);
  if (tid < 2 * BN2) {
    const int col = n0 + tid + (tid < BN2 ? 0 : N2 - BN2);
    cp_async4(ss + tid, s4 + (int64_t)gi * 2 * N2 + col, true);
  }
}

// acc += this group's term: thread t owns output column t % 32 of the CTA
// (16 low-nibble columns, then 16 high) for rows 16 * (t / 32) .. + 15
__device__ __forceinline__ void f32_group(const char* st, float (&acc)[16], int tid) {
  using namespace f4;
  const float* xs = reinterpret_cast<const float*>(st);
  const uint8_t* qs = reinterpret_cast<const uint8_t*>(st + X_BYTES);
  const float* ss = reinterpret_cast<const float*>(st + X_BYTES + Q_BYTES);
  const int j = tid % 32, shift = (j / BN2) * 4, jb = j % BN2, r0 = (tid / 32) * 16;
  float p[16], rs[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) p[r] = rs[r] = 0.f;
  for (int k = 0; k < GROUP; ++k) {
    const float w = (float)((qs[k * BN2 + jb] >> shift) & 15);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float xv = xs[(r0 + r) * XP + k];
      p[r] = fmaf(xv, w, p[r]);
      rs[r] += xv;
    }
  }
  const float s = ss[j];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r] += (p[r] - 8.f * rs[r]) * s;
}

// grid (N2 / 16, ceil(M / 64)), f4::NTH threads, f4::BYTES of dynamic shared memory
__global__ void __launch_bounds__(f4::NTH)
int4_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q4,
                const float* __restrict__ s4, float* __restrict__ out, int M, int K, int N2) {
  using namespace f4;
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * BN2, m0 = blockIdx.y * BM, tid = threadIdx.x;
  const int NG = K / GROUP;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < NG) load_f32_stage(smem + s * STAGE, x, q4, s4, M, K, N2, m0, n0, s, tid);
    cp_async_commit();
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int gi = 0; gi < NG; ++gi) {
    cp_async_wait<STAGES - 2>();  // group gi has landed
    __syncthreads();              // ... for every thread; gi - 1 is consumed
    const int nx = gi + STAGES - 1;
    if (nx < NG)
      load_f32_stage(smem + (nx % STAGES) * STAGE, x, q4, s4, M, K, N2, m0, n0, nx, tid);
    cp_async_commit();
    f32_group(smem + (gi % STAGES) * STAGE, acc, tid);
  }
  cp_async_wait<0>();

  const int64_t N = 2 * (int64_t)N2;
  const int j = tid % 32, r0 = (tid / 32) * 16;
  const int col = (j / BN2) * N2 + n0 + j % BN2;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    if (m0 + r0 + r < M) out[(m0 + r0 + r) * N + col] = acc[r];
}

int launch_f32(const void* x, const void* q4, const void* s4, void* out, int M, int K, int N2,
               cudaStream_t stream) {
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)int4_f32_kernel, f4::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N2 / f4::BN2, (M + f4::BM - 1) / f4::BM);
  int4_f32_kernel<<<grid, f4::NTH, f4::BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q4),
      static_cast<const float*>(s4), static_cast<float*>(out), M, K, N2);
  return (int)cudaGetLastError();
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16 (x and out). x [M, K]
// with K a multiple of 128; q4 [K, N2] int8 with N2 a multiple of 16; s4
// [K / 128, 2 * N2] f32; out [M, 2 * N2]. All contiguous, 16-byte aligned.
// bf16: nsplit in [1, 8] and bounds[0..nsplit] the splits' group boundaries
// (0 = bounds[0] < bounds[1] < ... < bounds[nsplit] = K / 128); f32 ignores
// them. Returns the CUDA error code of the launch.
extern "C" int mdt_int4_matmul(int dtype, const void* x, const void* q4, const void* s4,
                               void* out, int M, int K, int N2, int nsplit,
                               const int* bounds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % mdt::GROUP || N2 % 16 || M <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return mdt::launch_f32(x, q4, s4, out, M, K, N2, st);
  if (dtype != 1 || nsplit < 1 || nsplit > mdt::i4::MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  mdt::Splits splits = {};
  if (bounds[0] != 0 || bounds[nsplit] != K / mdt::GROUP) return (int)cudaErrorInvalidValue;
  for (int s = 0; s <= nsplit; ++s) {
    if (s > 0 && bounds[s] <= bounds[s - 1]) return (int)cudaErrorInvalidValue;
    splits.g[s] = bounds[s];
  }
  return mdt::launch_bf16(x, q4, s4, out, M, K, N2, splits, nsplit, st);
}
