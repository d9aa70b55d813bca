// Conversions, tensor-core (mma.sync, wgmma) and asynchronous-copy helpers
// shared by the attention kernels (flash_common.cuh), int4_matmul.cu and
// fused_block.cu.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA): lane = 4*g + c; A holds
// rows g, g+8 and k 2c, 2c+1 (+8); B holds k 2c, 2c+1 (+8) of column g; C
// holds rows g, g+8 and columns 2c, 2c+1. Each element of C is the sum of
// its own row of A times its own column of B, so a row's result does not
// depend on the other rows of the tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (round to nearest even), returned as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Asynchronous global -> shared copies (cp.async, sm_80+). With valid false
// nothing is read and the bytes are zero-filled; src must still be a
// mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// e^x by the SFU's ex2.approx (x scaled by log2 e; ~2 ulp): one multiply
// and one MUFU op where expf takes a range reduction. e^x of x <= -1e29 is
// 0, and of 0 is 1.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// ldmatrix.x4: four 8x8 b16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8 (16 contiguous bytes, 16-byte
// aligned), and r[i] receives this lane's pair of matrix i: row lane / 4,
// columns 2 (lane % 4), +1. With a row-major Q tile this is the A fragment
// of mma.m16n8k16; with K rows (slot-major) the B fragments of Q K^T.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, transposed: r[i] receives rows 2 (lane % 4), +1 of column
// lane / 4 of matrix i. With V rows (slot-major) these are the B fragments
// of P V (k = slot, n = feature).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// wgmma's shared-memory matrix descriptor of an operand in the 128-byte
// swizzle (the TMA's SWIZZLE_128B boxes: rows of 128 bytes, 8-row groups
// 1024 bytes apart). K-major (the rows run along K): the start may sit 32,
// 64 or 96 bytes into the swizzle atom, and the leading offset is unused.
// MN-major (the rows run along M or N, 64 bf16 a row; wgmma's transpose
// flag): the start sits on an atom, and lbo = 1024 puts the 8-row group
// stride in both offset fields, since an operand 64 wide has one block
// along M or N and whichever field the hardware takes for that stride goes
// unused.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

}  // namespace mdt
