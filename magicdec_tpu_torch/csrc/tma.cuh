// TMA, mbarrier and launch helpers shared by the weight-streaming kernels
// (int4_matmul.cu, fused_block.cu); the gathers (page_gather.cu) use the
// mbarrier wait, and every source's launcher the shared memory limit.
//
// Device side: shared-memory addresses, mbarrier init / expect_tx / wait,
// and a 2-D tensor load (cp.async.bulk.tensor) that completes on an
// mbarrier. Host side: cuTensorMapEncodeTiled from the driver through the
// runtime (nothing links libcuda), 2-D tensor maps, a once-per-device
// dynamic shared memory limit, and cudaLaunchKernelEx with a thread-block
// cluster and, optionally, programmatic dependent launch.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// one arrival that also expects `bytes` of transactions on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` of the mbarrier to complete; a wait
// that outlasts ~2^32 cycles (seconds) traps, so a lost copy fails the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map of rows x cols elements (cols contiguous, rows `pitch` bytes
// apart) in boxes of box_rows x box_cols
static bool map_2d(CUtensorMap* m, EncodeTiled enc, CUtensorMapDataType type, const void* base,
                   uint64_t cols, uint64_t rows, uint64_t pitch, uint32_t box_cols,
                   uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  return enc(m, type, 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared memory limit of one kernel, raised on each device the
// first time a launch there needs more than the default (one static
// instance per kernel; a process may launch on several devices).
struct SmemLimit {
  static constexpr int MAX_DEVICES = 64;
  int bytes[MAX_DEVICES] = {};
  cudaError_t ensure(const void* kernel, int need) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES && bytes[dev] >= need) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (e == cudaSuccess && dev < MAX_DEVICES) bytes[dev] = need;
    return e;
  }
};

// kernel<<<grid, block, smem, stream>>>(args...) in thread-block clusters of
// (cluster_x, 1, 1); with pdl, programmatic stream serialization: the kernel
// may start once every CTA of the kernel before it on the stream has run
// griddepcontrol.launch_dependents (or exited), and must run
// griddepcontrol.wait before it reads what that kernel wrote or writes
// global memory. Returns the launch's error.
template <typename... KArgs, typename... Args>
static cudaError_t launch_ex(void (*kernel)(KArgs...), dim3 grid, dim3 block, int smem,
                             cudaStream_t stream, unsigned cluster_x, bool pdl,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mdt
