// Page gather for Hopper (sm_90a): copy n selected pages (page rows of
// row_bytes each) of one layer of the stacked K and V caches [L, B, S, HD]
// into [B, n, page, HD] outputs, bit for bit.
//
// Replaces magicdec_tpu/ops/pallas/page_gather.py page_gather (pallas_call
// at :231 in DMA mode, :268 in grid mode), which the Quest draft runs at the
// start of each round to fill the round buffer's top region. The TPU
// kernel's two modes and their per-DMA-descriptor cost model were facts of
// the TPU; here the copy is one plain kernel. Bound on the H100: bytes (each
// selected row read once and written once, no arithmetic). Design:
//  * one CTA per (page j, sequence b, tensor), so K and V of all B*n pages
//    are copied by one launch; the layer is a pointer offset;
//  * 16-byte vector loads and stores, consecutive threads on consecutive
//    addresses, several loads in flight per thread;
//  * each output sequence's n pages are contiguous but the sequence stride
//    is free, so the gather can write straight into the round buffer's top
//    region [B, NS, HD] at one layer (no second copy);
//  * a page index outside [0, S/page) is clamped into it (memory safety; the
//    callers pass top-k indices, always in range).
// The copy is type-agnostic: it moves bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdt {

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_UNROLL = 4;

// grid (n, B, 2): blockIdx.z = 0 copies K, 1 copies V. Strides in 16-byte
// vectors.
__global__ void __launch_bounds__(GATHER_THREADS)
page_gather_kernel(const uint4* __restrict__ k_layer, const uint4* __restrict__ v_layer,
                   const int* __restrict__ pages, uint4* __restrict__ out_k,
                   uint4* __restrict__ out_v, int S, int page, int row_vec,
                   int64_t out_b_stride_vec) {
  const int j = blockIdx.x, b = blockIdx.y, n = gridDim.x;
  const int n_src_pages = S / page;
  const int p = min(max(pages[b * n + j], 0), n_src_pages - 1);
  const int64_t page_vec = (int64_t)page * row_vec;
  const uint4* src =
      (blockIdx.z ? v_layer : k_layer) + ((int64_t)b * S * row_vec + p * page_vec);
  uint4* dst = (blockIdx.z ? out_v : out_k) + (b * out_b_stride_vec + j * page_vec);
  constexpr int STEP = GATHER_THREADS * GATHER_UNROLL;
  int64_t i = threadIdx.x;
  for (; i + (GATHER_UNROLL - 1) * GATHER_THREADS < page_vec; i += STEP) {
    uint4 r[GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) r[u] = src[i + u * GATHER_THREADS];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) dst[i + u * GATHER_THREADS] = r[u];
  }
  for (; i < page_vec; i += GATHER_THREADS) dst[i] = src[i];
}

}  // namespace mdt

// C interface (ctypes). k, v [L, B, S, row_bytes] (any dtype), pages [B, n]
// int32, out_k / out_v: sequence b's n pages contiguous at
// out + b * out_b_stride_bytes. row_bytes, out_b_stride_bytes and every
// pointer are multiples of 16 bytes; S is a multiple of page. Returns the
// CUDA error code (0 = success).
extern "C" int mdt_page_gather(const void* k, const void* v, const int* pages,
                               void* out_k, void* out_v, int layer, int B,
                               int S, int n, int page, int row_bytes,
                               long long out_b_stride_bytes, void* stream) {
  if (row_bytes % 16 || out_b_stride_bytes % 16 || S % page || n <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int row_vec = row_bytes / 16;
  const int64_t layer_off = (int64_t)layer * B * S * row_vec;
  mdt::page_gather_kernel<<<dim3(n, B, 2), mdt::GATHER_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k) + layer_off,
      static_cast<const uint4*>(v) + layer_off,
      pages, static_cast<uint4*>(out_k), static_cast<uint4*>(out_v), S, page, row_vec,
      out_b_stride_bytes / 16);
  return (int)cudaGetLastError();
}
