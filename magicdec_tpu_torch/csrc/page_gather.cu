// Page gathers for Hopper (sm_90a): copy n selected pages of one layer into
// [B, n, rows, HD] outputs, bit for bit. One kernel serves both TPU kernels
// it replaces in magicdec_tpu/ops/pallas/page_gather.py:
//  * page_gather (pallas_call at :231 in DMA mode, :268 in grid mode): the
//    Quest draft's K and V pages from the stacked caches [L, B, S, HD];
//  * page_gather_single (pallas_call at :142 in DMA mode, :169 in grid
//    mode): whole clusters from the RetroInfer/SqueezedAttention KV-fused
//    store [L, B, C * 2cap, HD], where cluster c's K rows [c*2cap,
//    c*2cap + cap) are followed by its V rows. With an output pair the K
//    halves land in one output and the V halves in the other, so the round
//    buffer's K and V top regions fill in one launch.
// Both run once per layer at the start of each round to fill the round
// buffer's top region. The TPU kernels' two modes and their per-DMA-
// descriptor cost model were facts of the TPU; here the copy is one plain
// kernel. Bound on the H100: bytes (each selected row read once and written
// once, no arithmetic). Design:
//  * one CTA per (page j, sequence b, part z): part z copies `rows` rows
//    from source z at (b, page p) to destination z at (b, j). page_gather's
//    parts are the K and V caches; page_gather_single's are the two halves
//    of a store page (the second source is the store `cap` rows on); an
//    unsplit page is one part;
//  * every stride is free (in 16-byte vectors), so the gather writes
//    straight into the round buffer's top region at one layer: no
//    [B, n, page, HD] temporary, no second copy;
//  * 16-byte vector loads and stores, consecutive threads on consecutive
//    addresses, several loads in flight per thread;
//  * a page index outside [0, n_src_pages) is clamped into it (memory
//    safety; the callers pass top-k indices, always in range).
// The copy is type-agnostic: it moves bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdt {

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_UNROLL = 4;

// two sources and destinations as named fields (not an array: a dynamic
// index into the parameter block would go through local memory)
struct GatherArgs {
  const uint4* src0;
  const uint4* src1;
  uint4* dst0;
  uint4* dst1;
  const int* pages;          // [B, n]
  int n_src_pages;
  int64_t part_vec;          // vectors one CTA copies (rows * row_vec)
  int64_t src_b, src_page;   // source strides, in vectors
  int64_t dst_b, dst_page;   // destination strides, in vectors
};

// grid (n, B, parts)
__global__ void __launch_bounds__(GATHER_THREADS) page_gather_kernel(GatherArgs a) {
  const int j = blockIdx.x, b = blockIdx.y, z = blockIdx.z, n = gridDim.x;
  const int p = min(max(a.pages[b * n + j], 0), a.n_src_pages - 1);
  const uint4* src = (z ? a.src1 : a.src0) + (b * a.src_b + p * a.src_page);
  uint4* dst = (z ? a.dst1 : a.dst0) + (b * a.dst_b + j * a.dst_page);
  const int64_t count = a.part_vec;
  constexpr int STEP = GATHER_THREADS * GATHER_UNROLL;
  int64_t i = threadIdx.x;
  for (; i + (GATHER_UNROLL - 1) * GATHER_THREADS < count; i += STEP) {
    uint4 r[GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) r[u] = src[i + u * GATHER_THREADS];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) dst[i + u * GATHER_THREADS] = r[u];
  }
  for (; i < count; i += GATHER_THREADS) dst[i] = src[i];
}

}  // namespace mdt

// C interface (ctypes). src0/src1 point at the layer's rows of sequence 0
// (src1 null when parts == 1), pages [B, n] int32, dst0/dst1 at the output
// rows of sequence 0, page 0. Each part copies `rows` rows of row_bytes.
// Strides are in bytes. row_bytes, every stride and every pointer are
// multiples of 16 bytes. Returns the CUDA error code (0 = success).
extern "C" int mdt_page_gather(const void* src0, const void* src1,
                               const int* pages, void* dst0, void* dst1,
                               int parts, int B, int n, int n_src_pages,
                               int rows, int row_bytes,
                               long long src_b_bytes, long long src_page_bytes,
                               long long dst_b_bytes, long long dst_page_bytes,
                               void* stream) {
  if (row_bytes % 16 || src_b_bytes % 16 || src_page_bytes % 16 ||
      dst_b_bytes % 16 || dst_page_bytes % 16 || parts < 1 || parts > 2 ||
      n <= 0 || B <= 0 || rows <= 0 || n_src_pages <= 0)
    return (int)cudaErrorInvalidValue;
  mdt::GatherArgs a;
  a.src0 = static_cast<const uint4*>(src0);
  a.src1 = static_cast<const uint4*>(parts == 2 ? src1 : src0);
  a.dst0 = static_cast<uint4*>(dst0);
  a.dst1 = static_cast<uint4*>(parts == 2 ? dst1 : dst0);
  a.pages = pages;
  a.n_src_pages = n_src_pages;
  a.part_vec = (int64_t)rows * (row_bytes / 16);
  a.src_b = src_b_bytes / 16;
  a.src_page = src_page_bytes / 16;
  a.dst_b = dst_b_bytes / 16;
  a.dst_page = dst_page_bytes / 16;
  mdt::page_gather_kernel<<<dim3(n, B, parts), mdt::GATHER_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
