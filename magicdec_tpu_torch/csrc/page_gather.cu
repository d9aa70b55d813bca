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
// buffer's top region. Bound on the H100: bytes (each selected row read
// once and written once, no arithmetic), so the design is about keeping
// enough bytes in flight to cover the memory latency on every SM.
//
// Work units: a unit (part z, sequence b, page j) is `rows` contiguous rows
// of source z at (b, page p = pages[b, j]) and goes to `rows` contiguous
// rows of destination z at (b, j) (each sequence's n pages are contiguous in
// the output; any sequence stride). page_gather's parts are the K and V
// caches; page_gather_single's the two halves of a store page (the second
// source is the store `cap` rows on), or one part for whole pages. Each
// unit is cut into chunks of chunk_bytes, the last one tail_bytes long. The
// launch geometry (chunk size, chunks per unit, tail, grid, ring stages) is
// computed by the wrapper (ops/page_gather.py `geometry`), which the CPU
// tests check for exact coverage; chunk i of the launch belongs to unit
// i / chunks_per_unit, and CTA c walks chunks c, c + grid, c + 2 grid, ...
//
// The bulk kernel (gather_bulk): one warp per CTA, one CTA an SM. The
// warp's lanes first compute the source, destination and size of the CTA's
// next 32 chunks in parallel (one page-index load each, all in flight at
// once). One elected lane then walks the chunks through a ring of `stages`
// chunk buffers in dynamic shared memory with Hopper's bulk async copies
// (the TMA's non-tensor form): each chunk is one cp.async.bulk load into a
// ring stage, completing on the stage's mbarrier, and one cp.async.bulk
// store from the stage to the destination. A stage is refilled once the
// store of its previous chunk has read it (cp.async.bulk.wait_group.read).
// So each SM has up to stages - 1 chunk loads and the stores in flight
// without spending registers or instructions per byte, and the bytes never
// pass through L1 or registers. The copy is type-agnostic: it moves bytes.
// A page index outside [0, n_src_pages) is clamped into it (memory safety;
// the callers pass top-k indices, always in range).
//
// On the H100 the chunked designs swept (bulk copies at 8-64 KB chunks,
// 3-16 stages, 1-2 CTAs an SM; vector copies with 8 non-L1-allocating
// 16-byte loads in flight a thread) ran within ~6% of each other: each
// streams at ~3 TB/s, and a few microseconds of every call go to the
// launch, the first loads' latency and the last stores' writes. The fixed
// geometry (16 KB chunks, 12 stages, one CTA an SM) was the fastest summed
// over the main path's four gather shapes (PERF.md). `fault` (card checks
// only) drops the last chunk of every unit, which every bit check must
// reject.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace mdt {

// the ring's limits; the C entry rejects a geometry beyond them
constexpr int MAX_STAGES = 16;
constexpr int MAX_RING_BYTES = 200 * 1024;   // of the SM's 227 KB

// two sources and destinations as named fields (not an array: a dynamic
// index into the parameter block would go through local memory)
struct GatherArgs {
  const char* src0;
  const char* src1;
  char* dst0;
  char* dst1;
  const int* pages;            // [B, n]
  int B, n, n_src_pages;
  int chunk_bytes, chunks_per_unit, tail_bytes, total_chunks, stages, fault;
  int64_t src_b, src_page;     // source strides, bytes
  int64_t dst_b, dst_page;     // destination strides, bytes
};

struct Span {
  const char* src;
  char* dst;
  int bytes;
};

// chunk i of the launch: unit u = ((z * B) + b) * n + j, chunk k of it
__device__ __forceinline__ Span chunk_span(const GatherArgs& a, int i) {
  const int u = i / a.chunks_per_unit, k = i - u * a.chunks_per_unit;
  const int j = u % a.n, zb = u / a.n, b = zb % a.B, z = zb / a.B;
  const int p = min(max(__ldg(a.pages + b * a.n + j), 0), a.n_src_pages - 1);
  const int64_t off = (int64_t)k * a.chunk_bytes;
  const bool last = k == a.chunks_per_unit - 1;
  Span s;
  s.src = (z ? a.src1 : a.src0) + b * a.src_b + p * a.src_page + off;
  s.dst = (z ? a.dst1 : a.dst0) + b * a.dst_b + j * a.dst_page + off;
  s.bytes = last ? (a.fault ? 0 : a.tail_bytes) : a.chunk_bytes;
  return s;
}

// one warp; lane 0 issues every copy
__global__ void __launch_bounds__(32) gather_bulk(GatherArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ char* stage_dst[MAX_STAGES];
  __shared__ int stage_bytes[MAX_STAGES];
  const int lane = threadIdx.x, S = a.stages;
  const int first = blockIdx.x, step = gridDim.x;
  const int count = (a.total_chunks - first + step - 1) / step;
  if (lane == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&full[s])),
                   "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();

  // lane l holds the span of the CTA's chunk win + l
  int win = 0;
  Span mine{nullptr, nullptr, 0};
  if (lane < count) mine = chunk_span(a, first + lane * step);

  // load the CTA's chunk t (t increases by one each call) into its stage
  auto load = [&](int t) {
    if (t >= win + 32) {                       // warp-uniform
      win += 32;
      if (win + lane < count) mine = chunk_span(a, first + (win + lane) * step);
    }
    const int l = t - win;
    const char* src = reinterpret_cast<const char*>(
        __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(mine.src), l));
    char* dst = reinterpret_cast<char*>(
        __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(mine.dst), l));
    const int bytes = __shfl_sync(0xffffffffu, mine.bytes, l);
    if (lane == 0) {
      const int s = t % S;
      const uint32_t bar = smem_u32(&full[s]);
      stage_dst[s] = dst;
      stage_bytes[s] = bytes;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes) : "memory");
      if (bytes)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + (size_t)s * a.chunk_bytes)),
            "l"(src), "r"(bytes), "r"(bar) : "memory");
    }
  };

  for (int t = 0; t < min(S, count); ++t) load(t);
  for (int t = 0; t < count; ++t) {
    if (lane == 0) {
      const int s = t % S;
      mbar_wait(smem_u32(&full[s]), (t / S) & 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (stage_bytes[s])
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                         stage_dst[s]),
                     "r"(smem_u32(ring + (size_t)s * a.chunk_bytes)), "r"(stage_bytes[s])
                     : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    // refill the stage of chunk t - 1 (its store was issued one chunk ago)
    if (t >= 1 && t - 1 + S < count) {
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(t - 1 + S);
    }
  }
  // every store written before the CTA (and its shared memory) goes
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace mdt

// C interface (ctypes). src0/src1 point at the layer's rows of sequence 0
// (src1 null when parts == 1), pages [B, n] int32, dst0/dst1 at the output
// rows of sequence 0, page 0 (dst1 null when parts == 1). Strides are in
// bytes. The geometry (ops/page_gather.py `geometry`): each of the
// parts * B * n units is chunks_per_unit chunks of chunk_bytes, the last
// one tail_bytes; `grid` CTAs; `stages` ring stages (2 to MAX_STAGES, at
// most MAX_RING_BYTES in all). Every stride, size and pointer is a multiple
// of 16 bytes. fault = 1 drops each unit's last chunk (card checks only).
// Returns the CUDA error code (0 = success; cudaErrorInvalidValue for a
// geometry the kernel does not take).
extern "C" int mdt_page_gather(const void* src0, const void* src1, const int* pages,
                               void* dst0, void* dst1, int parts, int B, int n,
                               int n_src_pages, long long src_b_bytes,
                               long long src_page_bytes, long long dst_b_bytes,
                               long long dst_page_bytes, int chunk_bytes,
                               int chunks_per_unit, int tail_bytes, int grid, int stages,
                               int fault, void* stream) {
  const long long total = (long long)parts * B * n * chunks_per_unit;
  if (src_b_bytes % 16 || src_page_bytes % 16 || dst_b_bytes % 16 ||
      dst_page_bytes % 16 || chunk_bytes <= 0 || chunk_bytes % 16 || tail_bytes <= 0 ||
      tail_bytes % 16 || tail_bytes > chunk_bytes || chunks_per_unit <= 0 || parts < 1 ||
      parts > 2 || n <= 0 || B <= 0 || n_src_pages <= 0 || total > INT32_MAX ||
      grid <= 0 || grid > total || fault < 0 || fault > 1 || stages < 2 ||
      stages > mdt::MAX_STAGES || (long long)stages * chunk_bytes > mdt::MAX_RING_BYTES)
    return (int)cudaErrorInvalidValue;
  mdt::GatherArgs a;
  a.src0 = static_cast<const char*>(src0);
  a.src1 = static_cast<const char*>(parts == 2 ? src1 : src0);
  a.dst0 = static_cast<char*>(dst0);
  a.dst1 = static_cast<char*>(parts == 2 ? dst1 : dst0);
  a.pages = pages;
  a.B = B;
  a.n = n;
  a.n_src_pages = n_src_pages;
  a.chunk_bytes = chunk_bytes;
  a.chunks_per_unit = chunks_per_unit;
  a.tail_bytes = tail_bytes;
  a.total_chunks = (int)total;
  a.stages = stages;
  a.fault = fault;
  a.src_b = src_b_bytes;
  a.src_page = src_page_bytes;
  a.dst_b = dst_b_bytes;
  a.dst_page = dst_page_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static mdt::SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)mdt::gather_bulk, mdt::MAX_RING_BYTES);
  if (e != cudaSuccess) return (int)e;
  mdt::gather_bulk<<<grid, 32, (size_t)stages * chunk_bytes, s>>>(a);
  return (int)cudaGetLastError();
}
