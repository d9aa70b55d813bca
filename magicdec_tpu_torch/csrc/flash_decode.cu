// Flash decode for Hopper (sm_90a): GQA decode attention of a small query
// block (T*G <= 64 rows per KV head) against one layer of the packed cache
// [L, B, S, Hkv*D], D in {64, 128}, query row r attending to slots
// [0, a_r) u [lo_r, hi_r), optionally only where a per-(layer, b, column)
// bit is set.
//
// One split kernel serves three TPU kernels of magicdec_tpu/ops/pallas/
// flash_decode.py: flash_decode_stacked (pallas_call at :488; ragged-causal,
// a = lo = 0, read straight out of the stacked cache),
// flash_decode_intervals (pallas_call at :370; flat [B, S, Hkv*D] cache =
// L = 1, the StreamingLLM sink + window mask) and
// flash_decode_stacked_masked (pallas_call at :738; the Quest round buffer
// [L, B, NS + Wcap, Hkv*D] with a = lo = NS and the colmask [L, B, 1, R]
// int32 gating the gathered top region). Sharing it is what makes a
// sink + window draft at full budget give the verify's bits. The TPU
// kernels' block-diagonal query embedding (an MXU workaround) is gone: each
// CTA takes one KV head's columns. The intervals form may also read the K
// of slots < n_sink from a separate [B, n_sink, Hkv*D] tensor (the draft's
// rope-twisted sink rows), so no per-step copy of the cache layer is made.
// The stacked and intervals forms also serve the TPU kernels' return_lse
// outputs (:486-499 and :395-398, the GliDe tree verify and tree draft):
// the merge kernel already holds each row's merged softmax state (m, l) in
// the TPU kernel's units (m the max of the scaled logits, natural base; l
// the sum of exp(s - m)) and writes it to two optional f32 outputs; the
// context output keeps its bits whether they are asked for or not.
// Bound on the H100: bytes. Each call streams the K and V of every valid
// slot once (B * len * Hkv*D * 2 * itemsize) and does ~4*T*G*D FLOPs per
// slot and head, far below the card's ~295 FLOP/byte ridge. Design against
// that bound:
//  * Split-KV: one CTA per (KV split, KV head, b), so B=8 x Hkv=8 fills the
//    132 SMs even at the 1056-slot draft shape (SPLIT = 256: 5 splits, 320
//    CTAs); a second kernel merges the splits. Each CTA reads its head's
//    columns of its slot range exactly once, and all G*T query rows of the
//    head share that read.
//  * bf16 (every engine's cache): the CTA first lists the tiles of its split
//    that any row needs (below every bound, outside every gap, with a column
//    bit set; a tile is "full", unmasked, only if all 64 slots are valid for
//    every row), then streams them through a STAGES-deep cp.async ring of
//    bf16 shared tiles, one barrier a tile, the copies of the next
//    STAGES - 1 tiles in flight while one is computed. Four warps; warp w
//    owns rows 16w..16w+15 on the tensor cores (flash_common.cuh
//    warp_tile), so the 64 rows of a 16-node GliDe chunk cost no more
//    registers a thread than 4; warps without rows only copy.
//  * float32: the CUDA-core tile step (exact f32 products), 2*D threads.
//  * The layer is a pointer offset, not a copy; no slot at or past the
//    CTA's largest row bound is read, so rolled-back tails cost nothing, and
//    tiles inside every row's gap [a, lo) are skipped, and so are tiles
//    whose column bits are all 0 (pad pages of the Quest top region).
// Numerics (the full-budget acceptance == 1.0 invariant):
//  * Splits sit at fixed multiples of SPLIT slots and tiles at multiples of
//    TILE, independent of S, B, T and the SM count, so a draft cache of
//    capacity budget+64 and a target cache of capacity max_len holding the
//    same prefix give the same bits.
//  * Splits merge as unnormalised (acc, m, l) in split order, dividing once
//    at the end; an empty split (l == 0) is skipped, an exact identity.
//  * Rows are independent (see flash_common.cuh).
#include "flash_common.cuh"
#include "tma.cuh"

namespace mdt {

constexpr int SPLIT = 256;  // slots per KV split: a global constant
constexpr int NTILES = SPLIT / TILE;
constexpr int MAX_ROWS = 64;  // T*G rows of one KV head
constexpr int DEC_NT = 128;   // threads of a bf16 CTA: 4 warps x 16 rows

// The bounds, the sink rows and the column bits of one call.
struct Rows {
  const int* a;
  const int* lo;
  const int* hi;
  const void* ksink;
  int n_sink;
  const int* colmask;  // [L, B, 1, S] or null
};

// ---- float32: CUDA cores -------------------------------------------------

// grid (nsplit, Hkv, B), F32<D>::NT threads. Partials: acc [B, Hkv, nsplit,
// M, D], ml [.., M, 2]. a_rows / lo_rows [B, T] may be null (= 0); ksink
// [B, n_sink, Hkv*D] may be null when n_sink = 0; cm_layer [B, S] (this
// layer's colmask) may be null.
template <int D, int MR>
__global__ void __launch_bounds__(F32<D>::NT)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k_layer,
                    const float* __restrict__ v_layer, const int* __restrict__ a_rows,
                    const int* __restrict__ lo_rows, const int* __restrict__ hi_rows,
                    const float* __restrict__ ksink, int n_sink,
                    const int* __restrict__ cm_layer,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int T_, int Hq, int Hkv, int S, int s_extent, float scale) {
  constexpr int NT = F32<D>::NT, NGRP_V = F32<D>::NGRP_V;
  constexpr int R = MR * NGRP_V;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int G = Hq / Hkv, M = T_ * G;
  Smem<D> sm(R);

  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < M) {
      const int t = r / G, g = r % G;
      x = q[(((int64_t)b * T_ + t) * Hq + h * G + g) * D + d];
    }
    sm.q[idx] = x;
  }
  for (int r = threadIdx.x; r < M; r += NT) {
    const int i = b * T_ + r / G;
    sm.a[r] = a_rows ? min(a_rows[i], s_extent) : 0;
    sm.lo[r] = lo_rows ? lo_rows[i] : 0;
    sm.hi[r] = min(hi_rows[i], s_extent);
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.f;
  }
  row_bounds(sm, M);

  float acc[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) acc[i] = 0.f;
  const int64_t row_stride = (int64_t)Hkv * D;
  const float* kb = k_layer + (int64_t)b * S * row_stride + h * D;
  const float* vb = v_layer + (int64_t)b * S * row_stride + h * D;
  const float* ks = ksink ? ksink + (int64_t)b * n_sink * row_stride + h * D : nullptr;
  const int* cm = cm_layer ? cm_layer + (int64_t)b * S : nullptr;
  const int start = sp * SPLIT;
  attend_range<float, D, MR>(kb, vb, ks, n_sink, cm, row_stride, start,
                             min(start + SPLIT, s_extent), M, scale, sm, acc);

  const int64_t base = (((int64_t)b * Hkv + h) * nsplit + sp) * M;
  const int d = threadIdx.x % D, rg = threadIdx.x / D;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = rg + NGRP_V * i;
    if (r < M) part_acc[(base + r) * D + d] = acc[i];
  }
  for (int r = threadIdx.x; r < M; r += NT) {
    part_ml[(base + r) * 2] = sm.m[r];
    part_ml[(base + r) * 2 + 1] = sm.l[r];
  }
}

// ---- bfloat16: tensor cores, cp.async ring --------------------------------

// Dynamic shared memory of the bf16 split kernel: the ring, then the row
// bounds, the CTA bounds, the tile list and the split's column bits.
template <int D>
constexpr size_t decode_mma_smem() {
  return sizeof(bf16) * STAGES * stage_elems<D>() +
         sizeof(int) * (3 * MAX_ROWS + 6 + NTILES + 2) + sizeof(uint32_t) * (SPLIT / 32);
}

// grid (nsplit, Hkv, B), DEC_NT threads; the same operands and partials as
// decode_split_kernel. fault = 1 plants a pipeline fault for the card
// checks: the last listed tile of every split is copied but not computed.
template <int D>
__global__ void __launch_bounds__(DEC_NT)
decode_split_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_layer,
                        const bf16* __restrict__ v_layer, const int* __restrict__ a_rows,
                        const int* __restrict__ lo_rows, const int* __restrict__ hi_rows,
                        const bf16* __restrict__ ksink, int n_sink,
                        const int* __restrict__ cm_layer, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int T_, int Hq, int Hkv, int S,
                        int s_extent, float scale, int fault) {
  constexpr int P = pitch<D>(), CPR = D / 8;
  extern __shared__ float4 smem_raw[];  // the f32 kernels' declaration too
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  int* sa = reinterpret_cast<int*>(ring + STAGES * stage_elems<D>());
  int* slo = sa + MAX_ROWS;
  int* shi = slo + MAX_ROWS;
  int* bnd = shi + MAX_ROWS;     // [6]
  int* list = bnd + 6;           // [NTILES]: tile index | full << 8
  int* nlist = list + NTILES;    // [1] tiles listed, [1] the split's limit
  uint32_t* words = reinterpret_cast<uint32_t*>(nlist + 2);  // [SPLIT / 32]

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nsplit = gridDim.x;
  const int G = Hq / Hkv, M = T_ * G;
  const int start = sp * SPLIT, end = min(start + SPLIT, s_extent);
  const int64_t row_stride = (int64_t)Hkv * D;
  const bf16* kb = k_layer + (int64_t)b * S * row_stride + h * D;
  const bf16* vb = v_layer + (int64_t)b * S * row_stride + h * D;
  const bf16* ks = ksink ? ksink + (int64_t)b * n_sink * row_stride + h * D : kb;
  const int* cm = cm_layer ? cm_layer + (int64_t)b * S : nullptr;

  // 1. Q rows into the last ring stage (free until the loop's first issue),
  //    row bounds, and the split's column bits as 32-bit words
  bf16* sQ = ring + (STAGES - 1) * stage_elems<D>();
  for (int idx = tid; idx < MAX_ROWS * CPR; idx += DEC_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < M) {
      const int t = r / G, g = r % G;
      val = *reinterpret_cast<const uint4*>(q + (((int64_t)b * T_ + t) * Hq + h * G + g) * D + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * P + c) = val;
  }
  for (int r = tid; r < MAX_ROWS; r += DEC_NT) {
    const int i = b * T_ + r / G;
    sa[r] = r < M && a_rows ? min(a_rows[i], s_extent) : 0;
    slo[r] = r < M && lo_rows ? lo_rows[i] : 0;
    shi[r] = r < M ? min(hi_rows[i], s_extent) : 0;
  }
  if (cm) {
    for (int i = tid; i < SPLIT; i += DEC_NT) {
      const int col = start + i;
      const uint32_t word = __ballot_sync(0xffffffffu, col < end && cm[col] != 0);
      if ((tid & 31) == 0) words[i / 32] = word;
    }
  }
  __syncthreads();

  // 2. the tile list (thread 0; the same triage as attend_range)
  if (tid == 0) {
    bounds_of(sa, slo, shi, M, bnd);
    const int a_min = bnd[A_MIN], a_max = bnd[A_MAX], lo_min = bnd[LO_MIN];
    const int lo_max = bnd[LO_MAX], hi_min = bnd[HI_MIN], hi_max = bnd[HI_MAX];
    const int limit = min(end, max(a_max, hi_max));
    int n = 0;
    for (int t0 = start; t0 < limit; t0 += TILE) {
      const int t1 = t0 + TILE, j = (t0 - start) / TILE;
      if (t0 >= a_max && (t1 <= lo_min || t0 >= hi_max)) continue;  // all gap
      const int n_load = min(TILE, limit - t0);
      bool full = t1 <= a_min || (lo_max <= t0 && t1 <= hi_min);
      if (cm) {
        uint64_t bits = words[2 * j] | ((uint64_t)words[2 * j + 1] << 32);
        if (n_load < TILE) bits &= (1ull << n_load) - 1;
        if (!bits) continue;  // every slot masked: an exact identity
        full = full && bits == ~0ull;
      }
      list[n++] = j | (full << 8);
    }
    nlist[0] = n;
    nlist[1] = limit;
  }
  __syncthreads();
  const int n = nlist[0], limit = nlist[1];

  // 3. the ring's prologue: tiles 0 .. STAGES-2 of the list in flight
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) {
      const int t0 = start + (list[i] & 0xff) * TILE;
      load_tile<D, DEC_NT>(ring + i * stage_elems<D>(), kb, vb, ks, n_sink, row_stride,
                           t0, min(TILE, limit - t0));
    }
    cp_async_commit();
  }

  // 4. each warp with rows: its Q fragments and row bounds. Warp w takes
  //    the 16 rows of m tile mt = (w + rot) % 4, rot a hash of the CTA, so
  //    that at T*G <= 16 (one computing warp) the CTAs sharing an SM
  //    compute on different sub-partitions; which warp computes a row does
  //    not change its bits
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2;
  const uint32_t cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int mt = (warp + ((cta * 0x9E3779B1u) >> 30)) & 3;
  const bool has_rows = mt * 16 < M;
  WarpState<D, false> ws;
  RowPair rp;
  if (has_rows) {
    ws.init(sQ, mt);
    const int ra = mt * 16 + g, rb = ra + 8;
    rp = RowPair{sa[ra], slo[ra], shi[ra], sa[rb], slo[rb], shi[rb]};
  }

  // 5. the tiles: wait for tile i, refill the stage tile i-1 used, compute i
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed for every thread; tile i-1 consumed
    const int nx = i + STAGES - 1;
    if (nx < n) {
      const int t0 = start + (list[nx] & 0xff) * TILE;
      load_tile<D, DEC_NT>(ring + (nx % STAGES) * stage_elems<D>(), kb, vb, ks, n_sink,
                           row_stride, t0, min(TILE, limit - t0));
    }
    cp_async_commit();
    if (!has_rows || (fault == 1 && i == n - 1)) continue;
    const int j = list[i] & 0xff;
    const bool full = (list[i] >> 8) & 1;
    const uint64_t bits = cm ? (words[2 * j] | ((uint64_t)words[2 * j + 1] << 32)) : ~0ull;
    const bf16* st = ring + (i % STAGES) * stage_elems<D>();
    warp_tile(ws, st, st + TILE * P, start + j * TILE, full, rp, cm != nullptr, bits,
              scale);
  }
  cp_async_wait<0>();

  // 6. this split's partials of the warp's rows
  if (!has_rows) return;
  ws.reduce_l();
  const int c = lane & 3;
  const int64_t base = (((int64_t)b * Hkv + h) * nsplit + sp) * M;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = mt * 16 + g + 8 * half;
    if (r >= M) continue;
    float* dst = part_acc + (base + r) * D + 2 * c;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(dst + nt * 8) =
          make_float2(ws.o[nt][2 * half], ws.o[nt][2 * half + 1]);
    if (c == 0) {
      part_ml[(base + r) * 2] = half ? ws.mB : ws.mA;
      part_ml[(base + r) * 2 + 1] = half ? ws.lB : ws.lA;
    }
  }
}

// ---- the merge ------------------------------------------------------------

// grid (M, Hkv, B), D threads, 2 * nsplit floats of dynamic shared memory:
// merge the splits of one query row in order. The splits' (m, l) are read
// into shared memory at once, and each thread's acc loads do not wait on
// the previous split's. out_m / out_l [B, T, Hq] (both null, or both set:
// the return_lse form) take the row's merged softmax state: m the max of
// the scaled logits, l the sum of exp(s - m); an empty row gives
// m = NEG_INF, l = 0 and out = 0.
template <typename T, int D>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out, float* __restrict__ out_m,
                                    float* __restrict__ out_l, int T_, int Hq,
                                    int Hkv, int nsplit) {
  extern __shared__ float4 smem_raw[];
  float* ml = reinterpret_cast<float*>(smem_raw);
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int M = gridDim.x, G = Hq / Hkv;
  const int64_t row0 = ((int64_t)b * Hkv + h) * nsplit * M + r;  // split 0's row
  for (int sp = d; sp < nsplit; sp += D)
    *reinterpret_cast<float2*>(ml + 2 * sp) =
        *reinterpret_cast<const float2*>(part_ml + (row0 + (int64_t)sp * M) * 2);
  __syncthreads();
  float m = NEG_INF, l = 0.f, a = 0.f;
  bool any = false;
#pragma unroll 4
  for (int sp = 0; sp < nsplit; ++sp) {
    const float a_i = part_acc[(row0 + (int64_t)sp * M) * D + d];
    const float l_i = ml[2 * sp + 1];
    if (l_i == 0.f) continue;  // empty split: identity
    const float m_i = ml[2 * sp];
    if (!any) {
      m = m_i; l = l_i; a = a_i; any = true;
    } else {
      const float mn = fmaxf(m, m_i);
      const float ca = expf(m - mn), cb = expf(m_i - mn);
      a = a * ca + a_i * cb;
      l = l * ca + l_i * cb;
      m = mn;
    }
  }
  const int t = r / G, g = r % G;
  const int64_t row = ((int64_t)b * T_ + t) * Hq + h * G + g;
  out[row * D + d] = from_f32<T>(any ? a / l : 0.f);
  if (out_m && d == 0) {
    out_m[row] = m;
    out_l[row] = l;
  }
}

// ---- launchers ------------------------------------------------------------

template <typename T, int D>
int launch_merge(const float* part_acc, const float* part_ml, void* out, float* out_m,
                 float* out_l, int B, int T_, int Hq, int Hkv, int nsplit,
                 cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int M = T_ * (Hq / Hkv);
  decode_merge_kernel<T, D><<<dim3(M, Hkv, B), D, 2 * nsplit * sizeof(float), stream>>>(
      part_acc, part_ml, static_cast<T*>(out), out_m, out_l, T_, Hq, Hkv, nsplit);
  return (int)cudaGetLastError();
}

template <int D, int MR>
int launch_f32(const void* q, const void* k, const void* v, Rows rows, void* out,
               float* out_m, float* out_l, float* part_acc, float* part_ml, int layer,
               int B, int T_, int Hq, int Hkv, int S, int s_extent, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes(MR * F32<D>::NGRP_V);
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)decode_split_kernel<D, MR>, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nsplit = (s_extent + SPLIT - 1) / SPLIT;
  const int64_t layer_off = (int64_t)layer * B * S * Hkv * D;
  const int* cm_layer = rows.colmask ? rows.colmask + (int64_t)layer * B * S : nullptr;
  decode_split_kernel<D, MR><<<dim3(nsplit, Hkv, B), F32<D>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k) + layer_off,
      static_cast<const float*>(v) + layer_off, rows.a, rows.lo, rows.hi,
      static_cast<const float*>(rows.ksink), rows.n_sink, cm_layer, part_acc, part_ml,
      T_, Hq, Hkv, S, s_extent, 1.0f / sqrtf((float)D));
  return launch_merge<float, D>(part_acc, part_ml, out, out_m, out_l, B, T_, Hq, Hkv,
                                nsplit, stream);
}

template <int D>
int dispatch_f32(const void* q, const void* k, const void* v, Rows rows, void* out,
                 float* out_m, float* out_l, float* part_acc, float* part_ml, int layer,
                 int B, int T_, int Hq, int Hkv, int S, int s_extent, cudaStream_t stream) {
  const int rows_per_group = (T_ * (Hq / Hkv) + F32<D>::NGRP_V - 1) / F32<D>::NGRP_V;
#define MDT_LAUNCH(MR)                                                              \
  return launch_f32<D, MR>(q, k, v, rows, out, out_m, out_l, part_acc, part_ml,     \
                           layer, B, T_, Hq, Hkv, S, s_extent, stream)
  if (rows_per_group <= 2) MDT_LAUNCH(2);
  if (rows_per_group <= 4) MDT_LAUNCH(4);
  if (rows_per_group <= 8) MDT_LAUNCH(8);
  if (rows_per_group <= 16) MDT_LAUNCH(16);
  if (rows_per_group <= 32) MDT_LAUNCH(32);
#undef MDT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, Rows rows, void* out,
                float* out_m, float* out_l, float* part_acc, float* part_ml, int layer,
                int B, int T_, int Hq, int Hkv, int S, int s_extent, int fault,
                cudaStream_t stream) {
  if (T_ * (Hq / Hkv) > MAX_ROWS) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = decode_mma_smem<D>();
  static SmemLimit limit;
  const cudaError_t e = limit.ensure((const void*)decode_split_mma_kernel<D>, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nsplit = (s_extent + SPLIT - 1) / SPLIT;
  const int64_t layer_off = (int64_t)layer * B * S * Hkv * D;
  const int* cm_layer = rows.colmask ? rows.colmask + (int64_t)layer * B * S : nullptr;
  decode_split_mma_kernel<D><<<dim3(nsplit, Hkv, B), DEC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k) + layer_off,
      static_cast<const bf16*>(v) + layer_off, rows.a, rows.lo, rows.hi,
      static_cast<const bf16*>(rows.ksink), rows.n_sink, cm_layer, part_acc, part_ml, T_,
      Hq, Hkv, S, s_extent, 1.0f / sqrtf((float)D), fault);
  return launch_merge<bf16, D>(part_acc, part_ml, out, out_m, out_l, B, T_, Hq, Hkv,
                               nsplit, stream);
}

}  // namespace mdt

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16; D: head_dim, 64
// or 128. Shapes: q and out [B, T, Hq, D]; k, v [L, B, S, Hkv*D]; a, lo, hi
// [B, T] int32 (a and lo may be null: 0); ksink [B, n_sink, Hkv*D] or null
// with n_sink = 0; colmask [L, B, 1, S] int32 (slot col of sequence b
// attended only where colmask[layer, b, 0, col] != 0) or null; out_m, out_l
// [B, T, Hq] f32 (the return_lse form: each row's merged m and l) or both
// null; part_acc [B, Hkv, nsplit, T*Hq/Hkv, D] and part_ml [.., 2] f32
// scratch with nsplit = ceil(s_extent / mdt_split_slots()). fault: 0, or 1
// (bf16 only) to plant the skipped-last-tile fault of the card checks.
// Returns the CUDA error code (0 = success).
extern "C" int mdt_split_slots() { return mdt::SPLIT; }

extern "C" int mdt_flash_decode(int dtype, int D, const void* q, const void* k,
                                const void* v, const int* a, const int* lo,
                                const int* hi, const void* ksink, int n_sink,
                                const int* colmask, void* out, float* out_m,
                                float* out_l, float* part_acc, float* part_ml,
                                int layer, int B, int T, int Hq, int Hkv, int S,
                                int s_extent, int fault, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mdt::Rows rows{a, lo, hi, ksink, n_sink, colmask};
#define MDT_ARGS q, k, v, rows, out, out_m, out_l, part_acc, part_ml, layer, B, T, Hq, Hkv, S, s_extent
  if (dtype == 0 && fault == 0) {
    if (D == 64) return mdt::dispatch_f32<64>(MDT_ARGS, st);
    if (D == 128) return mdt::dispatch_f32<128>(MDT_ARGS, st);
  }
  if (dtype == 1) {
    if (D == 64) return mdt::launch_bf16<64>(MDT_ARGS, fault, st);
    if (D == 128) return mdt::launch_bf16<128>(MDT_ARGS, fault, st);
  }
#undef MDT_ARGS
  return (int)cudaErrorInvalidValue;
}
