"""Flash attention over the packed KV cache: the decode and prefill kernels
of the port, each with its plain PyTorch version and a launch count.

`flash_decode_stacked` replaces magicdec_tpu/ops/pallas/flash_decode.py
flash_decode_stacked (pallas_call at :488, return_lse outputs :486-499),
`flash_decode_intervals` (and the flat `flash_decode` over it) replaces
flash_decode_intervals there (pallas_call at :370, return_lse outputs
:395-398), `flash_decode_stacked_masked` replaces
flash_decode_stacked_masked (pallas_call at :738), and `flash_prefill`
replaces flash_prefill (pallas_call at :646). All are hand-written CUDA C++
for sm_90a (csrc/flash_decode.cu, csrc/flash_prefill.cu, built by
ops/_build.py), templated on float32 and bfloat16 and on head_dim 64 and
128 (KERNEL_HEAD_DIMS); the three decode wrappers launch one split kernel, so
a sink + window draft and a ragged-causal verify give the same bits on the
same valid slots. bfloat16 runs on the tensor cores with K and V streamed
through a cp.async ring of bf16 shared tiles; float32 on CUDA cores with
exact f32 products.
What bounds each on the H100 and what its design does about it is noted at
the top of its source.

The wrappers take the JAX package's layouts: q [B, T, Hq, D] (rotated),
stacked k/v caches [L, B, S, Hkv*D] with `layer` an int (flat caches
[B, S, Hkv*D] for the intervals form), valid_upto [B, T] int32 — query
(b, t) attends to slots < valid_upto[b, t] — and s_cap bounding the attended
slots (callers guarantee valid_upto <= s_cap). With return_lse the stacked
and intervals forms also return each row's softmax state (m, l) [B, T, Hq]
in f32, for ops/attention.merge_lse, and count those launches apart
(`launches_lse`). On tensors on the CPU a wrapper runs the plain version
(the dense oracle on the layer slice); on CUDA tensors it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from magicdec_tpu_torch.ops import _build
from magicdec_tpu_torch.ops.attention import (masked_attention_general,
                                              masked_attention_lse)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


def _stacked_operands(q, k_cache, v_cache, layer, valid_upto, s_cap):
    """(q in the cache dtype, k, v [B, ext, Hkv, D] of layer `layer`'s first
    ext = min(s_cap, S) slots, mask [B, T, ext])."""
    _, B, S, HD = k_cache.shape
    D = q.shape[-1]
    ext = S if s_cap is None else min(s_cap, S)
    k = k_cache[layer, :, :ext].reshape(B, ext, HD // D, D)
    v = v_cache[layer, :, :ext].reshape(B, ext, HD // D, D)
    slot = torch.arange(ext, device=k_cache.device)
    return (q.to(k_cache.dtype), k, v,
            slot[None, None, :] < valid_upto[:, :, None])


def attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, layer: int,
                    valid_upto: torch.Tensor,
                    s_cap: int | None = None) -> torch.Tensor:
    """The plain version of both kernels: dense masked attention over layer
    `layer`'s first min(s_cap, S) slots. Returns [B, T, Hq, D] in the cache
    dtype (q is cast to it first, as the TPU kernels do)."""
    return masked_attention_general(*_stacked_operands(
        q, k_cache, v_cache, layer, valid_upto, s_cap))


def attention_plain_lse(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, layer: int,
                        valid_upto: torch.Tensor, s_cap: int | None = None):
    """The plain version of flash_decode_stacked(return_lse=True):
    (ctx [B, T, Hq, D] in the cache dtype, m, l [B, T, Hq] f32) of
    masked_attention_lse over the slots attention_plain attends. An empty
    row gives ctx = 0, m = NEG_INF and l = 0."""
    return masked_attention_lse(*_stacked_operands(
        q, k_cache, v_cache, layer, valid_upto, s_cap))


def _intervals_operands(q, k_cache, v_cache, sink_end, lo, hi, k_sink):
    """(q in the cache dtype, k, v [B, S, Hkv, D], mask [B, T, S]) of the
    flat cache's two-interval attention."""
    B, S, HD = k_cache.shape
    D = q.shape[-1]
    if k_sink is not None:
        k_cache = torch.cat([k_sink.to(k_cache.dtype),
                             k_cache[:, k_sink.shape[1]:]], dim=1)
    slot = torch.arange(S, device=k_cache.device)
    mask = ((slot < sink_end[..., None])
            | ((slot >= lo[..., None]) & (slot < hi[..., None])))
    return (q.to(k_cache.dtype), k_cache.reshape(B, S, HD // D, D),
            v_cache.reshape(B, S, HD // D, D), mask)


def intervals_plain(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, sink_end: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor,
                    k_sink: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of flash_decode_intervals: dense attention over the
    flat cache [B, S, Hkv*D] with the two-interval mask, query (b, t)
    attending to slots [0, sink_end) u [lo, hi); with k_sink [B, n, Hkv*D]
    the K of slots < n is k_sink's. Returns [B, T, Hq, D] in the cache
    dtype."""
    return masked_attention_general(*_intervals_operands(
        q, k_cache, v_cache, sink_end, lo, hi, k_sink))


def intervals_plain_lse(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, sink_end: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor,
                        k_sink: torch.Tensor | None = None):
    """The plain version of flash_decode_intervals(return_lse=True): (ctx,
    m, l) of masked_attention_lse over the slots intervals_plain attends."""
    return masked_attention_lse(*_intervals_operands(
        q, k_cache, v_cache, sink_end, lo, hi, k_sink))


def stacked_masked_plain(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, layer: int,
                         colmask: torch.Tensor, sink_end: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The plain version of flash_decode_stacked_masked: dense attention
    over layer `layer` of the stacked cache [L, B, R, Hkv*D], query (b, t)
    attending to slot col iff col lies in [0, sink_end) u [lo, hi) and
    colmask[layer, b, 0, col] != 0 (what the JAX package computes off the
    TPU, magicdec_tpu/engine/retro.py _tail_attend). Returns [B, T, Hq, D]
    in the cache dtype."""
    _, B, R, HD = k_cache.shape
    D = q.shape[-1]
    col = torch.arange(R, device=k_cache.device)
    mask = (((col < sink_end[..., None])
             | ((col >= lo[..., None]) & (col < hi[..., None])))
            & (colmask[layer, :, 0][:, None, :] != 0))
    return masked_attention_general(q.to(k_cache.dtype),
                                    k_cache[layer].reshape(B, R, HD // D, D),
                                    v_cache[layer].reshape(B, R, HD // D, D),
                                    mask)


def _ref_and_limit(plain, q, k, v):
    """plain(q, k, v) in float32 and the per-element limit on |kernel -
    plain| that the kernels' arithmetic allows (see plain_f32_and_limit)."""
    ref = plain(q.float(), k.float(), v.float())
    if k.dtype == torch.float32:
        return ref, 2e-5 + 2e-5 * ref.abs()
    ref_abs = plain(q.float(), k.float(), v.float().abs())
    return ref, 1.1 * 2.0 ** -8 * (ref.abs() + ref_abs) + 1e-5


def lse_limits(m_ref: torch.Tensor, l_ref: torch.Tensor, dtype):
    """The limits on |kernel - plain| of the return_lse outputs, against
    the plain (m, l) computed in float32 from the same inputs. Both kernels
    compute the logits and l in f32 from the operands in the cache dtype
    (l sums the unrounded P), so only summation order differs: m within
    1e-5 (1 + |m|); l within 2e-5 + 2e-5 l in float32 and, for bfloat16
    caches, within ctx's relative rounding bound, 2^-8 l + 1e-5. Compare m
    only where l > 0 (an empty row's m is NEG_INF in the kernel, the
    dtype's minimum in the plain version)."""
    lim_l = (2e-5 + 2e-5 * l_ref if dtype == torch.float32
             else 2.0 ** -8 * l_ref + 1e-5)
    return 1e-5 * (1.0 + m_ref.abs()), lim_l


def plain_f32_and_limit(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, layer: int,
                        valid_upto: torch.Tensor, s_cap: int | None = None):
    """What a kernel's output is held against: the plain version computed in
    float32 from the same inputs, and the per-element limit on
    |kernel - plain| that the kernels' arithmetic allows.

    float32 caches: 2e-5 + 2e-5*|ref|, the JAX kernel tests' tolerance (an
    online softmax over tiles against one softmax).
    bfloat16 caches: both kernels round P to bf16 before P@V (each p off by
    at most 2^-8 of itself, so the output by at most 2^-8 * sum(p|v|)/l) and
    round the output to bf16 (at most 2^-8 of it); f32 accumulation adds
    ~1e-6 of sum(p|v|)/l. The limit is that rounding bound plus 10%, plus
    1e-5: 1.1 * 2^-8 * (|ref| + ref_abs) + 1e-5, where ref_abs =
    sum(p|v|)/l is the plain version with |v|. It scales with what is
    compared, so a kernel that drops or mis-masks a tile fails it even where
    the softmax is flat and outputs are small.
    Returns (ref f32, limit f32), both [B, T, Hq, D]."""
    return _ref_and_limit(
        lambda q_, k_, v_: attention_plain(q_, k_, v_, layer, valid_upto,
                                           s_cap), q, k_cache, v_cache)


def intervals_plain_f32_and_limit(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  sink_end: torch.Tensor, lo: torch.Tensor,
                                  hi: torch.Tensor,
                                  k_sink: torch.Tensor | None = None):
    """plain_f32_and_limit for flash_decode_intervals (flat cache, two
    intervals, optional sink K rows): the same limit, since the kernel is
    the same split kernel."""
    ks = None if k_sink is None else k_sink.float()
    return _ref_and_limit(
        lambda q_, k_, v_: intervals_plain(q_, k_, v_, sink_end, lo, hi, ks),
        q, k_cache, v_cache)


def stacked_masked_plain_f32_and_limit(q: torch.Tensor, k_cache: torch.Tensor,
                                       v_cache: torch.Tensor, layer: int,
                                       colmask: torch.Tensor,
                                       sink_end: torch.Tensor,
                                       lo: torch.Tensor, hi: torch.Tensor):
    """plain_f32_and_limit for flash_decode_stacked_masked: the same limit,
    since the kernel is the same split kernel."""
    return _ref_and_limit(
        lambda q_, k_, v_: stacked_masked_plain(q_, k_, v_, layer, colmask,
                                                sink_end, lo, hi),
        q, k_cache, v_cache)


def _check(q, k_cache, v_cache, layer, valid_upto):
    """Validate the kernels' operands; returns the (cast) q."""
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda
            and valid_upto.is_cuda):
        raise ValueError("flash kernels need every operand on the same CUDA "
                         "device (or every operand on the CPU)")
    if len({q.device, k_cache.device, v_cache.device,
            valid_upto.device}) != 1:
        raise ValueError("flash kernel operands lie on different devices")
    if k_cache.dtype not in _DTYPE_CODES or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"cache dtype {k_cache.dtype}/{v_cache.dtype}: the "
                         "kernels take float32 or bfloat16")
    if valid_upto.dtype != torch.int32:
        raise ValueError("valid_upto must be int32")
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    B, T, Hq, D = q.shape
    L, Bc, S, HD = k_cache.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels are built for head_dim "
                         f"{' and '.join(map(str, KERNEL_HEAD_DIMS))}")
    if Bc != B or HD % D or Hq % (HD // D):
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    if tuple(valid_upto.shape) != (B, T):
        raise ValueError(f"valid_upto {tuple(valid_upto.shape)} != {(B, T)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    q = q.to(k_cache.dtype)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_upto", valid_upto)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return q


def _check_rows(hi, **rows):
    """Validate row bounds [B, T] beside hi."""
    for name, t in rows.items():
        if (t.dtype != torch.int32 or t.shape != hi.shape
                or t.device != hi.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape {tuple(hi.shape)} on {hi.device}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {rc}")


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib_decode() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.mdt_flash_decode
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                       _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        lib.mdt_split_slots.restype = _I
    return lib


def _lib_prefill() -> ctypes.CDLL:
    lib = _build.load("flash_prefill")
    fn = lib.mdt_flash_prefill
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _P]
        fn.restype = _I
    return lib


def split_slots() -> int:
    """The decode kernel's KV split size in slots (SPLIT in
    csrc/flash_decode.cu): one global constant, so a row's bits never depend
    on the cache capacity."""
    return _lib_decode().mdt_split_slots()


def _decode_launch(q, k_cache, v_cache, layer, hi, ext, a=None, lo=None,
                   k_sink=None, colmask=None, lse=False, fault=0):
    """Launch the split decode kernel on checked operands (stacked caches);
    returns [B, T, Hq, D] in the cache dtype, with lse also (m, l)
    [B, T, Hq] f32. fault=1 (bf16 only) plants the card checks' pipeline
    fault: each split's last tile is copied but not computed."""
    B, T, Hq, D = q.shape
    _, _, S, HD = k_cache.shape
    Hkv = HD // D
    if T * (Hq // Hkv) > 64:
        raise ValueError(f"T*G = {T * (Hq // Hkv)} > 64: use flash_prefill")
    lib = _lib_decode()
    nsplit = -(-ext // split_slots())
    M = T * (Hq // Hkv)
    out = torch.empty_like(q)
    m = l = None
    if lse:
        m = torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    part_acc = torch.empty((B, Hkv, nsplit, M, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, Hkv, nsplit, M, 2), dtype=torch.float32,
                          device=q.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = lib.mdt_flash_decode(
        _DTYPE_CODES[k_cache.dtype], D, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), ptr(a), ptr(lo), hi.data_ptr(), ptr(k_sink),
        0 if k_sink is None else k_sink.shape[1], ptr(colmask), out.data_ptr(),
        ptr(m), ptr(l), part_acc.data_ptr(), part_ml.data_ptr(), layer, B, T,
        Hq, Hkv, S, ext, fault, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash decode launch")
    return (out, m, l) if lse else out


def _count(wrapper, lse: bool) -> None:
    if lse:
        wrapper.launches_lse += 1
    else:
        wrapper.launches += 1


def flash_decode_stacked(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, layer: int,
                         valid_upto: torch.Tensor,
                         s_cap: int | None = None, return_lse: bool = False):
    """Decode / verify / draft attention (T*G <= 64 rows per KV head) over
    one layer of the stacked cache. Returns [B, T, Hq, D] in the cache dtype;
    with return_lse (ctx, m, l), m and l [B, T, Hq] in f32 (an empty row:
    ctx 0, m NEG_INF, l 0).

    Replaces the TPU kernel flash_decode_stacked (pallas_call at
    magicdec_tpu/ops/pallas/flash_decode.py:488, return_lse :486-499).
    Bound by bytes on the H100 (each valid K/V slot read once); the kernel
    splits KV over CTAs in fixed splits of split_slots() slots so B=8 fills
    the SMs, streams bf16 tiles through a cp.async ring into tensor-core
    products, reads nothing past a row's bound, and merges the splits in
    order so rows are bit-exact across T and cache capacity; ctx has the
    same bits with and without return_lse (csrc/flash_decode.cu)."""
    if _on_cpu(q, k_cache, v_cache, valid_upto):
        plain = attention_plain_lse if return_lse else attention_plain
        return plain(q, k_cache, v_cache, layer, valid_upto, s_cap)
    q = _check(q, k_cache, v_cache, layer, valid_upto)
    S = k_cache.shape[2]
    out = _decode_launch(q, k_cache, v_cache, layer, valid_upto,
                         S if s_cap is None else min(s_cap, S), lse=return_lse)
    _count(flash_decode_stacked, return_lse)
    return out


flash_decode_stacked.launches = 0
flash_decode_stacked.launches_lse = 0


def flash_decode_intervals(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, sink_end: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor,
                           k_sink: torch.Tensor | None = None,
                           return_lse: bool = False):
    """Two-interval decode attention over a flat cache: q [B, T, Hq, D]
    (T*G <= 64), k/v [B, S, Hkv*D], sink_end/lo/hi [B, T] int32 — query
    (b, t) attends to slots [0, sink_end) u [lo, hi). k_sink [B, n, Hkv*D]
    (optional): the K of slots < n is read from it in place of k_cache's
    (the StreamingLLM draft's rope-twisted sink rows, so the cache layer is
    never copied). Returns [B, T, Hq, D] in the cache dtype; with return_lse
    (ctx, m, l) as flash_decode_stacked's.

    Replaces the TPU kernel flash_decode_intervals (pallas_call at
    magicdec_tpu/ops/pallas/flash_decode.py:370, return_lse :395-398). It
    launches flash_decode_stacked's split kernel with the two intervals, so
    it keeps that kernel's bound (bytes), splits, tiles and merge order;
    tiles inside every row's gap are skipped."""
    if _on_cpu(q, k_cache, v_cache, sink_end, lo, hi):
        plain = intervals_plain_lse if return_lse else intervals_plain
        return plain(q, k_cache, v_cache, sink_end, lo, hi, k_sink)
    if k_cache.dim() != 3:
        raise ValueError(f"flat cache [B, S, Hkv*D] expected, got "
                         f"{tuple(k_cache.shape)}")
    kc, vc = k_cache.unsqueeze(0), v_cache.unsqueeze(0)
    q = _check(q, kc, vc, 0, hi)
    _check_rows(hi, sink_end=sink_end, lo=lo)
    if k_sink is not None:
        B, S, HD = k_cache.shape
        if (k_sink.dim() != 3 or k_sink.shape[0] != B or k_sink.shape[2] != HD
                or k_sink.shape[1] > S or k_sink.dtype != k_cache.dtype
                or k_sink.device != k_cache.device
                or not k_sink.is_contiguous() or k_sink.data_ptr() % 16):
            raise ValueError(f"k_sink {tuple(k_sink.shape)} {k_sink.dtype}: "
                             f"contiguous [B, n <= S, Hkv*D] in the cache "
                             f"dtype, 16-byte aligned, on the cache's device")
    out = _decode_launch(q, kc, vc, 0, hi, k_cache.shape[1], a=sink_end,
                         lo=lo, k_sink=k_sink, lse=return_lse)
    _count(flash_decode_intervals, return_lse)
    return out


flash_decode_intervals.launches = 0
flash_decode_intervals.launches_lse = 0


def flash_decode_stacked_masked(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, layer: int,
                                colmask: torch.Tensor, sink_end: torch.Tensor,
                                lo: torch.Tensor, hi: torch.Tensor
                                ) -> torch.Tensor:
    """Decode attention over one layer of a stacked round buffer [L, B, R,
    Hkv*D] with two-interval row bounds and per-column bits: query (b, t)
    (T*G <= 64) attends to slot col iff col lies in [0, sink_end) u [lo, hi)
    and colmask[layer, b, 0, col] != 0. colmask [L, B, 1, R] int32;
    sink_end/lo/hi [B, T] int32. The Quest draft passes sink_end = lo = NS
    (the gathered top region, gated by its bits) and hi = NS + the causal
    tail bound. Returns [B, T, Hq, D] in the cache dtype.

    Replaces the TPU kernel flash_decode_stacked_masked (pallas_call at
    magicdec_tpu/ops/pallas/flash_decode.py:738). It launches
    flash_decode_stacked's split kernel with the bits, so it keeps that
    kernel's bound (bytes), splits, tiles and merge order; tiles whose 64
    bits are all 0 are skipped and only tiles whose bits are all set run
    unmasked (csrc/flash_common.cuh attend_range)."""
    if _on_cpu(q, k_cache, v_cache, colmask, sink_end, lo, hi):
        return stacked_masked_plain(q, k_cache, v_cache, layer, colmask,
                                    sink_end, lo, hi)
    q = _check(q, k_cache, v_cache, layer, hi)
    _check_rows(hi, sink_end=sink_end, lo=lo)
    L, B, R, _ = k_cache.shape
    if (colmask.dtype != torch.int32 or tuple(colmask.shape) != (L, B, 1, R)
            or colmask.device != k_cache.device
            or not colmask.is_contiguous()):
        raise ValueError(f"colmask {tuple(colmask.shape)} {colmask.dtype}: "
                         f"contiguous int32 [{L}, {B}, 1, {R}] on the cache's "
                         f"device")
    out = _decode_launch(q, k_cache, v_cache, layer, hi, R, a=sink_end, lo=lo,
                         colmask=colmask)
    flash_decode_stacked_masked.launches += 1
    return out


flash_decode_stacked_masked.launches = 0


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid_upto: torch.Tensor
                 ) -> torch.Tensor:
    """Ragged-causal flash decode over a flat cache [B, S, Hkv*D]: query
    (b, t) attends to slots < valid_upto[b, t] (flash_decode_intervals with
    empty sink and window start 0, as the JAX package's flash_decode)."""
    zero = torch.zeros_like(valid_upto)
    return flash_decode_intervals(q, k_cache, v_cache, zero, zero, valid_upto)


def flash_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, layer: int,
                  valid_upto: torch.Tensor,
                  s_cap: int | None = None) -> torch.Tensor:
    """Chunked-prefill attention over one layer of the stacked cache.
    Returns [B, T, Hq, D] in the cache dtype.

    Replaces the TPU kernel flash_prefill (pallas_call at
    magicdec_tpu/ops/pallas/flash_decode.py:646). Bound by FLOPs on the
    H100 for late chunks; the kernel walks only the tiles below each query
    tile's causal frontier and s_cap, masks only the diagonal tiles, and runs
    bf16 on the tensor cores, 128 query rows a CTA, K and V streamed through
    a cp.async ring (csrc/flash_prefill.cu)."""
    if _on_cpu(q, k_cache, v_cache, valid_upto):
        return attention_plain(q, k_cache, v_cache, layer, valid_upto, s_cap)
    q = _check(q, k_cache, v_cache, layer, valid_upto)
    S = k_cache.shape[2]
    out = _prefill_launch(q, k_cache, v_cache, layer, valid_upto,
                          S if s_cap is None else min(s_cap, S))
    flash_prefill.launches += 1
    return out


def _prefill_launch(q, k_cache, v_cache, layer, valid_upto, ext, fault=0):
    """Launch the prefill kernel on checked operands; fault=1 (bf16 only)
    plants the card checks' pipeline fault (the last tile copied but not
    computed)."""
    B, T, Hq, D = q.shape
    _, _, S, HD = k_cache.shape
    out = torch.empty_like(q)
    rc = _lib_prefill().mdt_flash_prefill(
        _DTYPE_CODES[k_cache.dtype], D, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), valid_upto.data_ptr(), out.data_ptr(), layer, B, T,
        Hq, HD // D, S, ext, fault,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_prefill launch")
    return out


flash_prefill.launches = 0
