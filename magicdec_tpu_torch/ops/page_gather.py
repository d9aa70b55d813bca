"""Page gathers: copy selected pages of one layer, with their plain PyTorch
versions, launch counts and the kernel's launch geometry.

`page_gather` replaces magicdec_tpu/ops/pallas/page_gather.py page_gather
(pallas_call at :231 in DMA mode and :268 in grid mode) and
`page_gather_single` replaces page_gather_single there (pallas_call at :142
in DMA mode and :169 in grid mode). Each call is one launch of a
hand-written CUDA C++ kernel for sm_90a (csrc/page_gather.cu, built by
ops/_build.py): Hopper bulk async copies of CHUNK_BYTES chunks through a
ring of STAGES shared-memory stages, one single-warp CTA an SM. The Quest
draft runs `page_gather` once per layer at the
start of each round, to fill the round buffer's top region with the
top-scored pages of the K and V caches; the RetroInfer and
SqueezedAttention drafts run `page_gather_single` there on their KV-fused
cluster store (a cluster's K rows followed by its V rows), splitting each
cluster into the K and V top regions in one launch. With `out` both write
into the round buffer directly.

On tensors on the CPU the wrappers run the plain versions (indexed copies);
on CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from magicdec_tpu_torch.ops import _build

# The kernel's fixed geometry, chosen on the card among the ones that
# chip_smoke.py `gather_variants` times (PERF.md): bytes per bulk copy, ring
# stages a CTA, CTAs an SM. The C entry rejects a ring beyond its limits.
CHUNK_BYTES = 16 * 1024
STAGES = 12
CTAS_PER_SM = 1


def _slots(pages: torch.Tensor, page: int, n_src_pages: int) -> torch.Tensor:
    """[B, n * page] source rows of the pages (indices clamped into
    [0, n_src_pages), as the kernel clamps them)."""
    p = pages.long().clamp(0, n_src_pages - 1)
    rows = torch.arange(page, device=pages.device)
    return (p[:, :, None] * page + rows).reshape(p.shape[0], -1)


def _take_pages(src: torch.Tensor, layer: int, pages: torch.Tensor,
                page: int) -> torch.Tensor:
    """src [L, B, R, HD] pages pages[b, :] of layer `layer` ->
    [B, n, page, HD], a new tensor."""
    _, B, R, HD = src.shape
    b_idx = torch.arange(B, device=pages.device)[:, None]
    return src[layer][b_idx, _slots(pages, page, R // page)].reshape(
        B, pages.shape[1], page, HD)


def page_gather_plain(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      layer: int, pages: torch.Tensor, page: int = 128
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (k_sel, v_sel) [B, n, page, HD], sequence b's
    j-th block being rows [p*page, (p+1)*page) of k/v_cache[layer, b] with
    p = pages[b, j]."""
    return (_take_pages(k_cache, layer, pages, page),
            _take_pages(v_cache, layer, pages, page))


def page_gather_single_plain(store: torch.Tensor, layer: int,
                             pages: torch.Tensor, page: int) -> torch.Tensor:
    """The plain version of page_gather_single: [B, n, page, HD], block
    (b, j) being rows [p*page, (p+1)*page) of store[layer, b] with
    p = pages[b, j]."""
    return _take_pages(store, layer, pages, page)


class Geometry(NamedTuple):
    """One launch's work: `units` units (part, sequence, page) of
    unit_bytes, each cut into chunks_per_unit chunks of chunk_bytes, the
    last one tail_bytes long; chunk i belongs to unit i // chunks_per_unit,
    and CTA c of the `grid` walks chunks c, c + grid, ... through `stages`
    ring stages of chunk_bytes."""
    units: int
    unit_bytes: int
    chunk_bytes: int
    chunks_per_unit: int
    tail_bytes: int
    grid: int
    stages: int


def geometry(units: int, unit_bytes: int, sms: int,
             chunk_bytes: int = CHUNK_BYTES, stages: int = STAGES,
             ctas_per_sm: int = CTAS_PER_SM) -> Geometry:
    """The launch geometry of `units` units of unit_bytes (a multiple of 16)
    on a card of `sms` SMs: chunks of at most chunk_bytes, a grid of
    ctas_per_sm CTAs an SM (never more CTAs than chunks), `stages` ring
    stages."""
    if unit_bytes <= 0 or unit_bytes % 16 or chunk_bytes <= 0 or chunk_bytes % 16:
        raise ValueError(f"unit of {unit_bytes} bytes, chunks of {chunk_bytes}:"
                         f" both must be positive multiples of 16")
    chunk = min(chunk_bytes, unit_bytes)
    per_unit = -(-unit_bytes // chunk)
    grid = min(units * per_unit, ctas_per_sm * sms)
    return Geometry(units, unit_bytes, chunk, per_unit,
                    unit_bytes - (per_unit - 1) * chunk, grid, stages)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("page_gather")
    fn = lib.mdt_page_gather
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, I, I, I, I, LL, LL, LL, LL,
                       I, I, I, I, I, I, P]
        fn.restype = I
    return lib


def _check_out(o: torch.Tensor, like: torch.Tensor, shape: tuple):
    """An output [B, n, rows, HD]: sequence b's blocks contiguous, any
    (16-byte multiple) sequence stride, e.g. a view of a round buffer's top
    region at one layer."""
    B, n, rows, HD = shape
    if (tuple(o.shape) != shape or o.dtype != like.dtype
            or o.device != like.device
            or o.stride()[1:] != (rows * HD, HD, 1)
            or (o.stride(0) * o.element_size()) % 16 or o.data_ptr() % 16):
        raise ValueError(f"out {tuple(o.shape)} strides {o.stride()}: need "
                         f"{shape} in {like.dtype} on {like.device} with each "
                         f"sequence's blocks contiguous, 16-byte aligned")


def _check_operands(what: str, srcs, pages, layer: int, page: int, out):
    """Device, type, shape and alignment checks of a CUDA launch."""
    tensors = tuple(srcs) + (pages,) + tuple(out)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} needs every operand on one CUDA device "
                         "(or every operand on the CPU)")
    s0 = srcs[0]
    L, B, R, HD = s0.shape
    if any(s.shape != s0.shape or s.dtype != s0.dtype or not s.is_contiguous()
           or s.data_ptr() % 16 for s in srcs) or (HD * s0.element_size()) % 16:
        raise ValueError(f"{what}: sources {tuple(s0.shape)} {s0.dtype} must "
                         f"be equal contiguous 16-byte aligned tensors with "
                         f"rows of a multiple of 16 bytes")
    if R % page:
        raise ValueError(f"{what}: source length {R} is not a multiple of "
                         f"page {page}")
    if (pages.dtype != torch.int32 or pages.dim() != 2
            or pages.shape[0] != B or not pages.is_contiguous()):
        raise ValueError(f"{what}: pages {tuple(pages.shape)} {pages.dtype}: "
                         f"need contiguous int32 [{B}, n]")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    if len(out) == 2 and out[0].stride(0) != out[1].stride(0):
        raise ValueError(f"{what}: out K and V need the same sequence stride")


def _launch(src0, src1, pages, out, layer: int, page: int, rows: int,
            fault: int = 0, **knobs):
    """One launch on checked operands: part z copies `rows` rows of each
    selected page (pages of `page` rows) from source z (src1: a byte address,
    or None for one part) into out[z]. fault and the geometry knobs
    (chunk_bytes, stages, ctas_per_sm; the fixed geometry by default) are
    chip_smoke's: its planted fault (each unit's last chunk dropped) and its
    sweep of geometries."""
    L, B, R, HD = src0.shape
    parts, n = len(out), pages.shape[1]
    row_bytes = HD * src0.element_size()
    g = geometry(parts * B * n, rows * row_bytes, _sms(src0.device.index),
                 **knobs)
    layer_bytes = layer * B * R * row_bytes
    rc = _lib().mdt_page_gather(
        src0.data_ptr() + layer_bytes,
        None if src1 is None else src1 + layer_bytes,
        pages.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr() if parts == 2 else None, parts, B, n, R // page,
        R * row_bytes, page * row_bytes,
        out[0].stride(0) * out[0].element_size(), rows * row_bytes,
        g.chunk_bytes, g.chunks_per_unit, g.tail_bytes, g.grid, g.stages,
        fault, torch.cuda.current_stream(src0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"page gather launch failed with cudaError_t {rc}")


def _gather_launch(k_cache, v_cache, layer: int, pages, page: int, out,
                   **private):
    """page_gather's checked launch into the output pair `out`; `private`
    as _launch's."""
    _, B, _, HD = k_cache.shape
    _check_operands("page_gather", (k_cache, v_cache), pages, layer, page, out)
    for o in out:
        _check_out(o, k_cache, (B, pages.shape[1], page, HD))
    _launch(k_cache, v_cache.data_ptr(), pages, out, layer, page, page,
            **private)


def _single_launch(store, layer: int, pages, page: int, out, **private):
    """page_gather_single's checked launch: out = (blocks,) takes whole
    pages, out = (out_k, out_v) each page's two halves; `private` as
    _launch's."""
    _, B, _, HD = store.shape
    _check_operands("page_gather_single", (store,), pages, layer, page, out)
    rows = page // len(out)
    for o in out:
        _check_out(o, store, (B, pages.shape[1], rows, HD))
    _launch(store, (store.data_ptr() + rows * HD * store.element_size()
                    if len(out) == 2 else None),
            pages, out, layer, page, rows, **private)


def page_gather(k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int,
                pages: torch.Tensor, page: int = 128,
                out: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Copy the pages pages[b, :] (int32 [B, n], page indices into the S //
    page pages of a sequence) of layer `layer` of k_cache/v_cache [L, B, S,
    HD] into (k_sel, v_sel) [B, n, page, HD], bit for bit. out: an optional
    pair of such outputs to write into (each sequence's n pages contiguous,
    any sequence stride). Returns the outputs.

    Replaces the TPU kernel page_gather (pallas_call at
    magicdec_tpu/ops/pallas/page_gather.py:231 and :268). Bound by bytes on
    the H100 (each selected row read and written once); chunks of the pages
    copied by bulk async copies through a shared-memory ring
    (csrc/page_gather.cu)."""
    _, B, _, HD = k_cache.shape
    tensors = (k_cache, v_cache, pages) + (() if out is None else tuple(out))
    if all(t.device.type == "cpu" for t in tensors):
        k_sel, v_sel = page_gather_plain(k_cache, v_cache, layer, pages, page)
        if out is None:
            return k_sel, v_sel
        out[0].copy_(k_sel)
        out[1].copy_(v_sel)
        return out
    if out is None:
        out = tuple(torch.empty((B, pages.shape[1], page, HD),
                                dtype=k_cache.dtype, device=k_cache.device)
                    for _ in range(2))
    _gather_launch(k_cache, v_cache, layer, pages, page, out)
    page_gather.launches += 1
    return out


page_gather.launches = 0


def page_gather_single(store: torch.Tensor, layer: int, pages: torch.Tensor,
                       page: int,
                       out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Copy the pages pages[b, :] (int32 [B, n], page indices into the R //
    page pages of a sequence) of layer `layer` of store [L, B, R, HD], bit
    for bit. Without out: returns [B, n, page, HD] (the JAX function). With
    out = (out_k, out_v), each [B, n, page // 2, HD] (each sequence's blocks
    contiguous, any sequence stride): the first half of every page goes to
    out_k and the second to out_v, e.g. a KV-fused store's cluster K and V
    rows into the round buffer's K and V top regions; returns out.

    Replaces the TPU kernel page_gather_single (pallas_call at
    magicdec_tpu/ops/pallas/page_gather.py:142 and :169). Bound by bytes on
    the H100; the kernel of page_gather with the store's two halves as its
    two parts (csrc/page_gather.cu), one launch."""
    _, B, _, HD = store.shape
    if out is not None and page % 2:
        raise ValueError(f"page_gather_single: an output pair splits a page "
                         f"in halves; page {page} is odd")
    tensors = (store, pages) + (() if out is None else tuple(out))
    if all(t.device.type == "cpu" for t in tensors):
        blocks = page_gather_single_plain(store, layer, pages, page)
        if out is None:
            return blocks
        out[0].copy_(blocks[:, :, :page // 2])
        out[1].copy_(blocks[:, :, page // 2:])
        return out
    if out is None:
        res = torch.empty((B, pages.shape[1], page, HD), dtype=store.dtype,
                          device=store.device)
        _single_launch(store, layer, pages, page, (res,))
    else:
        res = out
        _single_launch(store, layer, pages, page, out)
    page_gather_single.launches += 1
    return res


page_gather_single.launches = 0


def page_gather_sharded(k_cache: torch.Tensor, v_cache: torch.Tensor,
                        layer: int, pages: torch.Tensor, page: int = 128, *,
                        mesh=None,
                        out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """page_gather on one tp rank's shard: k/v_cache [L, B, S, (Hkv/tp)*D],
    the rank's whole KV heads (parallel/sharding.local_config checks the
    partition). The ranks gather the same pages, each its own columns, with
    no collective. Off-mesh (mesh None or tp 1) it is page_gather.

    Replaces page_gather_sharded (the shard_map of the TPU kernel,
    magicdec_tpu/ops/pallas/page_gather.py:193): one launch of page_gather's
    kernel on the shard, counted on both wrappers."""
    res = page_gather(k_cache, v_cache, layer, pages, page, out=out)
    if mesh is not None and mesh.tp > 1 and k_cache.is_cuda:
        page_gather_sharded.launches += 1
    return res


page_gather_sharded.launches = 0


def page_gather_single_sharded(store: torch.Tensor, layer: int,
                               pages: torch.Tensor, page: int, *, mesh=None,
                               out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """page_gather_single on one tp rank's shard of the KV-fused store
    [L, B, R, (Hkv/tp)*D]. Off-mesh it is page_gather_single.

    Replaces page_gather_single_sharded (magicdec_tpu/ops/pallas/
    page_gather.py:178): one launch of page_gather_single's kernel on the
    shard, counted on both wrappers."""
    res = page_gather_single(store, layer, pages, page, out=out)
    if mesh is not None and mesh.tp > 1 and store.is_cuda:
        page_gather_single_sharded.launches += 1
    return res


page_gather_single_sharded.launches = 0
