"""Page gather: copy selected pages of one layer of the K and V caches, with
its plain PyTorch version and a launch count.

`page_gather` replaces magicdec_tpu/ops/pallas/page_gather.py page_gather
(pallas_call at :231 in DMA mode and :268 in grid mode) with a hand-written
CUDA C++ kernel for sm_90a (csrc/page_gather.cu, built by ops/_build.py).
The Quest draft runs it once per layer at the start of each round, to fill
the round buffer's top region with the top-scored pages; with `out` it
writes there directly.

On tensors on the CPU the wrapper runs the plain version (one indexed copy
per tensor); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from magicdec_tpu_torch.ops import _build


def _slots(pages: torch.Tensor, page: int, n_src_pages: int) -> torch.Tensor:
    """[B, n * page] source slots of the pages (indices clamped into
    [0, n_src_pages), as the kernel clamps them)."""
    p = pages.long().clamp(0, n_src_pages - 1)
    rows = torch.arange(page, device=pages.device)
    return (p[:, :, None] * page + rows).reshape(p.shape[0], -1)


def page_gather_plain(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      layer: int, pages: torch.Tensor, page: int = 128
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (k_sel, v_sel) [B, n, page, HD], sequence b's
    j-th block being rows [p*page, (p+1)*page) of k/v_cache[layer, b] with
    p = pages[b, j]."""
    _, B, S, HD = k_cache.shape
    n = pages.shape[1]
    slots = _slots(pages, page, S // page)
    b_idx = torch.arange(B, device=pages.device)[:, None]
    return (k_cache[layer][b_idx, slots].reshape(B, n, page, HD),
            v_cache[layer][b_idx, slots].reshape(B, n, page, HD))


def _lib() -> ctypes.CDLL:
    lib = _build.load("page_gather")
    fn = lib.mdt_page_gather
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, ctypes.c_longlong, P]
        fn.restype = I
    return lib


def _check_out(o: torch.Tensor, like: torch.Tensor, shape: tuple):
    """An output [B, n, page, HD]: sequence b's pages contiguous, any
    (16-byte multiple) sequence stride, e.g. a view of a round buffer's top
    region at one layer."""
    B, n, page, HD = shape
    if (tuple(o.shape) != shape or o.dtype != like.dtype
            or o.device != like.device
            or o.stride()[1:] != (page * HD, HD, 1)
            or (o.stride(0) * o.element_size()) % 16 or o.data_ptr() % 16):
        raise ValueError(f"out {tuple(o.shape)} strides {o.stride()}: need "
                         f"{shape} in {like.dtype} on {like.device} with each "
                         f"sequence's pages contiguous, 16-byte aligned")


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
    the H100 (each selected row read and written once); one CTA per page and
    tensor copies with 16-byte vectors (csrc/page_gather.cu)."""
    L, B, S, HD = k_cache.shape
    n = pages.shape[1]
    shape = (B, n, page, HD)
    tensors = (k_cache, v_cache, pages) + (() if out is None else tuple(out))
    if all(t.device.type == "cpu" for t in tensors):
        k_sel, v_sel = page_gather_plain(k_cache, v_cache, layer, pages, page)
        if out is None:
            return k_sel, v_sel
        out[0].copy_(k_sel)
        out[1].copy_(v_sel)
        return out
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("page_gather needs every operand on one CUDA device "
                         "(or every operand on the CPU)")
    if (v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype
            or not (k_cache.is_contiguous() and v_cache.is_contiguous())
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16
            or (HD * k_cache.element_size()) % 16):
        raise ValueError(f"k/v {tuple(k_cache.shape)} {k_cache.dtype}: need "
                         f"equal contiguous 16-byte aligned caches with rows "
                         f"of a multiple of 16 bytes")
    if S % page:
        raise ValueError(f"cache length {S} is not a multiple of page {page}")
    if (pages.dtype != torch.int32 or pages.dim() != 2
            or pages.shape[0] != B or not pages.is_contiguous()):
        raise ValueError(f"pages {tuple(pages.shape)} {pages.dtype}: need "
                         f"contiguous int32 [{B}, n]")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    if out is None:
        out = (torch.empty(shape, dtype=k_cache.dtype, device=k_cache.device),
               torch.empty(shape, dtype=k_cache.dtype, device=k_cache.device))
    for o in out:
        _check_out(o, k_cache, shape)
    if out[0].stride(0) != out[1].stride(0):
        raise ValueError("out K and V need the same sequence stride")
    rc = _lib().mdt_page_gather(
        k_cache.data_ptr(), v_cache.data_ptr(), pages.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), layer, B, S, n, page,
        HD * k_cache.element_size(), out[0].stride(0) * out[0].element_size(),
        torch.cuda.current_stream(k_cache.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"page_gather launch failed with cudaError_t {rc}")
    page_gather.launches += 1
    return out


page_gather.launches = 0
