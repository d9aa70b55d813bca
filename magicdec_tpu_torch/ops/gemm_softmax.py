"""Centroid scoring for the clustered-KV drafts: q . centroids, softmax over
the centroids, summed over the query rows of each KV head; with its plain
PyTorch version and a launch count.

`centroid_scores` replaces magicdec_tpu/ops/pallas/gemm_softmax.py
centroid_scores (pallas_call at :50) with a hand-written CUDA C++ kernel for
sm_90a (csrc/centroid_scores.cu, built by ops/_build.py). The RetroInfer
draft runs it once per layer at the start of each round to rank the
clusters. The centroids are taken in the JAX package's [B, Hkv, C, D]
layout as any strided view, so the port passes a view of its
[L, B, C, Hkv*D] centroids and nothing is copied.

On tensors on the CPU the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from magicdec_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# a CTA keeps a (sequence, KV head)'s query rows, a tile of its centroids
# and its logits in shared memory: at most this many bytes (the H100's
# per-block limit); a tile holds up to this many floats
_SMEM_LIMIT = 227 * 1024
_TILE_FLOATS = 128 * 132
# the kernel splits C over a thread-block cluster of at most MAX_SPLITS
# CTAs, each scoring about SCORES_CTA_FLOATS centroid floats
MAX_SPLITS = 8
SCORES_CTA_FLOATS = 8192


def _smem_floats(M: int, D: int, chunk: int) -> int:
    """A CTA's shared memory in floats: the M query rows padded to a
    multiple of 4, a staged tile of centroids (rows padded to D + 4), the
    logits of its chunk and 4 floats a row."""
    tile = min(chunk, _TILE_FLOATS // (D + 4))
    return -(-M // 4) * 4 * D + tile * (D + 4) + M * chunk + 4 * M


def scores_plan(C: int, D: int) -> tuple[int, int]:
    """(S, chunk) of the centroid_scores kernel for C centroids of D
    floats: a (sequence, KV head)'s cluster of S CTAs, CTA s scoring
    centroids [s chunk, min(C, (s + 1) chunk)). S is the fewest CTAs that
    keep each within SCORES_CTA_FLOATS centroid floats, at most MAX_SPLITS;
    every CTA gets at least one centroid. Chosen from C and D alone, never
    from B, Hkv or T, so a head's scores have the same bits in a call on a
    shard of the heads. llama-3.2-1b (D=64): C=130 2 CTAs of 65, C=1024 8
    of 128; D=128: C=130 3 of 44. Of chip_smoke's sweep of the aim, 8192
    was within 0.2 us of the fastest at every C timed (PERF.md)."""
    S = max(1, min(MAX_SPLITS, -(-C * D // SCORES_CTA_FLOATS)))
    return S, -(-C // S)


def centroid_scores_plain(q: torch.Tensor,
                          centroids: torch.Tensor) -> torch.Tensor:
    """The plain version (the JAX package's centroid_scores_xla): q [B, T,
    Hq, D], centroids [B, Hkv, C, D] -> [B, Hkv, C] float32."""
    B, T, Hq, D = q.shape
    Hkv = centroids.shape[1]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("bthgd,bhcd->bthgc", qg,
                          centroids.float()) * (D ** -0.5)
    return torch.softmax(logits, dim=-1).sum(dim=(1, 3))


def _lib() -> ctypes.CDLL:
    lib = _build.load("centroid_scores")
    fn = lib.mdt_centroid_scores
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, P, P, P, I, I, I, I, I, I, I, I, LL, LL, LL, LL,
                       LL, LL, I, P]
        fn.restype = I
    return lib


def _scores_launch(q, centroids, *, fault=0):
    """Check the operands (CUDA tensors) and launch the centroid_scores
    kernel; returns the scores. fault=1 leaves the last rank of each
    cluster out of the rows' (max, sum) combine (a planted fault for the
    checks of chip_smoke.py, which the limit must reject). Counts no
    launch."""
    if not (q.is_cuda and centroids.is_cuda) or q.device != centroids.device:
        raise ValueError("centroid_scores needs both operands on one CUDA "
                         "device (or both on the CPU)")
    B, T, Hq, D = q.shape
    if (centroids.dim() != 4 or centroids.shape[0] != B
            or centroids.shape[3] != D):
        raise ValueError(f"centroids {tuple(centroids.shape)}: need "
                         f"[{B}, Hkv, C, {D}]")
    Hkv, C = centroids.shape[1], centroids.shape[2]
    if q.dtype not in _DTYPE_CODES or centroids.dtype != torch.float32:
        raise ValueError(f"q {q.dtype}, centroids {centroids.dtype}: need q "
                         f"float32 or bfloat16 and float32 centroids")
    if Hq % Hkv or D not in (64, 128):
        raise ValueError(f"Hq={Hq}, Hkv={Hkv}, D={D}: need Hq a multiple of "
                         f"Hkv and D 64 or 128 (the kernel's builds)")
    if q.stride(3) != 1 or centroids.stride(3) != 1:
        raise ValueError("q and centroids need a contiguous last (D) axis")
    if (centroids.data_ptr() % 16
            or any(st % 4 for st in centroids.stride()[:3])):
        raise ValueError("centroids: each centroid must start 16-byte aligned "
                         "(the kernel copies them in 16-byte pieces)")
    M = T * (Hq // Hkv)
    S, chunk = scores_plan(C, D)
    if 4 * _smem_floats(M, D, chunk) > _SMEM_LIMIT:
        raise ValueError(f"T*G={M} query rows and {chunk} centroids a CTA "
                         f"exceed the kernel's {_SMEM_LIMIT} bytes of shared "
                         f"memory")
    out = torch.empty((B, Hkv, C), dtype=torch.float32, device=q.device)
    rc = _lib().mdt_centroid_scores(
        _DTYPE_CODES[q.dtype], q.data_ptr(), centroids.data_ptr(),
        out.data_ptr(), B, T, Hq, Hkv, D, C, S, chunk, q.stride(0),
        q.stride(1), q.stride(2), centroids.stride(0), centroids.stride(1),
        centroids.stride(2), fault,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"centroid_scores launch failed with cudaError_t "
                           f"{rc}")
    return out


def centroid_scores(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """q [B, T, Hq, D] (rotated; float32 or bfloat16), centroids [B, Hkv, C,
    D] float32 (any strides with D contiguous) -> scores [B, Hkv, C]
    float32: each KV head's softmax mass over the C centroids, summed over
    its T*G query rows (the quantity RetroInfer ranks clusters by).

    Replaces the TPU kernel centroid_scores (pallas_call at
    magicdec_tpu/ops/pallas/gemm_softmax.py:50). Bound by the float32
    centroids' bytes on the H100, launch-bound at the main path's shapes
    (~2.2 MB). C is split over a thread-block cluster of CTAs by
    `scores_plan(C, D)`; each CTA stages its centroids in shared memory,
    computes a logit a thread and its rows' partial (max, sum of exp), and
    the ranks' partials are combined in rank order through distributed
    shared memory (csrc/centroid_scores.cu)."""
    if q.device.type == "cpu" and centroids.device.type == "cpu":
        return centroid_scores_plain(q, centroids)
    out = _scores_launch(q, centroids)
    centroid_scores.launches += 1
    return out


centroid_scores.launches = 0


def centroid_scores_sharded(q: torch.Tensor, centroids: torch.Tensor, *,
                            mesh=None) -> torch.Tensor:
    """centroid_scores on one tp rank's heads: q [B, T, Hq/tp, D] and
    centroids [B, Hkv/tp, C, D] -> the rank's [B, Hkv/tp, C]. The per-head
    scores need no collective; the caller's sum over heads does
    (engine/retro.py all-reduces it). Off-mesh it is centroid_scores.

    Replaces centroid_scores_sharded (the shard_map of the TPU kernel,
    magicdec_tpu/ops/pallas/gemm_softmax.py:69): one launch of
    centroid_scores' kernel on the shard, counted on both wrappers."""
    out = centroid_scores(q, centroids)
    if mesh is not None and mesh.tp > 1 and q.is_cuda:
        centroid_scores_sharded.launches += 1
    return out


centroid_scores_sharded.launches = 0
