"""The collectives of a parallel/sharding.Mesh.

Under GSPMD the JAX package's collectives are inserted by XLA; here the
port calls them itself. Over the tp group: the all-reduce of the
row-parallel products (wo, w_down, GliDe's wo, wo_cross and w_down), of the
vocab-parallel embedding and of the cross-head scores (Quest pages,
RetroInfer centroids, SqueezedAttention's cluster mass, the k-means
distances), the vocab all-gather of the logits, and the broadcast of a
replicated draft's tokens. Over the dp group: the reduction of a
generation's per-round decisions and stats (the JAX package's whole-batch
reductions inside its while_loop), and the gather of the dp blocks' output
rows. At tp == 1 (dp == 1) the tp (dp) calls return their input and make
no torch.distributed call.

Transport. nccl moves CUDA tensors between cards (one process a card).
gloo moves CPU tensors, and takes CUDA tensors too for the three calls used
here (all_reduce, all_gather, broadcast; checked on an H100 with torch
2.11), staging them through host memory itself; staging them through
pinned host tensors in this module gained nothing consistent there (within
15% either way by size; PERF.md, the tensor-parallelism findings), so
every call passes its tensor as it is. A gloo world (several ranks on one
card, or CPU ranks) still runs every kernel on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def _check(x: torch.Tensor, what: str):
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor, got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")


def _gather(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every tp rank's x, in rank order."""
    _check(x, "all_gather_tp")
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x, group=mesh.group)
    return parts


def all_reduce_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum x over the tp ranks, in place (x contiguous, e.g. the leading
    rows of a product); returns x. Every rank gets the same bits, and a
    row's bits do not depend on how many rows x has: at tp == 2 one
    all_reduce (a + b is the same in either order), above it the ranks'
    parts are gathered and summed in rank order, since a ring all-reduce
    cuts the buffer by its size and would sum a row in an order that
    depends on the row count (a draft step's rows and a verify's must
    agree bit for bit, invariant 2)."""
    if _tp(mesh) == 1:
        return x
    _check(x, "all_reduce_tp")
    if mesh.tp == 2:
        dist.all_reduce(x, group=mesh.group)
        return x
    parts = _gather(x, mesh)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    x.copy_(total)
    return x


def all_gather_tp(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The tp ranks' x concatenated along `dim` in rank order (a new
    tensor; x itself at tp == 1)."""
    if _tp(mesh) == 1:
        return x
    return torch.cat(_gather(x.contiguous(), mesh), dim=dim)


def broadcast_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """tp rank 0's x on every rank, in place; returns x."""
    if _tp(mesh) == 1:
        return x
    _check(x, "broadcast_tp")
    dist.broadcast(x, src=dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    return x


def _dp(mesh) -> int:
    return 1 if mesh is None else mesh.dp


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_dp(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """x reduced over the dp ranks ("sum" or "max"), in place; returns x.
    For the integer flags and counts of a generation's rounds, so the
    order of a sum does not matter."""
    if _dp(mesh) == 1:
        return x
    _check(x, "all_reduce_dp")
    dist.all_reduce(x, op=_OPS[op], group=mesh.dp_group)
    return x


def all_gather_dp(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The dp ranks' x concatenated along `dim` in dp order (a new tensor;
    x itself at dp == 1): the rows of every dp block, so each rank returns
    the whole batch."""
    if _dp(mesh) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.dp_group)
    return torch.cat(parts, dim=dim)
