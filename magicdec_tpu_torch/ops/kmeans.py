"""Batched k-means over cache keys (port of magicdec_tpu/ops/kmeans.py).

Lloyd iterations with a fixed trip count, mask-aware (slots past a
sequence's length are ignored), empty clusters keeping their centroid, and
the JAX package's deterministic strided initialisation. Plain PyTorch: the
JAX package leaves k-means to XLA, so no kernel replaces it. The products
are matmuls; a one-hot matmul (not index_add_, whose atomics on the card
would sum in another order each run) forms the cluster sums, so a build is
reproducible on the card.
"""

from __future__ import annotations

import torch


def _dist(xf: torch.Tensor, cent: torch.Tensor, dtype,
          reduce=None) -> torch.Tensor:
    """-2 x.c + |c|^2 [..., N, C] in float32 (|x|^2 dropped: argmin over C),
    with c rounded to x's storage dtype for the product as in the JAX package
    (a bf16 product accumulated in f32 equals the f32 product of the rounded
    operands up to summation order). Both terms are sums over the columns:
    with x and c a tp rank's columns, reduce (an all-reduce over the ranks)
    makes them the whole rows' distances."""
    c = cent.to(dtype).float()
    d = (-2.0 * torch.matmul(xf, c.transpose(-1, -2))
         + (cent * cent).sum(-1)[..., None, :])
    return d if reduce is None else reduce(d)


def kmeans(x: torch.Tensor, valid: torch.Tensor, n_clusters: int,
           iters: int = 8, reduce=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster x [..., N, D] with validity mask [..., N] (float or bool).

    Returns (centroids [..., C, D] float32, assign [..., N] int32; invalid
    slots get an assignment too, masked everywhere downstream). Seeds: every
    max(N // C, 1)-th slot over the full capacity N, so invalid slots can be
    seeds, as in the JAX package. x may be bf16: the float32 copy it is
    multiplied in lives for this call only (callers pass one layer).
    reduce: applied to each distance matrix (see _dist); under tensor
    parallelism x holds a rank's columns, the centroids come out as the
    rank's columns and the assignments are the same on every rank."""
    N = x.shape[-2]
    C = n_clusters
    idx = (torch.arange(C, device=x.device) * max(N // C, 1)) % N
    cent = x.index_select(-2, idx).float()                      # [..., C, D]
    xf = x.float()
    w = valid.to(torch.float32)[..., None]                      # [..., N, 1]
    for _ in range(iters):
        assign = torch.argmin(_dist(xf, cent, x.dtype, reduce), dim=-1)
        onehot = torch.nn.functional.one_hot(assign, C).to(torch.float32) * w
        counts = onehot.sum(-2)                                  # [..., C]
        sums = torch.matmul(onehot.transpose(-1, -2), xf)        # [..., C, D]
        new_cent = sums / torch.clamp(counts, min=1.0)[..., None]
        cent = torch.where((counts > 0)[..., None], new_cent, cent)
    assign = torch.argmin(_dist(xf, cent, x.dtype, reduce),
                          dim=-1).to(torch.int32)
    return cent, assign
