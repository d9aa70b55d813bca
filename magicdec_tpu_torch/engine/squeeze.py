"""SqueezedAttention drafting: thresholded cluster selection (port of
magicdec_tpu/engine/squeeze.py).

Shares the cluster index, the KV-fused store and the round-buffer draft of
the RetroInfer draft (engine/retro.py); only the selection rule differs.
RetroInfer takes a fixed top nprobe by centroid score; SqueezedAttention
keeps every cluster whose estimated softmax mass clears a threshold. Under
a static envelope that is: rank the clusters by mass, gather a fixed
max_clusters superset, and mask out (slot -1, colmask 0) the members of the
clusters below the threshold, so the attended cluster count adapts per
query. The mass uses the live member counts, which the index fold advances.
The rule needs no kernel of its own (the JAX package leaves it to XLA); the
gather is page_gather_single. Under a tp mesh the centroids hold the
rank's KV heads, so each rank sums the mass over its heads and the ranks'
sums are all-reduced before the normalisation and the top-k (as Quest's
page scores): every rank keeps the same clusters, and each gathers its own
columns through page_gather_single_sharded.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from magicdec_tpu_torch.engine.retro import RetroState, retro_select_gather_fn
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.parallel.collectives import all_reduce_tp


def squeeze_select(config: ModelArgs, q: torch.Tensor, cent_l: torch.Tensor,
                   counts_l: torch.Tensor, *, max_clusters: int,
                   threshold: float):
    """q [B, T, Hq, D] (rotated), cent_l [B, C, Hkv*D], counts_l [B, C]
    member counts. A cluster's estimated mass is count * softmax(q .
    centroid * D^-1/2), summed over heads and query rows (over the tp
    ranks' heads under a tp mesh: config.mesh) and normalised; the top
    max_clusters by mass are ranked and those with mass >= threshold kept. Returns (top_c [B, max_clusters] int32, keep
    [B, max_clusters] bool)."""
    Hkv, Dh = config.n_kv_head, config.head_dim
    B, T = q.shape[:2]
    C = cent_l.shape[1]
    qg = q.reshape(B, T, Hkv, config.n_head // Hkv, Dh).float()
    cent = cent_l.reshape(B, C, Hkv, Dh)
    logit = torch.einsum("bthgd,bchd->bthgc", qg, cent) * (Dh ** -0.5)
    w = torch.softmax(logit, dim=-1) * counts_l.float()[:, None, None, None, :]
    mass = all_reduce_tp(w.sum(dim=(1, 2, 3)), config.mesh)        # [B, C]
    mass = mass / torch.clamp(mass.sum(-1, keepdim=True), min=1e-9)
    top_mass, top_c = torch.topk(mass, max_clusters, dim=1)
    return top_c.to(torch.int32), top_mass >= threshold


def squeeze_select_fn(config: ModelArgs, centroids, counts, *,
                      max_clusters: int, threshold: float):
    """select_fn for retro.retro_select_gather_fn: squeeze_select at layer l
    with the counts as they are when it runs (the live counts)."""
    def select(q, l):
        return squeeze_select(config, q, centroids[l], counts[l],
                              max_clusters=max_clusters, threshold=threshold)
    return select


@dataclass
class SqueezeState(RetroState):
    """RetroState with the mass-threshold rule; nprobe is max_clusters."""
    threshold: float

    def select_gather(self, config: ModelArgs):
        return retro_select_gather_fn(
            config, self.centroids, self.cluster_slots, self.kv_store,
            nprobe=self.nprobe,
            select_fn=squeeze_select_fn(config, self.centroids, self.counts,
                                        max_clusters=self.nprobe,
                                        threshold=self.threshold))
