"""Quest drafting: query-aware top-k page selection (port of
magicdec_tpu/engine/quest.py).

The target cache is viewed as pages of `page` slots; each page and KV head
keeps elementwise min/max key boxes, built at encode. The round-opening
draft step scores every page with the upper bound sum_d max(q_d * kmin_d,
q_d * kmax_d) (summed over the GQA group), excludes the pages the tail
window covers, and gathers the top pages into the round buffer's top
region (engine/retro.py); every draft step attends [top pages | tail]
through flash_decode_stacked_masked. The verify dual-writes the target
cache and the tail, so rollback is a length rewind. Pages are a scoring
granularity, not a memory layout: the cache stays the packed
[L, B, S, Hkv*D] tensor.

Where the JAX package runs the rounds inside one lax.while_loop, the port
runs a Python loop over rounds (engine/spec.py) with one host read per
round; retro.roundtail_round is the loop's body.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import retro
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops.page_gather import page_gather_sharded
from magicdec_tpu_torch.parallel.collectives import all_reduce_tp

NEG_INF = -1e30
_BIG = 3e38     # the neutral box bound of slots past a sequence's length


def _boxes(k: torch.Tensor, slot: torch.Tensor, lengths: torch.Tensor):
    """Min/max key boxes of pages: k [L, B, W, page, HD], slot [B, W, page]
    absolute slots; slots >= lengths[b] are neutral. -> 2x [L, B, W, HD]
    float32."""
    valid = (slot < lengths[:, None, None])[None, ..., None]
    kf = k.float()
    kmin = torch.where(valid, kf, _BIG).amin(dim=3)
    kmax = torch.where(valid, kf, -_BIG).amax(dim=3)
    return kmin, kmax


def make_page_meta(cache: KVCache, page: int = 128):
    """Per-page, per-KV-head elementwise key boxes of the whole cache:
    (kmin, kmax) [L, B, S // page, Hkv*D] float32. Slots past a sequence's
    length are neutral (+/-3e38), so stale tails never attract selection."""
    L, B, S, HD = cache.k.shape
    if S % page:
        raise ValueError(f"cache length {S} is not a multiple of page {page}")
    P = S // page
    slot = torch.arange(S, dtype=torch.int32,
                        device=cache.k.device).reshape(1, P, page)
    return _boxes(cache.k.reshape(L, B, P, page, HD), slot, cache.lengths)


def update_page_meta(cache: KVCache, kmin, kmax, span_start, span: int,
                     page: int = 128) -> None:
    """Recompute, in place, the boxes of the span // page + 2 pages from the
    one holding span_start[b] on (clipped to the cache), per sequence: the
    pages whose rows just aged out of the tail window."""
    L, B, S, HD = cache.k.shape
    P = S // page
    W = span // page + 2
    start_page = torch.clamp(span_start.long() // page, 0, P - W)       # [B]
    pidx = start_page[:, None] + torch.arange(W, device=start_page.device)
    b_idx = torch.arange(B, device=pidx.device)[:, None]
    kwin = cache.k.reshape(L, B, P, page, HD)[:, b_idx, pidx]   # [L,B,W,pg,HD]
    slot = pidx[..., None] * page + torch.arange(page, device=pidx.device)
    wmin, wmax = _boxes(kwin, slot, cache.lengths)
    kmin[:, b_idx, pidx] = wmin
    kmax[:, b_idx, pidx] = wmax


def quest_select_gather_fn(config: ModelArgs, kmin, kmax, tail_base, *,
                           n_pages: int, page: int = 128):
    """select_gather_fn for retro.roundtail_select_attn: score the pages with
    the min/max key boxes (in float32, outside any kernel, as the JAX
    package leaves it to XLA), take the top n_pages, and page_gather them
    into the top region. One page set is shared by all heads of a sequence,
    so a page moves as contiguous [page, Hkv*D] rows. Pages the tail window
    holds entirely are excluded; a straddling page stays scoreable, its
    covered rows deduped by the colmask. Pages that could only be picked
    with a NEG_INF score (fewer scoreable pages than n_pages) are marked
    invalid (slot -1), whatever index the tie gave. Under a tp mesh the
    head sum of the scores is all-reduced over the ranks before the top-k,
    so every rank picks the same pages, and each gathers its own columns."""
    Hkv, Dh = config.n_kv_head, config.head_dim
    G = config.n_head // Hkv
    mesh = config.mesh
    first_covered = -(-tail_base // page)                              # [B]

    def select_gather(q, ck, cv, l, out_k, out_v):
        B, T = q.shape[:2]
        P = ck.shape[2] // page
        qg = q.reshape(B, T, Hkv, G, Dh).float()
        mn = kmin[l].reshape(B, P, Hkv, Dh)
        mx = kmax[l].reshape(B, P, Hkv, Dh)
        lo = torch.einsum("bthgd,bphd->bthgp", qg, mn)
        hi = torch.einsum("bthgd,bphd->bthgp", qg, mx)
        scores = all_reduce_tp(                                       # [B, P]
            torch.maximum(lo, hi).sum(dim=(2, 3))[:, -1].contiguous(), mesh)
        pid = torch.arange(P, device=q.device)
        scores = torch.where(pid[None, :] < first_covered[:, None], scores,
                             NEG_INF)
        top_scores, top_pages = torch.topk(scores, n_pages, dim=1,
                                           sorted=True)
        top_pages = top_pages.to(torch.int32)
        HD = ck.shape[3]
        page_gather_sharded(ck, cv, l, top_pages, page, mesh=mesh,
                            out=(out_k.view(B, n_pages, page, HD),
                                 out_v.view(B, n_pages, page, HD)))
        rows = torch.arange(page, dtype=torch.int32, device=q.device)
        slot = top_pages[:, :, None] * page + rows
        ok = (top_scores > NEG_INF / 2)[:, :, None]
        return torch.where(ok, slot, -1).reshape(B, -1)

    return select_gather


def quest_sizes(budget: int, latest_k: int, page: int) -> tuple[int, int]:
    """(n_pages, NS) of a Quest draft: the budget covers the selected pages
    and the forced tail window of latest_k rows."""
    if budget < latest_k + page:
        raise ValueError(
            f"quest draft_budget={budget} is below latest_k + page = "
            f"{latest_k + page}; the effective budget is n_pages*{page} + "
            f"{latest_k}-token tail — raise draft_budget or lower latest_k")
    n_pages = max(budget // page - latest_k // page, 1)
    return n_pages, n_pages * page


@dataclass
class QuestState(retro.RoundBuffer):
    """What the JAX package's Quest while_loop carries besides the target
    cache and the output: the page boxes and the round buffer."""
    kmin: torch.Tensor
    kmax: torch.Tensor
    n_pages: int
    page: int

    @staticmethod
    def create(cache: KVCache, index, budget: int, latest_k: int, page: int,
               gamma: int) -> "QuestState":
        """The state after encode: index = make_page_meta's boxes."""
        n_pages, NS = quest_sizes(budget, latest_k, page)
        return QuestState(kmin=index[0], kmax=index[1], n_pages=n_pages,
                          page=page, **retro.RoundBuffer.init_fields(
                              cache, NS, latest_k, gamma))

    def select_gather(self, config: ModelArgs):
        return quest_select_gather_fn(config, self.kmin, self.kmax,
                                      self.tail_base, n_pages=self.n_pages,
                                      page=self.page)

    def compact(self, cache: KVCache, mesh=None) -> None:
        """Shift the tail window and refresh the boxes of the pages that
        aged out of it (they are unselectable while the tail holds them):
        the tail_base moved, which is when the JAX package refreshes them.
        The boxes are per column, so a tp mesh needs no collective here."""
        old_base = self.shift()
        update_page_meta(cache, self.kmin, self.kmax, old_base, self.Wcap,
                         self.page)
