"""RetroInfer drafting and the round-buffer machinery shared by the
retrieval drafts (port of magicdec_tpu/engine/retro.py; Quest and
SqueezedAttention use the round buffer too).

RetroInfer: at encode, each (layer, sequence)'s prefix keys are clustered
over their full packed [Hkv*D] rows (k-means, ops/kmeans.py) into C
clusters of at most `cap` members (overflow members are dropped from the
index, as in the JAX package), and a KV-fused cluster-major store
[L, B, C * 2cap, Hkv*D] holds each cluster's K rows followed by its V rows.
The round-opening draft step scores the centroids (centroid_scores), takes
the top nprobe clusters, and gathers them from the store into the round
buffer's top region with one page_gather_single launch per layer. Unlike
the JAX package, which builds the store on a TPU only and slices cache rows
elsewhere, the port builds and gathers from the store on every device; the
bytes are the same.

Round buffer: one stacked draft buffer [L, B, R = NS + Wcap, Hkv*D] per
generation. Columns [0, NS) hold the round's gathered working set (pages or
clusters), refreshed by the round-opening draft step, with pad and dedup
holes expressed by a colmask [L, B, 1, R] int32. Columns [NS, R) hold a
rolling tail window of the newest rows: draft steps append their K/V
there, the verify dual-writes it (and the target cache), rollback rewinds
tail_len, and an amortised compaction shifts the window left. Every draft
step attends [top region | causal tail] through flash_decode_stacked_masked.
Generations of at most TAIL_COVERS_MAX tokens widen the tail to hold every
generated row; longer ones fold the rows that age out of the tail into the
cluster index at each compaction (update_cluster_index).

Under a tp mesh (config.mesh) every buffer, the store and the centroids hold
the rank's KV-head columns; the cluster slot tables and counts are the same
on every rank: the k-means distances and the centroid scores are sums over
all heads, all-reduced before their argmin and top-k.

HostClusterStore keeps the cluster K/V bytes in the host wave buffer
(engine/wave_buffer.py) instead, for contexts larger than the card's
memory; engine/offload.py is the generation path built on that layout.

As elsewhere in the port, the buffers, the index and the store are written
in place. Where the JAX package runs the rounds inside one lax.while_loop,
the port runs a Python loop over rounds (engine/spec.py) with one host read
per round; roundtail_round is the loop's body for every round-buffer draft.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine.attention_impls import (_flat, _positions,
                                                       _Rotary, _Slots)
from magicdec_tpu_torch.engine.sampling import argmax_tokens
from magicdec_tpu_torch.engine.wave_buffer import HostBlockStore
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops.flash_decode import flash_decode_stacked_masked
from magicdec_tpu_torch.ops.gemm_softmax import centroid_scores_sharded
from magicdec_tpu_torch.ops.kmeans import kmeans
from magicdec_tpu_torch.ops.page_gather import page_gather_single_sharded
from magicdec_tpu_torch.parallel.collectives import all_reduce_tp

# generations up to this many tokens keep every generated row in the tail
# window (no index maintenance); longer ones fold aged rows into the cluster
# index at each compaction. Tests lower it to force the fold path.
TAIL_COVERS_MAX = 256


def _gather_rows(buf: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """buf [L, B, S, HD] rows src [B, W] of each (layer, sequence) ->
    [L, B, W, HD], a new tensor."""
    b_idx = torch.arange(src.shape[0], device=src.device)[:, None]
    return buf[:, b_idx, src.long()]


def init_tail(cache: KVCache, NS: int, Wcap: int, keep: int):
    """Allocate the round buffer and fill its tail region with the last
    `keep` rows of the (prefilled) target cache. Returns (bufk, bufv
    [L, B, NS + Wcap, HD], colmask [L, B, 1, NS + Wcap] int32, tail_len [B],
    tail_base [B] = absolute slot of tail column 0)."""
    L, B, S, HD = cache.k.shape
    dev = cache.k.device
    lens = cache.lengths.to(torch.int32)
    tail_len = torch.clamp(lens, max=keep)
    tail_base = lens - tail_len
    src = (tail_base[:, None]
           + torch.arange(Wcap, dtype=torch.int32, device=dev)).clamp(0, S - 1)
    bufs = []
    for c in (cache.k, cache.v):
        buf = torch.zeros((L, B, NS + Wcap, HD), dtype=c.dtype, device=dev)
        buf[:, :, NS:] = _gather_rows(c, src)
        bufs.append(buf)
    # the top region's bits are rewritten by each round's opening step; the
    # tail's stay 1 (its causality is the kernel's [lo, hi) interval)
    colmask = torch.zeros((L, B, 1, NS + Wcap), dtype=torch.int32, device=dev)
    colmask[..., NS:] = 1
    return bufs[0], bufs[1], colmask, tail_len, tail_base


def compaction_needed(tail_len: torch.Tensor, trigger: int) -> torch.Tensor:
    """0-d bool on the device: some tail is longer than `trigger`, so the
    round loop runs tail_compact (it reads this flag with its own)."""
    return (tail_len > trigger).any()


def tail_compact(bufk, bufv, tail_len, tail_base, *, NS: int, keep: int):
    """Amortised left shift of the tail window, keeping each sequence's
    newest `keep` rows (run when compaction_needed). bufk/bufv are written
    in place; returns (tail_len, tail_base). The shifted rows are gathered
    into new tensors first (source and destination ranges overlap)."""
    R = bufk.shape[2]
    shift = torch.clamp(tail_len - keep, min=0)                      # [B]
    src = (NS + shift[:, None]
           + torch.arange(R - NS, dtype=torch.int32, device=bufk.device))
    src = src.clamp(0, R - 1)
    for buf in (bufk, bufv):
        buf[:, :, NS:] = _gather_rows(buf, src)
    return tail_len - shift, tail_base + shift


def _tail_attend(q, bufk, bufv, colmask, l: int, ns, hi, mesh=None):
    """flash_decode_stacked_masked over [top region | causal tail] of the
    round buffer, on the rank's head shard under a tp mesh (q [B, 1, Hq/tp,
    D], buffers [L, B, R, (Hkv/tp)*D]); the colmask is the same on every
    rank. Replaces the shard_map wrapper of the masked
    kernel in _tail_attend (magicdec_tpu/engine/retro.py:305-330). Off-mesh
    it is the plain kernel."""
    return impls._counted(_tail_attend, mesh, q, flash_decode_stacked_masked(
        q, bufk, bufv, l, colmask, ns, ns, hi))


_tail_attend.launches = 0


class _TailRows:
    """Row bounds of one draft step (one token) over the round buffer: it
    attends the top region's set bits and tail columns [NS, NS +
    tail_len_before + 1)."""

    def __init__(self, config: ModelArgs, tail_len_before: torch.Tensor,
                 NS: int):
        self.hi = NS + 1 + tail_len_before.to(torch.int32)[:, None]
        self.ns = torch.full_like(self.hi, NS)
        self.mesh = config.mesh

    def attend(self, q, bufk, bufv, colmask, l):
        return _tail_attend(q, bufk, bufv, colmask, l, self.ns, self.hi,
                            self.mesh)


def roundtail_select_attn(config: ModelArgs, lengths_before: torch.Tensor,
                          tail_len_before: torch.Tensor,
                          tail_base: torch.Tensor, select_gather_fn, *,
                          NS: int):
    """attn_impl for the round-opening draft step (one token per sequence,
    as every draft step): select and gather blocks
    into the buffer's top region, stamp the colmask (0 for pad holes and for
    rows the tail already holds: exact dedup), append the step's K/V to the
    tail, attend. caches = (ck, cv, bufk, bufv, colmask).

    select_gather_fn(q_rotated, ck, cv, l, out_k, out_v) writes the
    selected rows into out_k/out_v (the top region [B, NS, HD] of layer l)
    and returns their absolute cache slots [B, NS] (-1 invalid)."""
    rot = _Rotary(config, _positions(lengths_before, 1))
    slots = _Slots(NS + tail_len_before, 1)
    rows = _TailRows(config, tail_len_before, NS)

    def impl(q, k, v, caches, l):
        ck, cv, bufk, bufv, colmask = caches
        q, k = rot(q), rot(k)
        # no target-cache write: the verify dual-writes these slots
        sel = select_gather_fn(q, ck, cv, l, bufk[l, :, :NS], bufv[l, :, :NS])
        colmask[l, :, 0, :NS] = ((sel >= 0)
                                 & (sel < tail_base[:, None])).to(torch.int32)
        slots.write(bufk, k, l)
        slots.write(bufv, v, l)
        return _flat(rows.attend(q, bufk, bufv, colmask, l))

    return impl


def roundtail_draft_attn(config: ModelArgs, lengths_before: torch.Tensor,
                         tail_len_before: torch.Tensor, *, NS: int):
    """attn_impl for draft steps 2..gamma: append to the tail, attend the
    round buffer; no gather, no scoring, no target-cache reads or writes
    (the verify recomputes these K/V and dual-writes the target cache).
    caches = (ck, cv, bufk, bufv, colmask)."""
    rot = _Rotary(config, _positions(lengths_before, 1))
    slots = _Slots(NS + tail_len_before, 1)
    rows = _TailRows(config, tail_len_before, NS)

    def impl(q, k, v, caches, l):
        _, _, bufk, bufv, colmask = caches
        q, k = rot(q), rot(k)
        slots.write(bufk, k, l)
        slots.write(bufv, v, l)
        return _flat(rows.attend(q, bufk, bufv, colmask, l))

    return impl


def roundtail_draft_loop(params, config: ModelArgs, ck, cv, bufk, bufv,
                         colmask, tail_len, tail_base, lenT0, buffer0,
                         select_gather_fn, *, gamma: int,
                         NS: int) -> torch.Tensor:
    """The gamma-step round-buffer draft loop: one select+gather step, then
    gamma-1 tail steps. The buffers are written in place; returns the
    round's tokens [B, gamma + 1] (buffer0 and the drafts)."""
    caches = (ck, cv, bufk, bufv, colmask)
    tok = buffer0
    drafted = []
    for i in range(gamma):
        if i == 0:
            impl = roundtail_select_attn(config, lenT0, tail_len, tail_base,
                                         select_gather_fn, NS=NS)
        else:
            impl = roundtail_draft_attn(config, lenT0 + i, tail_len + i, NS=NS)
        logits = llama.forward(params, config, tok, impl, caches,
                               last_only=True)
        tok = argmax_tokens(logits)
        drafted.append(tok)
    return torch.cat([buffer0] + drafted, dim=1)


@torch.inference_mode()
def roundtail_round(params, config: ModelArgs, cache: KVCache, st, buffer0,
                    output, gen_counts, eot, gamma: int):
    """One self-speculation round of a round-buffer draft (Quest, RetroInfer,
    SqueezedAttention; the body of the JAX package's while_loop after its
    compaction): a select+gather draft step with st.select_gather's rule,
    gamma-1 tail draft steps, the dual-write verify (target cache and tail),
    the acceptance. Caches, round buffer and output are written in place;
    returns (bonus [B, 1], gen_counts, info)."""
    # imported here: engine/spec.py imports this module
    from magicdec_tpu_torch.engine.spec import _accept_and_update

    lenT0, tlen0 = cache.lengths, st.tail_len
    buffer = roundtail_draft_loop(
        params, config, cache.k, cache.v, st.bufk, st.bufv, st.colmask, tlen0,
        st.tail_base, lenT0, buffer0, st.select_gather(config), gamma=gamma,
        NS=st.NS)
    impl = impls.verify_dual_attn(config, lenT0, st.NS + tlen0, gamma + 1)
    logits = llama.forward(params, config, buffer, impl,
                           (cache.k, cache.v, st.bufk, st.bufv))
    target_tokens = argmax_tokens(logits)
    accept, bonus, gen_counts, terminal, accepted = _accept_and_update(
        buffer, target_tokens, eot, gamma, output, gen_counts)
    cache.lengths = lenT0 + accept
    st.tail_len = tlen0 + accept
    return bonus, gen_counts, dict(terminal=terminal, accepted_drafts=accepted,
                                   accept_nums=accept)


def tail_sizes(keep: int, gamma: int) -> tuple[int, int]:
    """(Wcap, trigger) of a tail region for `keep` rows: it holds keep plus
    8*(gamma+2) rows (rounded to 8), so the compaction gather amortises over
    ~8 rounds, and compacts once a tail passes trigger = Wcap - (gamma+2)."""
    Wcap = -(-(keep + 8 * (gamma + 2)) // 8) * 8
    return Wcap, Wcap - (gamma + 2)


@dataclass
class RoundBuffer:
    """The round buffer of a retrieval draft and its tail bookkeeping. Each
    draft's state extends it with its index, its selection rule
    (select_gather(config) -> a select_gather_fn for roundtail_select_attn)
    and what a compaction refreshes (compact(cache))."""
    bufk: torch.Tensor
    bufv: torch.Tensor
    colmask: torch.Tensor
    tail_len: torch.Tensor
    tail_base: torch.Tensor
    NS: int
    keep: int
    Wcap: int
    trigger: int

    @staticmethod
    def init_fields(cache: KVCache, NS: int, keep: int, gamma: int) -> dict:
        """The fields of a fresh round buffer after encode."""
        Wcap, trigger = tail_sizes(keep, gamma)
        bufk, bufv, colmask, tail_len, tail_base = init_tail(cache, NS, Wcap,
                                                             keep)
        return dict(bufk=bufk, bufv=bufv, colmask=colmask, tail_len=tail_len,
                    tail_base=tail_base, NS=NS, keep=keep, Wcap=Wcap,
                    trigger=trigger)

    def compaction_needed(self) -> torch.Tensor:
        return compaction_needed(self.tail_len, self.trigger)

    def shift(self) -> torch.Tensor:
        """Shift the tail window (called when compaction_needed() is true:
        then some tail is longer than trigger > keep, so its tail_base
        moves); returns the tail_base before the shift."""
        old_base = self.tail_base
        self.tail_len, self.tail_base = tail_compact(
            self.bufk, self.bufv, self.tail_len, self.tail_base, NS=self.NS,
            keep=self.keep)
        return old_base


# ---------------------------------------------------------------------------
# The cluster index: built at encode, folded at compactions
# ---------------------------------------------------------------------------

def member_slot_table(assign: torch.Tensor, valid: torch.Tensor,
                      n_clusters: int, cap: int) -> torch.Tensor:
    """Per-cluster member slot lists [..., C, cap] int32 (-1 padding) from
    k-means assignments [..., S]: each valid slot is ranked within its
    cluster by slot order; members ranked cap or later are dropped."""
    S = assign.shape[-1]
    a = assign.long()
    onehot = (torch.nn.functional.one_hot(a, n_clusters).to(torch.int32)
              * valid.to(torch.int32)[..., None])               # [..., S, C]
    rank = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - 1
    member_rank = torch.gather(rank, -1, a[..., None])[..., 0]
    is_member = torch.gather(onehot, -1, a[..., None])[..., 0] > 0
    ok = is_member & (member_rank < cap)
    # dropped slots go to a spare last column, cut off below
    target = torch.where(ok, a * cap + member_rank, n_clusters * cap)
    slot = torch.arange(S, dtype=torch.int32, device=assign.device)
    table = torch.full((*assign.shape[:-1], n_clusters * cap + 1), -1,
                       dtype=torch.int32, device=assign.device)
    table.scatter_(-1, target, slot.expand(assign.shape).contiguous())
    return table[..., :-1].reshape(*assign.shape[:-1], n_clusters, cap)


def build_cluster_index(cache: KVCache, n_clusters: int, cap: int,
                        mesh=None):
    """Cluster each (layer, sequence)'s keys over the full packed [Hkv*D]
    rows (all KV heads jointly, so a selected slot moves as one row).
    Returns (centroids [L, B, C, HD] float32, slots [L, B, C, cap] int32,
    -1 padding). One layer at a time, so the [B, S, C] transients of the
    Lloyd distances and the one-hot exist for one layer only. Under a tp
    mesh the keys and centroids are the rank's columns and each distance
    is all-reduced over the ranks, so every rank assigns alike."""
    L, B, S, HD = cache.k.shape
    dev = cache.k.device
    valid = torch.arange(S, device=dev)[None, :] < cache.lengths[:, None]
    cent = torch.empty((L, B, n_clusters, HD), dtype=torch.float32,
                       device=dev)
    slots = torch.empty((L, B, n_clusters, cap), dtype=torch.int32,
                        device=dev)
    for l in range(L):
        cent[l], assign = kmeans(cache.k[l], valid, n_clusters,
                                 reduce=lambda d: all_reduce_tp(d, mesh))
        slots[l] = member_slot_table(assign, valid, n_clusters, cap)
    return cent, slots


def build_clustered_store(cache: KVCache, cluster_slots: torch.Tensor,
                          cap: int) -> torch.Tensor:
    """The KV-fused cluster-major store [L, B, C * 2cap, HD]: cluster c's K
    rows at [c*2cap, c*2cap + cap), its V rows right after, so
    page_gather_single moves a whole cluster as one page of 2cap rows. Pad
    members (-1) hold the clipped row 0 and are masked at attention. Built
    one layer at a time into the store."""
    L, B, S, HD = cache.k.shape
    C = cluster_slots.shape[2]
    store = torch.empty((L, B, C, 2, cap, HD), dtype=cache.k.dtype,
                        device=cache.k.device)
    b_idx = torch.arange(B, device=cache.k.device)[:, None]
    for l in range(L):
        src = cluster_slots[l].clamp(0, S - 1).reshape(B, C * cap).long()
        store[l, :, :, 0] = cache.k[l][b_idx, src].view(B, C, cap, HD)
        store[l, :, :, 1] = cache.v[l][b_idx, src].view(B, C, cap, HD)
    return store.view(L, B, C * 2 * cap, HD)


def build_retro_state(cache: KVCache, n_clusters: int, cap: int, mesh=None):
    """The retrieval index, built after prefill (RetroInfer clusters inside
    its prefill too): (centroids, cluster_slots, kv_store, counts [L, B, C]
    int32 live member counts, indexed_upto [B] = the prefill lengths the
    index was built from); mesh: as build_cluster_index's."""
    centroids, cluster_slots = build_cluster_index(cache, n_clusters, cap,
                                                   mesh)
    kv_store = build_clustered_store(cache, cluster_slots, cap)
    counts = (cluster_slots >= 0).sum(-1, dtype=torch.int32)
    return (centroids, cluster_slots, kv_store, counts,
            cache.lengths.to(torch.int32).clone())


def _scatter_rows(dst: torch.Tensor, target: torch.Tensor, val: torch.Tensor,
                  ok: torch.Tensor) -> None:
    """dst[l, b, target[l, b, a]] = val[l, b, a] where ok[l, b, a], in place
    and without a host read: every entry that is not ok repeats the write of
    the first ok entry of its (l, b) (or rewrites dst[l, b, 0] with itself
    when there is none), so duplicate indices always carry equal values.
    dst [L, B, N, ...], target/ok [L, B, A], val [L, B, A, ...]."""
    L, B = target.shape[:2]
    rest = val.shape[3:]
    first = torch.argmax(ok.to(torch.int32), dim=2, keepdim=True)   # [L,B,1]
    has = ok.any(dim=2, keepdim=True)
    target = torch.where(ok, target,
                         torch.where(has, torch.gather(target, 2, first), 0))
    extra = (1,) * len(rest)
    idx = first.view(L, B, 1, *extra).expand(L, B, 1, *rest)
    val0 = torch.where(has.view(L, B, 1, *extra), torch.gather(val, 2, idx),
                       dst[:, :, :1].to(val.dtype))
    val = torch.where(ok.view(L, B, -1, *extra), val, val0)
    l_idx = torch.arange(L, device=dst.device)[:, None, None]
    b_idx = torch.arange(B, device=dst.device)[None, :, None]
    dst[l_idx, b_idx, target] = val.to(dst.dtype)


def update_cluster_index(cache: KVCache, centroids, cluster_slots, kv_store,
                         counts, old_base, new_base, indexed_upto, *,
                         age_max: int, cap: int, mesh=None) -> None:
    """Fold the rows [old_base, new_base) per sequence (just compacted out
    of the tail window) into the index, in place: each joins its nearest
    centroid (the k-means metric, centroids fixed) and is appended to that
    cluster's member slots and its rows of the store; counts [L, B, C]
    advance. Rows below indexed_upto are members already and are skipped (a
    duplicate key would be attended twice); rows landing in a full cluster
    are dropped, like build_cluster_index's overflow. Under a tp mesh the
    distances are all-reduced over the ranks, as build_cluster_index's."""
    L, B, S, HD = cache.k.shape
    C = cluster_slots.shape[2]
    dev = cache.k.device
    j = torch.arange(age_max, dtype=torch.int32, device=dev)
    slot = old_base[:, None] + j[None, :]                         # [B, A]
    valid = ((j[None, :] < (new_base - old_base)[:, None])
             & (slot >= indexed_upto[:, None]))
    b_idx = torch.arange(B, device=dev)[:, None]
    src = slot.clamp(0, S - 1).long()
    k_rows = cache.k[:, b_idx, src]                               # [L,B,A,HD]
    v_rows = cache.v[:, b_idx, src]
    d = (-2.0 * torch.einsum("lbad,lbcd->lbac", k_rows.float(), centroids)
         + (centroids * centroids).sum(-1)[:, :, None, :])
    all_reduce_tp(d, mesh)
    assign = torch.argmin(d, dim=-1)                              # [L, B, A]
    onehot = (torch.nn.functional.one_hot(assign, C).to(torch.int32)
              * valid[None, :, :, None].to(torch.int32))
    rank = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    rank = torch.gather(rank, -1, assign[..., None])[..., 0]
    fill = torch.gather(counts, -1, assign) + rank                # [L, B, A]
    ok = valid[None] & (fill < cap)
    added = (onehot * ok[..., None].to(torch.int32)).sum(2, dtype=torch.int32)
    fill = fill.long()
    _scatter_rows(cluster_slots.view(L, B, C * cap), assign * cap + fill,
                  slot[None].expand(L, B, age_max), ok)
    _scatter_rows(kv_store, assign * (2 * cap) + fill, k_rows, ok)
    _scatter_rows(kv_store, assign * (2 * cap) + cap + fill, v_rows, ok)
    counts.copy_(torch.clamp(counts + added, max=cap))


# ---------------------------------------------------------------------------
# RetroInfer selection and state
# ---------------------------------------------------------------------------

def retro_select_gather_fn(config: ModelArgs, centroids, cluster_slots,
                           kv_store, *, nprobe: int, select_fn=None):
    """select_gather_fn for roundtail_select_attn: rank the clusters of
    layer l (centroid_scores summed over KV heads, all-reduced over the tp
    ranks, top nprobe; or a custom
    select_fn(q, l) -> (top_c [B, n] int32, keep [B, n] bool or None), the
    SqueezedAttention rule), then page_gather_single the whole clusters (K
    and V halves of each 2cap-row store page) into the top region. Returns
    the gathered rows' cache slots [B, n * cap] (-1 for pad members and for
    clusters not kept)."""
    Hkv, Dh = config.n_kv_head, config.head_dim
    mesh = config.mesh
    cap = cluster_slots.shape[3]

    def default_select(q, l):
        B, C = q.shape[0], centroids.shape[2]
        cent = centroids[l].view(B, C, Hkv, Dh).transpose(1, 2)  # no copy
        scores = centroid_scores_sharded(q, cent, mesh=mesh).sum(dim=1)
        all_reduce_tp(scores, mesh)                               # [B, C]
        return torch.topk(scores, nprobe, dim=1).indices.to(torch.int32), None

    select = select_fn or default_select

    def select_gather(q, ck, cv, l, out_k, out_v):
        B, HD = q.shape[0], ck.shape[3]
        top_c, keep = select(q, l)                                # [B, n]
        n = top_c.shape[1]
        b_idx = torch.arange(B, device=q.device)[:, None]
        slots = cluster_slots[l][b_idx, top_c.long()]             # [B,n,cap]
        if keep is not None:
            slots = torch.where(keep[..., None], slots, -1)
        page_gather_single_sharded(kv_store, l, top_c, 2 * cap, mesh=mesh,
                                   out=(out_k.view(B, n, cap, HD),
                                        out_v.view(B, n, cap, HD)))
        return slots.reshape(B, -1)

    return select_gather


@dataclass
class RetroState(RoundBuffer):
    """What the JAX package's RetroInfer while_loop carries besides the
    target cache and the output: the cluster index (written in place by the
    fold) and the round buffer. age_max = 0 on the tail-covers path (no
    fold)."""
    centroids: torch.Tensor
    cluster_slots: torch.Tensor
    kv_store: torch.Tensor
    counts: torch.Tensor
    indexed_upto: torch.Tensor
    nprobe: int
    cap: int
    age_max: int

    @classmethod
    def create(cls, cache: KVCache, index, *, nprobe: int, cap: int,
               recent: int, gamma: int, max_new_tokens: int, **rule):
        """The state after encode (index = build_retro_state's). A
        generation of at most TAIL_COVERS_MAX tokens keeps recent +
        max_new_tokens + gamma + 1 tail rows, so nothing ages out; a longer
        one keeps `recent` and folds up to Wcap - recent aged rows per
        compaction."""
        keep = recent
        fold = max_new_tokens > TAIL_COVERS_MAX
        if not fold:
            keep += max_new_tokens + gamma + 1
        base = RoundBuffer.init_fields(cache, nprobe * cap, keep, gamma)
        centroids, cluster_slots, kv_store, counts, indexed_upto = index
        return cls(centroids=centroids, cluster_slots=cluster_slots,
                   kv_store=kv_store, counts=counts, indexed_upto=indexed_upto,
                   nprobe=nprobe, cap=cap,
                   age_max=base["Wcap"] - keep if fold else 0, **rule, **base)

    def select_gather(self, config: ModelArgs):
        return retro_select_gather_fn(config, self.centroids,
                                      self.cluster_slots, self.kv_store,
                                      nprobe=self.nprobe)

    def compact(self, cache: KVCache, mesh=None) -> None:
        """Shift the tail window and, on the long-generation path, fold the
        rows that aged out of it into the index (mesh: the tp mesh, whose
        ranks all-reduce the fold's distances)."""
        old_base = self.shift()
        if self.age_max:
            update_cluster_index(cache, self.centroids, self.cluster_slots,
                                 self.kv_store, self.counts, old_base,
                                 self.tail_base, self.indexed_upto,
                                 age_max=self.age_max, cap=self.cap,
                                 mesh=mesh)


class HostClusterStore(HostBlockStore):
    """Offload variant of the cluster index's store: the cluster K/V bytes
    live in the host wave buffer (one slot per (layer, sequence,
    cluster)), and gather_clusters / fetch pull the selected clusters into
    one contiguous block (on the host, or through a pinned buffer onto a
    device). This is the capacity path, for contexts larger than the
    card's memory: selection still happens on the device from the
    centroids; only member K/V bytes live on the host.

    Built from a target cache and build_cluster_index's slot table
    [L, B, C, cap] (-1 padding; pad members hold the clipped row 0 and are
    masked by member_valid), one layer at a time."""

    def __init__(self, config: ModelArgs, cache: KVCache,
                 cluster_slots: torch.Tensor, cap: int):
        L, B, S, HD = cache.k.shape
        C = cluster_slots.shape[2]
        super().__init__(L, B, C, cap, HD, cache.k.dtype)
        self.shape = (L, B, C, cap, HD)
        b_idx = torch.arange(B, device=cache.k.device)[:, None]
        for l in range(L):
            src = cluster_slots[l].clamp(0, S - 1).reshape(B, C * cap).long()
            k = cache.k[l][b_idx, src].reshape(B, C, cap, HD)
            v = cache.v[l][b_idx, src].reshape(B, C, cap, HD)
            self.put_layer(l, torch.stack([k, v], dim=2))
        self.member_valid = cluster_slots >= 0
