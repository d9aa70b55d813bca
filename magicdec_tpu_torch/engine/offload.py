"""Host-offloaded clustered-KV generation: context KV beyond the card's
memory (port of magicdec_tpu/engine/offload.py).

* Prefill runs a layer at a time: only one layer's full-prefix K/V is on
  the device at once. It is attended (flash_prefill in 128-token chunks),
  k-means clustered, shipped to the host store and freed, so the device's
  peak is the activations plus one layer's KV.
* The device keeps per-layer centroids [L, B, C, Hkv*D], a tail cache
  [L, B, Wcap, Hkv*D] of the newest rows, and the weights.
* Decode scores the centroids per layer, fetches the top-nprobe clusters'
  K/V blocks from the host store (the wave buffer's threaded gather into a
  pinned buffer, one asynchronous copy to the card), and attends
  [gathered clusters | causal tail] densely with
  ops/attention.masked_attention_general, as the JAX package does (no
  Pallas kernel there, so none here).

Where the JAX package crosses to the host through an ordered io_callback
inside a jitted step (offload_generate) or between two jitted layer halves
(offload_generate_hostloop), the port's eager layer loop calls the host
between the halves; each layer's cluster selection is read to the host
there, a synchronization the JAX package pays too. Both entry points stay:
the hostloop is offload_generate with an optional ClusterLRU as its fetch,
so the two emit the same tokens on any device. The fetch function is
injected, so the same decode step can serve clusters from a device store
instead (device_fetch_fn).

Every entry point runs on the current CUDA device unless `device` says
otherwise; with no GPU and no device it raises. A generation clones the
state's tails and writes its new rows there; the returned state holds
them, and the state it was given stays as it was.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.engine.retro import member_slot_table
from magicdec_tpu_torch.engine.sampling import argmax_tokens
from magicdec_tpu_torch.engine.spec import _accept_and_update, _eot_array
from magicdec_tpu_torch.engine.wave_buffer import HostBlockStore
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops.attention import masked_attention_general
from magicdec_tpu_torch.ops.flash_decode import flash_prefill
from magicdec_tpu_torch.ops.kmeans import kmeans
from magicdec_tpu_torch.ops.norms import rms_norm
from magicdec_tpu_torch.ops.rope import rope
from magicdec_tpu_torch.quant.int8 import qmatmul

def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _resolve(device, config: ModelArgs, params, *tensors) -> torch.device:
    """The entry point's device (resolve_device), checked against the
    params' and the state's tensors."""
    dev = resolve_device(device)
    for t in (params["tok_embeddings"], *tensors):
        if not _same_device(t.device, dev):
            raise ValueError(f"operands lie on {t.device}, the offload path "
                             f"runs on {dev}")
    if config.mesh is not None:
        raise NotImplementedError("the offload path does not run on a "
                                  "tensor-parallel mesh")
    return dev


def _layer_params(params, l: int) -> dict:
    """Layer l of every stacked layer weight, plain or quantized (qmatmul
    takes one layer's weight)."""
    return {k: llama._layer(w, l) for k, w in params["layers"].items()}


def _embed(params, tok: torch.Tensor) -> torch.Tensor:
    """Token ids [B, T] -> embeddings [B, T, dim]."""
    return F.embedding(tok.long(), params["tok_embeddings"])


def _logits(params, config: ModelArgs, x: torch.Tensor) -> torch.Tensor:
    """Final norm + lm_head of x [B, T, dim] -> f32 logits [B, T, V], at the
    row count llama.forward uses for B sequences (row_bucket), so the
    one-token steps and a round's T-token verify unembed their rows at one
    shape."""
    B, T, D = x.shape
    x2 = llama._pad_rows(x.reshape(B * T, D), llama.row_bucket(B, T))
    return llama.unembed(params, config, x2)[:B * T].reshape(B, T, -1)


def _qkv(lp, config: ModelArgs, x: torch.Tensor):
    h = rms_norm(x, lp["attn_norm"], config.norm_eps)
    qkv = qmatmul(h, lp["wqkv"])
    if "bqkv" in lp:
        qkv = qkv + lp["bqkv"]
    return llama._split_qkv(qkv, config)


def _post_attn(lp, config: ModelArgs, x: torch.Tensor,
               ctx: torch.Tensor) -> torch.Tensor:
    """wo + residual, then the pre-norm SwiGLU FFN + residual."""
    B, T = x.shape[:2]
    x = x + qmatmul(ctx.reshape(B, T, -1), lp["wo"])
    h = rms_norm(x, lp["ffn_norm"], config.norm_eps)
    gate_up = qmatmul(h, lp["w_gate_up"])
    return x + qmatmul(F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :],
                       lp["w_down"])


# ---------------------------------------------------------------------------
# Layer-at-a-time prefill
# ---------------------------------------------------------------------------

def _layer_prefill(lp, config: ModelArgs, x: torch.Tensor, chunk: int = 128,
                   mega: int = 8192):
    """One decoder layer over the whole prefix x [B, P, dim], in `chunk`-
    token steps (a whole-prefix layer's qkv/FFN transients are O(P * FFN)),
    each attended by flash_prefill over a one-layer view of the layer's
    K/V with the power-of-2 bound of its `mega`-token span. Returns
    (x_next, k_rot, v) with K/V packed [B, P, Hkv*D]."""
    B, P, D = x.shape
    if P % chunk or mega % chunk:
        raise ValueError(f"prefix {P} and span {mega} must be multiples of "
                         f"the chunk {chunk}")
    HD = config.n_kv_head * config.head_dim
    kf = x.new_zeros((B, P, HD))
    vf = x.new_zeros((B, P, HD))
    t = torch.arange(chunk, dtype=torch.int32, device=x.device)
    outs = []
    for m0 in range(0, P, mega):
        Tm = min(mega, P - m0)
        cap = 512
        while cap < m0 + Tm:
            cap *= 2
        cap = min(cap, P)
        for t0 in range(m0, m0 + Tm, chunk):
            xc = x[:, t0:t0 + chunk]
            q, k, v = _qkv(lp, config, xc)
            positions = (t0 + t)[None, :].expand(B, chunk)
            q = rope(config, q, positions)
            kf[:, t0:t0 + chunk] = rope(config, k, positions).reshape(
                B, chunk, HD)
            vf[:, t0:t0 + chunk] = v.reshape(B, chunk, HD)
            upto = (positions + 1).contiguous()
            ctx = flash_prefill(q, kf[None], vf[None], 0, upto, s_cap=cap)
            outs.append(_post_attn(lp, config, xc, ctx))
    return torch.cat(outs, dim=1), kf, vf


def _cluster_segment(kf: torch.Tensor, vf: torch.Tensor, n_clusters: int,
                     cap: int):
    """k-means over one segment's keys [B, P, HD] and its member table;
    returns (centroids [B, C, HD] in the cache dtype, member_valid
    [B, C, cap] bool, blocks [B, C, 2, cap, HD])."""
    B, P, HD = kf.shape
    valid = torch.ones((B, P), dtype=torch.float32, device=kf.device)
    cent, assign = kmeans(kf, valid, n_clusters)
    slots = member_slot_table(assign, valid, n_clusters, cap)    # [B, C, cap]
    src = slots.clamp(0, P - 1).reshape(B, -1).long()
    b_idx = torch.arange(B, device=kf.device)[:, None]
    k_blk = kf[b_idx, src].reshape(B, n_clusters, cap, HD)
    v_blk = vf[b_idx, src].reshape(B, n_clusters, cap, HD)
    return (cent.to(kf.dtype), slots >= 0,
            torch.stack([k_blk, v_blk], dim=2))


def _cluster_layer(kf: torch.Tensor, vf: torch.Tensor, n_clusters: int,
                   cap: int, segment: int = 8192):
    """Cluster one layer's keys in segments of `segment` slots (Lloyd's
    distance matrix is O(S * C) an iteration, and long contexts cluster
    locally anyway): n_clusters // n_segments clusters a segment, at least
    one. Returns _cluster_segment's three, concatenated over segments."""
    B, P, HD = kf.shape
    if P <= segment:
        return _cluster_segment(kf, vf, n_clusters, cap)
    n_seg = -(-P // segment)
    c_seg = max(n_clusters // n_seg, 1)
    parts = [_cluster_segment(kf[:, s0:s0 + segment], vf[:, s0:s0 + segment],
                              c_seg, cap) for s0 in range(0, P, segment)]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


@dataclass
class OffloadState:
    centroids: torch.Tensor      # [L, B, C, HD], the cache dtype
    member_valid: torch.Tensor   # [L, B, C, cap] bool
    tail_k: torch.Tensor         # [L, B, Wcap, HD]
    tail_v: torch.Tensor
    tail_len: torch.Tensor       # [B] int32
    tail_base: torch.Tensor      # [B] int32, absolute position of tail row 0
    prefix_len: int


@torch.inference_mode()
def offload_prefill(params, config: ModelArgs, store, tokens, *,
                    n_clusters: int, cap: int, tail_keep: int,
                    tail_slack: int = 64, device=None):
    """Layer-at-a-time prefill into a host cluster store.

    `store` must expose put_layer(l, blocks [B, C, 2, cap, HD])
    (HostBlockStore). Returns (OffloadState, buffer0 [B, 1] the first
    generated token). The device holds the activations and one layer's K/V
    at a time, never the whole context's KV."""
    dev = _resolve(device, config, params)
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    B, P = tokens.shape
    if not 0 < tail_keep <= P:
        raise ValueError(f"tail_keep {tail_keep} outside (0, {P}]")
    L = config.n_layer
    x = _embed(params, tokens)
    cents, valids, tks, tvs = [], [], [], []
    for l in range(L):
        x, kf, vf = _layer_prefill(_layer_params(params, l), config, x)
        cent, member_valid, blocks = _cluster_layer(kf, vf, n_clusters, cap)
        store.put_layer(l, blocks)
        cents.append(cent)
        valids.append(member_valid)
        tks.append(kf[:, P - tail_keep:].clone())
        tvs.append(vf[:, P - tail_keep:].clone())
        del kf, vf, blocks                       # free the layer's KV
    buffer0 = argmax_tokens(_logits(params, config, x[:, -1:]))

    pad = (0, 0, 0, tail_slack)
    state = OffloadState(
        centroids=torch.stack(cents), member_valid=torch.stack(valids),
        tail_k=torch.stack([F.pad(t, pad) for t in tks]),
        tail_v=torch.stack([F.pad(t, pad) for t in tvs]),
        tail_len=torch.full((B,), tail_keep, dtype=torch.int32, device=dev),
        tail_base=torch.full((B,), P - tail_keep, dtype=torch.int32,
                             device=dev),
        prefix_len=P)
    return state, buffer0


# ---------------------------------------------------------------------------
# Decode from the store: one token's layer in two halves around the fetch
# ---------------------------------------------------------------------------

def _part1_body(lp, config: ModelArgs, x, positions, cent_l, tail_k_l,
                tail_v_l, tail_slot, nprobe: int):
    """A layer's first half for one token x [B, 1, dim]: qkv, rope, the
    token's K/V written into the tail at tail_slot [B] (in place), and the
    cluster selection (centroid softmax summed over heads, top nprobe).
    Shared by every decode mode, so the AR steps and the spec verify run
    the same per-token program. cent_l None (the spec draft) skips the
    selection. Returns (q rotated [B, 1, Hq, D], top_c [B, nprobe] or
    None)."""
    Hkv, Dh = config.n_kv_head, config.head_dim
    G = config.n_head // Hkv
    B = x.shape[0]
    q, k, v = _qkv(lp, config, x)
    q = rope(config, q, positions)
    k = rope(config, k, positions)
    b_idx = torch.arange(B, device=x.device)
    tail_k_l[b_idx, tail_slot.long()] = k.reshape(B, -1)
    tail_v_l[b_idx, tail_slot.long()] = v.reshape(B, -1)
    if cent_l is None:
        return q, None
    C = cent_l.shape[1]
    qg = q.reshape(B, 1, Hkv, G, Dh).float()
    cg = cent_l.reshape(B, C, Hkv, Dh).float()
    logit = torch.einsum("bthgd,bchd->bthgc", qg, cg) * (Dh ** -0.5)
    scores = torch.softmax(logit, dim=-1).sum(dim=(1, 2, 3))   # [B, C]
    return q, torch.topk(scores, nprobe, dim=-1).indices


def _attend_body(lp, config: ModelArgs, x, q, k_sel, v_sel, mem_ok,
                 tail_k_l, tail_v_l, tail_bound):
    """A layer's second half for one token: attend [clusters | tail rows
    < tail_bound], then wo + FFN. k_sel/v_sel [B, NS, HD]; mem_ok [B, NS]
    bool; tail_bound [B], the token's causal bound including itself."""
    Hkv, Dh = config.n_kv_head, config.head_dim
    B, NS = k_sel.shape[:2]
    Wcap = tail_k_l.shape[1]
    k_all = torch.cat([k_sel.to(tail_k_l.dtype), tail_k_l], dim=1)
    v_all = torch.cat([v_sel.to(tail_v_l.dtype), tail_v_l], dim=1)
    col = torch.arange(NS + Wcap, device=x.device)
    tail_ok = (col[None, :] >= NS) & (col[None, :] < NS + tail_bound[:, None])
    mask = torch.cat([mem_ok, torch.zeros((B, Wcap), dtype=torch.bool,
                                          device=x.device)], dim=1) | tail_ok
    S = NS + Wcap
    ctx = masked_attention_general(q, k_all.reshape(B, S, Hkv, Dh),
                                   v_all.reshape(B, S, Hkv, Dh),
                                   mask[:, None, :])
    return _post_attn(lp, config, x, ctx)


def _hostloop_part2(lp, config: ModelArgs, x, q, blocks, mem_ok, tail_k_l,
                    tail_v_l, tail_len):
    """After the fetch: attend [clusters (blocks [B, nprobe, 2, cap, HD]) |
    causal tail], finish the block (wo + FFN)."""
    B = x.shape[0]
    nprobe, _, cap, HD = blocks.shape[1:]
    return _attend_body(lp, config, x, q,
                        blocks[:, :, 0].reshape(B, nprobe * cap, HD),
                        blocks[:, :, 1].reshape(B, nprobe * cap, HD),
                        mem_ok.reshape(B, nprobe * cap), tail_k_l, tail_v_l,
                        tail_len + 1)


def _member_ok(member_valid_l: torch.Tensor, top_c: torch.Tensor):
    """member_valid [B, C, cap] rows of the clusters top_c [B, n] ->
    [B, n, cap]."""
    b_idx = torch.arange(top_c.shape[0], device=top_c.device)[:, None]
    return member_valid_l[b_idx, top_c]


def _decode_step_fn(config: ModelArgs, fetch_fn, *, nprobe: int):
    """One decode step over (token, state): per layer score the centroids,
    fetch_fn(l, top_c [B, nprobe]) -> blocks [B, nprobe, 2, cap, HD] on the
    device, attend [clusters | causal tail]. The step writes the token's
    K/V into state's tails in place and returns (next token [B, 1], the
    state with tail_len + 1)."""

    def step(params, state: OffloadState, tok, layers):
        positions = (state.tail_base + state.tail_len)[:, None]
        x = _embed(params, tok)
        for l, lp in enumerate(layers):
            q, top_c = _part1_body(
                lp, config, x, positions, state.centroids[l],
                state.tail_k[l], state.tail_v[l], state.tail_len, nprobe)
            blocks = fetch_fn(l, top_c)
            x = _hostloop_part2(lp, config, x, q, blocks,
                                _member_ok(state.member_valid[l], top_c),
                                state.tail_k[l], state.tail_v[l],
                                state.tail_len)
        nxt = argmax_tokens(_logits(params, config, x))
        return nxt, replace(state, tail_len=state.tail_len + 1)

    return step


def host_fetch_fn(store, B: int, nprobe: int, cap: int, HD: int, dtype,
                  device=None):
    """fetch_fn serving clusters from the host store: the selection is read
    to the host, the store gathers the blocks into a pinned buffer and one
    asynchronous copy carries them to `device` (the JAX package's ordered
    io_callback). B, nprobe, cap, HD and dtype describe the blocks and are
    checked against the store."""
    if (store.B, store.cap, store.HD) != (B, cap, HD) or store.dtype != dtype:
        raise ValueError(f"the store holds B={store.B}, cap={store.cap}, "
                         f"HD={store.HD} of {store.dtype}, not B={B}, "
                         f"cap={cap}, HD={HD} of {dtype}")

    def fetch(l, top_c):
        if top_c.shape != (B, nprobe):
            raise ValueError(f"selection {tuple(top_c.shape)} != "
                             f"{(B, nprobe)}")
        return store.fetch(l, top_c.cpu().numpy(), device or top_c.device)

    return fetch


def device_fetch_fn(device_blocks: torch.Tensor):
    """On-device twin: device_blocks [L, B, C, 2, cap, HD]."""
    def fetch(l, top_c):
        b_idx = torch.arange(top_c.shape[0], device=top_c.device)[:, None]
        return device_blocks[l][b_idx, top_c]
    return fetch


def _check_tail(state: OffloadState, new_rows: int, what: str):
    """The tail has no compaction: it must hold every row a generation
    appends."""
    need = int(state.tail_len.max()) + new_rows
    if state.tail_k.shape[2] < need:
        raise ValueError(f"{what}: tail of {state.tail_k.shape[2]} slots < "
                         f"{need}; size tail_slack for the whole generation "
                         f"(the offload tail has no compaction)")


def _cloned(state: OffloadState) -> OffloadState:
    return replace(state, tail_k=state.tail_k.clone(),
                   tail_v=state.tail_v.clone())


@torch.inference_mode()
def offload_generate(params, config: ModelArgs, state: OffloadState, store,
                     buffer0, max_new_tokens: int, *, nprobe: int, cap: int,
                     fetch_fn=None, device=None):
    """Autoregressive generation with clustered-KV attention served from the
    host store (or a custom fetch_fn). Returns (tokens [B, max_new], the
    state after it)."""
    dev = _resolve(device, config, params, state.tail_k, buffer0)
    B = buffer0.shape[0]
    HD = config.n_kv_head * config.head_dim
    _check_tail(state, max_new_tokens - 1, "offload_generate")
    if fetch_fn is None:
        fetch_fn = host_fetch_fn(store, B, nprobe, cap, HD, state.tail_k.dtype,
                                 dev)
    step = _decode_step_fn(config, fetch_fn, nprobe=nprobe)
    layers = [_layer_params(params, l) for l in range(config.n_layer)]
    state = _cloned(state)
    toks = [buffer0]
    tok = buffer0
    for _ in range(max_new_tokens - 1):
        tok, state = step(params, state, tok, layers)
        toks.append(tok)
    return torch.cat(toks, dim=1), state


def offload_generate_hostloop(params, config: ModelArgs, state: OffloadState,
                              store, buffer0, max_new_tokens: int, *,
                              nprobe: int, cap: int,
                              lru: "ClusterLRU" = None, device=None):
    """Offload decode with the per-layer fetch in the host loop between the
    two layer halves (the JAX package's form for backends where an
    io_callback hangs). In eager PyTorch that is offload_generate itself:
    the same per-token program, so the same tokens.

    `lru`: an optional device-resident block cache (ClusterLRU); fetches
    then hit device memory for resident clusters and the host link only on
    misses."""
    fetch_fn = None
    if lru is not None:
        def fetch_fn(l, top_c):
            return lru.fetch(l, top_c.cpu().numpy())
    return offload_generate(params, config, state, store, buffer0,
                            max_new_tokens, nprobe=nprobe, cap=cap,
                            fetch_fn=fetch_fn, device=device)


# ---------------------------------------------------------------------------
# Speculation over the offloaded store
# ---------------------------------------------------------------------------

def _spec_draft_round(params, layers, config: ModelArgs, tok0, pos0, draft_k,
                      draft_v, draft_ok, tail_k, tail_v, tail_len0,
                      gamma: int) -> torch.Tensor:
    """gamma draft steps with no host traffic: each step attends [the
    previous verify's cluster blocks (draft_k/draft_v [L, B, NS, HD], at
    most gamma+1 tokens stale) | causal tail], appending its K/V to the
    tail (the verify overwrites the same slots). Returns the round's buffer
    [B, gamma+1]."""
    tok = tok0
    drafted = [tok0]
    for i in range(gamma):
        x = _embed(params, tok)
        for l, lp in enumerate(layers):
            q, _ = _part1_body(lp, config, x, pos0 + i, None, tail_k[l],
                               tail_v[l], tail_len0 + i, 0)
            x = _attend_body(lp, config, x, q, draft_k[l], draft_v[l],
                             draft_ok[l], tail_k[l], tail_v[l],
                             tail_len0 + i + 1)
        tok = argmax_tokens(_logits(params, config, x))
        drafted.append(tok)
    return torch.cat(drafted, dim=1)


def _spec_verify_l1(lp, config: ModelArgs, x_all, pos0, cent_l, tail_k_l,
                    tail_v_l, tail_len0, nprobe: int, T: int):
    """Verify, a layer's first half: the per-token program of
    _part1_body over the round's T = gamma+1 tokens ([B, 1] shapes, so
    selection and numerics are the AR steps'). Returns (q [B, T, Hq, D],
    top_c [B, T, nprobe])."""
    qs, tops = [], []
    for j in range(T):
        q, top_c = _part1_body(lp, config, x_all[:, j:j + 1].contiguous(),
                               pos0 + j, cent_l, tail_k_l, tail_v_l,
                               tail_len0 + j, nprobe)
        qs.append(q)
        tops.append(top_c)
    return torch.cat(qs, dim=1), torch.stack(tops, dim=1)


def _spec_verify_l2(lp, config: ModelArgs, x_all, q_all, blocks, mem_ok,
                    tail_k_l, tail_v_l, tail_len0, T: int):
    """Verify, a layer's second half: per token, attend its own fetched
    blocks (blocks [B, T, nprobe, 2, cap, HD]) + the causal tail."""
    B = x_all.shape[0]
    npb, _, cap, HD = blocks.shape[2:]
    outs = []
    for j in range(T):
        outs.append(_attend_body(
            lp, config, x_all[:, j:j + 1].contiguous(), q_all[:, j:j + 1],
            blocks[:, j, :, 0].reshape(B, npb * cap, HD),
            blocks[:, j, :, 1].reshape(B, npb * cap, HD),
            mem_ok[:, j].reshape(B, npb * cap), tail_k_l, tail_v_l,
            tail_len0 + j + 1))
    return torch.cat(outs, dim=1)


def _union(top: np.ndarray, U: int):
    """Per row, the sorted unique cluster ids of top [B, n] padded to U with
    the last id, and each entry's position in them."""
    B = top.shape[0]
    union = np.zeros((B, U), np.int64)
    posmap = np.zeros(top.shape, np.int64)
    for b in range(B):
        u = np.unique(top[b])[:U]
        union[b, :len(u)] = u
        union[b, len(u):] = u[-1] if len(u) else 0
        posmap[b] = np.minimum(np.searchsorted(u, top[b]),
                               max(len(u) - 1, 0))
    return union, posmap


@torch.inference_mode()
def offload_generate_spec(params, config: ModelArgs, state: OffloadState,
                          store, buffer0, max_new_tokens: int, *, gamma: int,
                          nprobe: int, cap: int, eot_ids=(),
                          lru: "ClusterLRU" = None, device=None):
    """Speculative decoding over the offloaded cluster store: the draft
    proposes gamma tokens attending [the previous verify's cluster blocks |
    causal tail] with no host traffic; the verify re-runs the per-token
    clustered attention of offload_generate_hostloop for all gamma+1
    tokens with one host gather per layer per round (the union of the
    round's selections, each cluster once; the per-token layout is
    rebuilt by one device gather). Greedy acceptance; rollback is a
    tail-length rewind (the verify rewrites the tail slots the draft
    wrote).

    Lossless: the verify is gamma+1 copies of the AR per-token program
    (the same [B, 1] shapes and selection rule), so the stream is
    offload_generate_hostloop's.

    `lru`: an optional ClusterLRU; the union fetch then takes resident
    clusters from device memory and only misses over the host link. Its
    nslots must hold the round's union (min(C, (gamma+1) * nprobe)).

    Returns (tokens [B, max_new_tokens + gamma + 2], state, stats dict)."""
    dev = _resolve(device, config, params, state.tail_k, buffer0)
    B = buffer0.shape[0]
    L = config.n_layer
    HD = config.n_kv_head * config.head_dim
    NS = nprobe * cap
    T = gamma + 1
    C = state.centroids.shape[2]
    U = min(C, T * nprobe)
    _check_tail(state, max_new_tokens + gamma + 2, "offload_generate_spec")
    if lru is not None and lru.nslots < U:
        raise ValueError(f"ClusterLRU of {lru.nslots} slots < the round's "
                         f"union of {U} clusters")
    eot = _eot_array(eot_ids, dev)
    layers = [_layer_params(params, l) for l in range(L)]
    state = _cloned(state)
    tail_k, tail_v = state.tail_k, state.tail_v
    tail_len = state.tail_len
    draft_k = tail_k.new_zeros((L, B, NS, HD))
    draft_v = tail_v.new_zeros((L, B, NS, HD))
    draft_ok = torch.zeros((L, B, NS), dtype=torch.bool, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None]

    out_cap = max_new_tokens + gamma + 2
    output = torch.zeros((B, out_cap + 1), dtype=torch.int32, device=dev)
    gen_counts = torch.zeros(B, dtype=torch.int32, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    terminal = torch.zeros((), dtype=torch.bool, device=dev)
    tok = buffer0
    rounds = 0
    while bool(~terminal & (gen_counts.min() < max_new_tokens)):
        pos0 = (state.tail_base + tail_len)[:, None]
        buffer = _spec_draft_round(params, layers, config, tok, pos0, draft_k,
                                   draft_v, draft_ok, tail_k, tail_v, tail_len,
                                   gamma)
        x_all = _embed(params, buffer)
        for l, lp in enumerate(layers):
            q_all, top_all = _spec_verify_l1(
                lp, config, x_all, pos0, state.centroids[l], tail_k[l],
                tail_v[l], tail_len, nprobe, T)
            top_flat = top_all.reshape(B, T * nprobe)
            union, posmap = _union(top_flat.cpu().numpy(), U)
            if lru is not None:
                slots = lru.admit(l, union)
                blocks = lru.gather(l, slots[np.arange(B)[:, None], posmap])
            else:
                blocks = store.fetch(l, union, dev)[
                    b_idx, torch.from_numpy(posmap).to(dev)]
            blocks = blocks.reshape(B, T, nprobe, 2, cap, HD)
            mem_ok = _member_ok(state.member_valid[l], top_flat).reshape(
                B, T, NS)
            x_all = _spec_verify_l2(lp, config, x_all, q_all, blocks, mem_ok,
                                    tail_k[l], tail_v[l], tail_len, T)
            # the next round's draft working set: the newest token's blocks
            draft_k[l] = blocks[:, T - 1, :, 0].reshape(B, NS, HD)
            draft_v[l] = blocks[:, T - 1, :, 1].reshape(B, NS, HD)
            draft_ok[l] = mem_ok[:, T - 1]
        target_tokens = argmax_tokens(_logits(params, config, x_all))
        accept, tok, gen_counts, term, acc = _accept_and_update(
            buffer, target_tokens, eot, gamma, output, gen_counts)
        tail_len = tail_len + accept
        rounds += 1
        accepted = accepted + acc
        terminal = terminal | term
    idx = torch.clamp(gen_counts, max=out_cap - 1).long()
    output[torch.arange(B, device=dev), idx] = tok[:, 0]
    stats = dict(rounds=rounds, accepted_drafts=int(accepted),
                 total_drafted=rounds * B * gamma,
                 generated=int((gen_counts + 1).sum()))
    return output[:, :out_cap], replace(state, tail_len=tail_len), stats


# ---------------------------------------------------------------------------
# The device-resident cluster LRU
# ---------------------------------------------------------------------------

def _lru_scatter(dev: torch.Tensor, l: int, b_idx: torch.Tensor,
                 slots: torch.Tensor, blocks: torch.Tensor) -> None:
    """Admit miss blocks into the device block cache in place: dev [L, B, S,
    2, cap, HD]; block i [2, cap, HD] of blocks goes to (l, b_idx[i],
    slots[i]). The JAX package pads the misses to a rectangle and drops the
    pad; the port scatters the flat list."""
    dev[l, b_idx, slots] = blocks.to(dev.dtype)


def _lru_gather(dev: torch.Tensor, l: int, idx: torch.Tensor) -> torch.Tensor:
    """dev [L, B, S, 2, cap, HD], idx [B, n] -> [B, n, 2, cap, HD]."""
    b_idx = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return dev[l][b_idx, idx]


class ClusterLRU:
    """Device-resident LRU cache of host-store cluster blocks.

    Adjacent decode rounds select heavily overlapping clusters, so a cache
    of `nslots` blocks per (layer, sequence) in device memory turns most
    fetches into device gathers; only misses cross the host link. The
    directory (cluster id -> slot, in recency order) lives on the host: the
    offload decode is host-driven anyway, so admission costs no extra
    device round trip.

    A cached block is the host store's bytes, so attention and the emitted
    stream are unchanged: the LRU only moves where bytes come from."""

    def __init__(self, store: HostBlockStore, nslots: int, device=None):
        self.store = store
        self.nslots = nslots
        self.device = resolve_device(device)
        L, B, cap, HD = store.L, store.B, store.cap, store.HD
        self.dev = torch.zeros((L, B, nslots, 2, cap, HD), dtype=store.dtype,
                               device=self.device)
        # per-(l, b) directory: id -> slot, insertion order = recency
        self._dir = [[OrderedDict() for _ in range(B)] for _ in range(L)]
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def gather(self, l: int, slots: np.ndarray) -> torch.Tensor:
        """Device slots [B, n] of layer l -> blocks [B, n, 2, cap, HD]."""
        return _lru_gather(self.dev, l, torch.from_numpy(
            np.asarray(slots, np.int64)).to(self.device))

    def fetch(self, l: int, ids: np.ndarray) -> torch.Tensor:
        """Cluster ids [B, n] -> blocks [B, n, 2, cap, HD] on the device:
        hits from the cache, misses fetched from the host store in one
        gather and admitted (evicting the least recently used slots)."""
        return self.gather(l, self.admit(l, ids))

    @torch.inference_mode()
    def admit(self, l: int, ids: np.ndarray) -> np.ndarray:
        """Resolve cluster ids [B, n] to device slots [B, n], fetching the
        misses. A row's distinct ids must fit nslots, or the call would
        evict blocks it is itself using."""
        ids = np.asarray(ids)
        B, n = ids.shape
        for b in range(B):
            distinct = len(dict.fromkeys(ids[b].tolist()))
            if distinct > self.nslots:
                raise ValueError(f"{distinct} distinct clusters in one row > "
                                 f"the LRU's {self.nslots} slots")
        out = np.empty((B, n), np.int64)
        miss_ids, miss_b, miss_slots = [], [], []
        for b in range(B):
            d = self._dir[l][b]
            for j, cid in enumerate(ids[b].tolist()):
                slot = d.get(cid)
                if slot is not None:
                    d.move_to_end(cid)
                    out[b, j] = slot
                    self.hits += 1
                    continue
                self.misses += 1
                if len(d) < self.nslots:
                    slot = len(d)
                else:
                    _, slot = d.popitem(last=False)      # evict the LRU
                    self.evictions += 1
                d[cid] = slot
                out[b, j] = slot
                miss_ids.append(cid)
                miss_b.append(b)
                miss_slots.append(slot)
        if miss_ids:
            # one exact flat host gather: the host link moves misses only
            st = self.store
            flat = ((l * st.B + np.asarray(miss_b)) * st.C
                    + np.asarray(miss_ids, np.int64))
            _lru_scatter(self.dev, l,
                         torch.as_tensor(miss_b, device=self.device),
                         torch.as_tensor(miss_slots, device=self.device),
                         st.fetch_slots(flat, self.device))
        return out
