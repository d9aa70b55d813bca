"""GliDe speculation engine: linear and tree drafting with the cross-attention
draft block of models/glide.py, greedy and stochastic verification (port of
magicdec_tpu/engine/glide_engine.py).

Where the JAX package runs a whole generation inside one lax.while_loop,
the port runs a Python loop over rounds with one host read per round (of
the flag that ends the loop), as engine/spec.py does. Caches are written in
place and rollback is a length rewind.

Slot discipline (as in the JAX package): tree node j occupies cache slot
base + j in both the glide's own cache and the target cache during a round;
the accepted root-to-leaf path is compacted to the front afterwards, in
every target layer and in the own cache. A compaction write past a cache's
end is dropped, never clamped onto a live slot (the JAX package's
dynamic_update_slice clamps it), and GlideEngine refuses an own cache
smaller than the target's.

Kernel routes: on a CUDA device (use_flash) the linear draft runs the flat
decode kernel for both attentions, the tree draft the intervals kernel with
return_lse over the own prefix merged with a dense block over the tree
slots, the tree verify flash_decode_stacked with return_lse over the prefix
merged with a dense block over the tree rows (attention_impls.
flash_stacked_lse), and glide prefill chunks the prefill kernel. The
stochastic round takes the greedy round's route (the JAX package runs it
dense; the dense [B, N, S] form is that route's plain version, and no
plain version runs on the card). On the CPU every route is the dense one.

Parallelism: on a target Engine sharded over a dp x tp mesh the block is
cut as a target layer (sharding.shard_glide_params; models/glide.py holds
its collectives), the own cache [B/dp, cap, (Hkv/tp)*D] holds the rank's
rows and KV heads, the tree verify's prefix part runs through the
per-shard form flash_stacked_lse, the loops take their flags over every dp
rank (spec.round_flags) and the streams are gathered at the end. The JAX
package runs GliDe on a mesh through dense GSPMD, so its single-device
stream is the reference.

Losslessness scope (as in the JAX package): the linear verify is
target_attn, the AR step's route, so its stream is bit-equal to the AR
stream. The tree verify attends under the ancestor mask, so at numerical
near-ties its argmax can differ from the AR kernel's: the tree stream is
the greedy stream of the tree-masked target forward (exact on the CPU test
shapes and in float32).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from magicdec_tpu_torch import cache as cache_lib
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine.backend import Engine
from magicdec_tpu_torch.engine.sampling import argmax_tokens, categorical, uniform
from magicdec_tpu_torch.engine.spec import (SpecStats, _accept_and_update,
                                            _eot_array, _is_eot, _sync,
                                            finish_stats, round_flags)
from magicdec_tpu_torch.models import glide as glide_lib
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops.attention import (masked_attention_general,
                                              masked_attention_lse, merge_lse)
from magicdec_tpu_torch.parallel import sharding


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B] -> contiguous int32 [B, n] (per-query row bounds)."""
    return x.to(torch.int32)[:, None].expand(x.shape[0], n).contiguous()


# ---------------------------------------------------------------------------
# Linear GliDe speculation
# ---------------------------------------------------------------------------

@torch.inference_mode()
def glide_round(params, glide_params, config: ModelArgs, cache, own_k, own_v,
                own_len, buffer0, output, gen_counts, eot, gamma: int,
                use_flash: bool = False):
    """One linear round: gamma glide draft steps (cross-attending the
    verified prefix [0, lenT0) of the target's last layer), one more glide
    forward that appends the last drafted token's K/V (accept can reach
    gamma + 1 and own_len advances by accept, so that slot must hold it),
    the verify through target_attn (the AR step's route) and the acceptance
    of engine/spec.py. Caches and output are written in place; returns
    (own_len, bonus [B, 1], gen_counts, info)."""
    lenT0 = cache.lengths
    tgt_valid = _rows(lenT0, 1)

    def draft(tok, i, unembed=True):
        return glide_lib.glide_forward(
            glide_params, params, config, tok, lenT0[:, None] + i, own_k,
            own_v, own_len + i, cache.k[-1], cache.v[-1], tgt_valid,
            use_flash=use_flash, unembed=unembed)

    tok, drafted = buffer0, []
    for i in range(gamma):
        tok = argmax_tokens(draft(tok, i)[:, -1:])
        drafted.append(tok)
    draft(tok, gamma, unembed=False)
    buffer = torch.cat([buffer0] + drafted, dim=1)          # [B, gamma+1]

    impl = impls.target_attn(config, lenT0, gamma + 1)
    logits = llama.forward(params, config, buffer, impl, (cache.k, cache.v))
    accept, bonus, gen_counts, terminal, accepted = _accept_and_update(
        buffer, argmax_tokens(logits), eot, gamma, output, gen_counts)
    cache.lengths = lenT0 + accept
    return own_len + accept, bonus, gen_counts, dict(
        terminal=terminal, accepted_drafts=accepted, accept_nums=accept)


@torch.inference_mode()
def glide_generate(params, glide_params, config: ModelArgs, cache, own_k,
                   own_v, own_len, buffer0, eot, gamma: int,
                   max_new_tokens: int, use_flash: bool = False, mesh=None):
    """Linear GliDe generation (the port's form of the JAX package's
    glide_generate_fused): rounds while no sequence hit EOS, some sequence
    has fewer than max_new_tokens tokens and the target cache has room for
    gamma + 1 more, read on the host once per round (over every dp rank of
    `mesh`). Returns (own_len, output [B, max_new_tokens + gamma + 2],
    gen_counts [B], rounds, accepted drafts), of the rank's rows."""
    B, dev = buffer0.shape[0], buffer0.device
    cap = max_new_tokens + gamma + 2
    output = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
    gen_counts = torch.zeros(B, dtype=torch.int32, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    terminal = torch.zeros((), dtype=torch.bool, device=dev)
    rounds = 0
    while round_flags(mesh, terminal, gen_counts, cache.lengths,
                      max_new_tokens, gamma + 1, cache.max_len)[0]:
        own_len, buffer0, gen_counts, info = glide_round(
            params, glide_params, config, cache, own_k, own_v, own_len,
            buffer0, output, gen_counts, eot, gamma, use_flash)
        rounds += 1
        accepted = accepted + info["accepted_drafts"]
        terminal = terminal | info["terminal"]
    idx = torch.clamp(gen_counts, max=cap - 1).long()
    output[torch.arange(B, device=dev), idx] = buffer0[:, 0]
    return own_len, output[:, :cap], gen_counts + 1, rounds, int(accepted)


# ---------------------------------------------------------------------------
# Static speculation trees
# ---------------------------------------------------------------------------

class SpecTree:
    """Static token tree. branching[d] = children per node at depth d. Node
    ids are assigned level by level; node 0 (the root) is the round's input
    token."""

    def __init__(self, branching):
        self.branching = tuple(branching)
        parents = [-1]
        levels = [[0]]
        for b in self.branching:
            nxt = []
            for p in levels[-1]:
                for _ in range(b):
                    nxt.append(len(parents))
                    parents.append(p)
            levels.append(nxt)
        self.parents = np.asarray(parents, np.int32)
        self.n_nodes = len(parents)
        self.levels = [np.asarray(lv, np.int32) for lv in levels]
        self.depth = np.zeros(self.n_nodes, np.int32)
        for i in range(1, self.n_nodes):
            self.depth[i] = self.depth[self.parents[i]] + 1
        anc = np.eye(self.n_nodes, dtype=bool)   # ancestor-or-self
        for i in range(self.n_nodes):
            j = self.parents[i]
            while j != -1:
                anc[i, j] = True
                j = self.parents[j]
        self.ancestor = anc


def _tree_mask(anc_rows, base: torch.Tensor, n_nodes: int,
               S: int) -> torch.Tensor:
    """[B, T, S] bool: slots < base[b] (the prefix) plus the ancestor node
    slots base[b] + j where anc_rows[t, j]. anc_rows: [T, n_nodes] bools."""
    anc = torch.as_tensor(np.asarray(anc_rows), device=base.device)
    slot = torch.arange(S, device=base.device)
    rel = slot[None, :] - base.long()[:, None]                   # [B, S]
    in_tree = (rel >= 0) & (rel < n_nodes)
    anc_cols = anc[:, torch.clamp(rel, 0, n_nodes - 1)]          # [T, B, S]
    return (rel < 0)[:, None, :] | (in_tree[:, None, :]
                                    & anc_cols.permute(1, 0, 2))


def _tree_target_impl(config: ModelArgs, lengths_before, positions,
                      full_mask):
    """Dense tree verify: the tree's K/V are appended at lengths_before +
    node id, then attention over the prefix and the ancestor-masked tree
    block (full_mask [B, N, S])."""
    rot = impls._Rotary(config, positions)
    slots = impls._Slots(lengths_before, positions.shape[1])
    Hkv, Dh = config.n_kv_head, config.head_dim

    def impl(q, k, v, caches, l):
        ck, cv = caches
        B, T = q.shape[:2]
        q, k = rot(q), rot(k)
        slots.write(ck, k, l)
        slots.write(cv, v, l)
        S = ck.shape[2]
        ctx = masked_attention_general(q, ck[l].reshape(B, S, Hkv, Dh),
                                       cv[l].reshape(B, S, Hkv, Dh),
                                       full_mask)
        return ctx.reshape(B, T, -1)

    return impl


def _tree_target_impl_flash(config: ModelArgs, lengths_before, positions,
                            anc):
    """Tree verify as [flash_decode_stacked with return_lse over the prefix
    [0, lengths_before) | dense attention over the N tree rows], merged with
    merge_lse. The tree rows need no cache read: this layer's freshly
    rotated k/v are the tree block."""
    B, N = positions.shape
    rot = impls._Rotary(config, positions)
    slots = impls._Slots(lengths_before, N)
    hi = _rows(lengths_before, N)
    tm = torch.as_tensor(np.asarray(anc),
                         device=positions.device)[None].expand(B, N, N)

    def impl(q, k, v, caches, l):
        ck, cv = caches
        q, k = rot(q), rot(k)
        slots.write(ck, k, l)
        slots.write(cv, v, l)
        ctx_p, m_p, l_p = impls.flash_stacked_lse(q, ck, cv, l, hi,
                                                  mesh=config.mesh)
        ctx_t, m_t, l_t = masked_attention_lse(q, k, v, tm)
        return merge_lse(ctx_p, m_p, l_p, ctx_t, m_t, l_t).reshape(B, N, -1)

    return impl


def _compact_path(arrays, base: torch.Tensor, path: torch.Tensor) -> None:
    """Move slots base + path[:, i] to base + i (i <= depth) in each cache of
    `arrays`, flat [B, S, HD] (the own cache) or stacked [L, B, S, HD] (the
    target cache), in place. Rows past each new length land on dead slots
    (the next round writes its tree nodes there before anything reads
    them). A destination past the cache end is dropped (cache.append_slots):
    the JAX package's dynamic_update_slice would clamp it onto live prefix
    slots."""
    B, depth1 = path.shape
    b_idx = torch.arange(B, device=path.device)[:, None]
    src = base.long()[:, None] + path.long()
    for a in arrays:
        c = a if a.dim() == 4 else a.unsqueeze(0)
        S = c.shape[2]
        gathered = c[:, b_idx, torch.clamp(src, max=S - 1)]   # [L, B, d1, HD]
        slots = cache_lib.append_slots(base, depth1, S)
        old = c[:, slots.b_idx, slots.s_idx]
        c[:, slots.b_idx, slots.s_idx] = torch.where(slots.keep, gathered, old)


def _level_route(tree: SpecTree, lvl, own_len, Sd: int, use_flash: bool):
    """glide_forward's self-attention route for one tree level."""
    if use_flash:
        return dict(use_flash=True, tree=(tree.ancestor[lvl], own_len))
    return dict(attn_mask=_tree_mask(tree.ancestor[lvl], own_len,
                                     tree.n_nodes, Sd))


def _draft_level(params, glide_params, config, tree, d: int, node_tokens,
                 own_k, own_v, own_len, cache, use_flash, unembed=True):
    """One glide forward over tree level d (its nodes at own slots own_len +
    node id, rope position lenT0 + d); returns logits [B, n_lvl, V] (None
    with unembed=False)."""
    B = node_tokens.shape[0]
    lvl = tree.levels[d]
    lenT0 = cache.lengths
    toks = node_tokens[:, torch.as_tensor(lvl, device=node_tokens.device).long()]
    return glide_lib.glide_forward(
        glide_params, params, config, toks,
        (lenT0[:, None] + d).expand(B, len(lvl)), own_k, own_v,
        own_len + int(lvl[0]), cache.k[-1], cache.v[-1],
        _rows(lenT0, len(lvl)), unembed=unembed,
        **_level_route(tree, lvl, own_len, own_k.shape[1], use_flash))


def _write_leaf_level_kv(params, glide_params, config, tree: SpecTree,
                         node_tokens, own_k, own_v, own_len, cache,
                         use_flash: bool = False) -> None:
    """Append the leaf level's K/V to the glide cache (no logits).
    The draft loop forwards levels 0..depth-1 only (leaves spawn no
    children), yet a fully accepted path ends at a leaf and _compact_path
    moves that slot into the live prefix: without this write the next
    round's draft would attend a slot never written."""
    _draft_level(params, glide_params, config, tree, len(tree.branching),
                 node_tokens, own_k, own_v, own_len, cache, use_flash,
                 unembed=False)


def _tree_verify_logits(params, config, tree: SpecTree, cache, node_tokens,
                        use_flash: bool):
    """The target forward over every tree node (appended at lenT0 + node
    id, rope position lenT0 + depth) -> logits [B, N, V] f32."""
    lenT0 = cache.lengths
    depth = torch.as_tensor(tree.depth, device=lenT0.device)
    positions = lenT0[:, None] + depth[None, :]
    if use_flash:
        impl = _tree_target_impl_flash(config, lenT0, positions,
                                       tree.ancestor)
    else:
        impl = _tree_target_impl(config, lenT0, positions,
                                 _tree_mask(tree.ancestor, lenT0,
                                            tree.n_nodes, cache.max_len))
    return llama.forward(params, config, node_tokens, impl,
                         (cache.k, cache.v))


def _children(tree: SpecTree, d: int, cur: torch.Tensor) -> torch.Tensor:
    """[B] node ids at depth d -> their children's ids [B, b] (rows whose
    node lies at an earlier depth get level d's first node's children, as
    the JAX package's searchsorted gives; callers mask those rows)."""
    b = tree.branching[d]
    tbl = torch.as_tensor(tree.levels[d + 1], device=cur.device).long()
    return tbl.reshape(-1, b)[torch.clamp(cur - int(tree.levels[d][0]),
                                          min=0)]


def _finish_round(cache, own_k, own_v, own_len, lenT0, node_tokens, path,
                  emit_len, bonus, eot):
    """Compact the accepted path in both caches and advance the lengths;
    returns (own_len, emitted [B, depth+1], emit_len, bonus, terminal)."""
    emitted = torch.gather(node_tokens, 1, path)
    _compact_path((cache.k, cache.v), lenT0, path)
    _compact_path((own_k, own_v), own_len, path)
    cache.lengths = lenT0 + emit_len
    terminal = _is_eot(bonus[:, 0], eot).any()
    return own_len + emit_len, emitted, emit_len, bonus, terminal


@torch.inference_mode()
def glide_tree_round(params, glide_params, config: ModelArgs, tree: SpecTree,
                     cache, own_k, own_v, own_len, root_tok, eot,
                     use_flash: bool = False):
    """One greedy tree-speculation round; caches written in place. Returns
    (own_len, emitted [B, depth+1], emit_len [B], bonus [B, 1], terminal).

    emitted[:, 0] is the root (the already verified input token); emit_len
    counts the root and the accepted draft tokens; bonus is the target's
    continuation after the accepted path and seeds the next round."""
    B, N = root_tok.shape[0], tree.n_nodes
    dev = root_tok.device
    lenT0 = cache.lengths

    # draft the tree level by level: the top-b glide tokens of each node
    node_tokens = torch.zeros((B, N), dtype=torch.int32, device=dev)
    node_tokens[:, 0] = root_tok[:, 0]
    for d, b in enumerate(tree.branching):
        logits = _draft_level(params, glide_params, config, tree, d,
                              node_tokens, own_k, own_v, own_len, cache,
                              use_flash)
        top = torch.topk(logits, b, dim=-1).indices.to(torch.int32)
        child = torch.as_tensor(tree.levels[d + 1], device=dev).long()
        node_tokens[:, child] = top.reshape(B, -1)
    _write_leaf_level_kv(params, glide_params, config, tree, node_tokens,
                         own_k, own_v, own_len, cache, use_flash)

    # verify every node in one target forward
    target_tokens = argmax_tokens(_tree_verify_logits(
        params, config, tree, cache, node_tokens, use_flash))

    # greedy root-to-leaf walk
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    emit_len = torch.ones(B, dtype=torch.int32, device=dev)
    path = torch.zeros((B, len(tree.branching) + 1), dtype=torch.long,
                       device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    for d in range(len(tree.branching)):
        tgt = torch.gather(target_tokens, 1, cur[:, None])[:, 0]
        childs = _children(tree, d, cur)                     # [B, b]
        hit = torch.gather(node_tokens, 1, childs) == tgt[:, None]
        step_ok = hit.any(dim=1) & alive & ~_is_eot(tgt, eot)
        pick = hit.to(torch.int32).argmax(dim=1)             # first hit
        nxt = torch.gather(childs, 1, pick[:, None].long())[:, 0]
        cur = torch.where(step_ok, nxt, cur)
        path[:, d + 1] = torch.where(step_ok, nxt, 0)
        emit_len = emit_len + step_ok.to(torch.int32)
        alive = step_ok
    bonus = torch.gather(target_tokens, 1, cur[:, None])
    return _finish_round(cache, own_k, own_v, own_len, lenT0, node_tokens,
                         path, emit_len, bonus, eot)


@torch.inference_mode()
def glide_tree_generate(params, glide_params, config: ModelArgs,
                        tree: SpecTree, cache, own_k, own_v, own_len, root0,
                        eot, max_new_tokens: int, use_flash: bool = False,
                        mesh=None):
    """Greedy tree generation (the port's form of the JAX package's
    glide_tree_generate_fused): rounds while no sequence hit EOS, some
    sequence has fewer than max_new_tokens tokens and the target cache has
    room for every node, read on the host once per round (over every dp
    rank of `mesh`). Returns (own_len, output [B, max_new_tokens + depth +
    2], gen_counts [B], rounds, accepted drafts), of the rank's rows."""
    B, dev = root0.shape[0], root0.device
    depth1 = len(tree.branching) + 1
    O = max_new_tokens + depth1 + 1
    output = torch.zeros((B, O + 1), dtype=torch.int32, device=dev)
    gen_counts = torch.zeros(B, dtype=torch.int32, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    terminal = torch.zeros((), dtype=torch.bool, device=dev)
    ar = torch.arange(depth1, dtype=torch.int32, device=dev)[None, :]
    rounds, root = 0, root0
    while round_flags(mesh, terminal, gen_counts, cache.lengths,
                      max_new_tokens, tree.n_nodes, cache.max_len)[0]:
        own_len, emitted, emit_len, root, term = glide_tree_round(
            params, glide_params, config, tree, cache, own_k, own_v, own_len,
            root, eot, use_flash)
        # column O is a dump column for the writes the JAX package drops
        pos = torch.where(ar < emit_len[:, None],
                          torch.clamp(gen_counts[:, None] + ar, max=O - 1), O)
        output.scatter_(1, pos.long(), emitted)
        gen_counts = gen_counts + emit_len
        rounds += 1
        accepted = accepted + (emit_len - 1).sum()
        terminal = terminal | term
    idx = torch.clamp(gen_counts, max=O - 1).long()
    output[torch.arange(B, device=dev), idx] = root[:, 0]
    return own_len, output[:, :O], gen_counts + 1, rounds, int(accepted)


# ---------------------------------------------------------------------------
# Stochastic verification (SpecInfer-style tree walk; per-token rejection
# sampling with residual renormalization)
# ---------------------------------------------------------------------------

def stochastic_tree_walk(generator: torch.Generator, tree: SpecTree,
                         node_tokens, target_probs, draft_probs):
    """SpecInfer-style stochastic root-to-leaf walk.

    node_tokens [B, N]; target_probs / draft_probs [B, N, V]: the target's
    and the draft's next-token distributions at each node (draft_probs[n]
    is the distribution the children of n were sampled from). At each node
    the children are tried in order: child c is accepted with probability
    min(1, p(c) / q(c)); after each rejection the target distribution
    becomes norm(max(p - q, 0)). If every child is rejected the bonus is
    drawn from that residual; if a leaf is reached, from the target's
    distribution at the leaf. This keeps the target marginal exactly.
    Draws come from `generator`. Returns (path [B, depth+1] node ids,
    emit_len [B], bonus [B, 1])."""
    B = target_probs.shape[0]
    dev = target_probs.device
    rows = torch.arange(B, device=dev)
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    emit_len = torch.ones(B, dtype=torch.int32, device=dev)
    path = torch.zeros((B, len(tree.branching) + 1), dtype=torch.long,
                       device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    p_resid = target_probs[:, 0]
    for d, b in enumerate(tree.branching):
        p, q = target_probs[rows, cur], draft_probs[rows, cur]   # [B, V]
        childs = _children(tree, d, cur)
        ctoks = torch.gather(node_tokens, 1, childs).long()
        accepted = torch.zeros(B, dtype=torch.bool, device=dev)
        pick = torch.zeros(B, dtype=torch.long, device=dev)
        for i in range(b):
            p_i = torch.gather(p, 1, ctoks[:, i:i + 1])[:, 0]
            q_i = torch.gather(q, 1, ctoks[:, i:i + 1])[:, 0]
            u = uniform(generator, (B,), dev)
            acc_i = ((u < torch.clamp(p_i / torch.clamp(q_i, min=1e-20),
                                      max=1.0)) & ~accepted & alive)
            pick = torch.where(acc_i, i, pick)
            move = ~accepted & alive & ~acc_i      # rejected: the residual
            p_new = torch.clamp(p - q, min=0.0)
            p_new = p_new / torch.clamp(p_new.sum(-1, keepdim=True), min=1e-20)
            p = torch.where(move[:, None], p_new, p)
            accepted = accepted | acc_i
        nxt = torch.gather(childs, 1, pick[:, None])[:, 0]
        cur = torch.where(accepted, nxt, cur)
        path[:, d + 1] = torch.where(accepted, nxt, 0)
        emit_len = emit_len + accepted.to(torch.int32)
        # rows that reject every child stop; their bonus comes from the
        # residual at the moment of rejection
        p_resid = torch.where((alive & ~accepted)[:, None], p, p_resid)
        alive = alive & accepted
    p_bonus = torch.where(alive[:, None], target_probs[rows, cur], p_resid)
    # the JAX package draws from log(max(p, 1e-30)): the same distribution
    bonus = categorical(generator, probs=torch.clamp(p_bonus, min=1e-30))
    return path, emit_len, bonus


@torch.inference_mode()
def glide_tree_round_stochastic(params, glide_params, config: ModelArgs,
                                tree: SpecTree, cache, own_k, own_v, own_len,
                                root_tok, eot, generator: torch.Generator,
                                temperature: float = 1.0,
                                use_flash: bool = False):
    """Stochastic glide_tree_round: the children of each node are drawn
    i.i.d. from the glide's distribution (as SpecInfer) and verified by
    stochastic_tree_walk, so the emitted tokens follow the target's
    distribution rather than its greedy chain. Draws come from `generator`
    (on the caches' device). Same returns as glide_tree_round."""
    B, N, V = root_tok.shape[0], tree.n_nodes, config.vocab_size
    dev = root_tok.device
    lenT0 = cache.lengths
    inv_t = 1.0 / max(temperature, 1e-5)

    node_tokens = torch.zeros((B, N), dtype=torch.int32, device=dev)
    node_tokens[:, 0] = root_tok[:, 0]
    draft_probs = torch.full((B, N, V), 1.0 / V, dtype=torch.float32,
                             device=dev)
    for d, b in enumerate(tree.branching):
        logits = _draft_level(params, glide_params, config, tree, d,
                              node_tokens, own_k, own_v, own_len, cache,
                              use_flash)
        probs = torch.softmax(logits.float() * inv_t, dim=-1)  # [B, n_lvl, V]
        draft_probs[:, torch.as_tensor(tree.levels[d], device=dev).long()] = probs
        draws = categorical(generator, probs=probs, num_samples=b)
        child = torch.as_tensor(tree.levels[d + 1], device=dev).long()
        node_tokens[:, child] = draws.reshape(B, -1)
    _write_leaf_level_kv(params, glide_params, config, tree, node_tokens,
                         own_k, own_v, own_len, cache, use_flash)

    logits = _tree_verify_logits(params, config, tree, cache, node_tokens,
                                 use_flash)
    target_probs = torch.softmax(logits.float() * inv_t, dim=-1)
    path, emit_len, bonus = stochastic_tree_walk(generator, tree, node_tokens,
                                                 target_probs, draft_probs)
    return _finish_round(cache, own_k, own_v, own_len, lenT0, node_tokens,
                         path, emit_len, bonus, eot)


def stochastic_verify(generator: torch.Generator, draft_probs, target_probs,
                      draft_tokens):
    """Per-token speculative rejection sampling over a linear chain,
    vectorized over the batch. draft_probs / target_probs [B, gamma, V];
    draft_tokens [B, gamma]. Token i is accepted with probability
    min(1, p_t / p_d); each row's first rejection is replaced by a draw from
    norm(max(p_t - p_d, 0)). Rows accepting all gamma take their bonus from
    the target's next-position distribution (the caller's part). Returns
    (accept_len [B], replacement [B], has_replacement [B])."""
    B, G, _ = draft_probs.shape
    dev = draft_probs.device
    tok = draft_tokens.long()[..., None]
    pt = torch.gather(target_probs, -1, tok)[..., 0]
    pd = torch.gather(draft_probs, -1, tok)[..., 0]
    u = uniform(generator, (B, G), dev)
    ok = u < torch.clamp(pt / torch.clamp(pd, min=1e-20), max=1.0)
    accept_len = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    rej = torch.clamp(accept_len, max=G - 1)                 # first rejected
    rows = torch.arange(B, device=dev)
    resid = torch.clamp(target_probs[rows, rej] - draft_probs[rows, rej],
                        min=0.0)
    resid = resid / torch.clamp(resid.sum(-1, keepdim=True), min=1e-20)
    repl = categorical(generator, probs=torch.clamp(resid, min=1e-30))[:, 0]
    return accept_len.to(torch.int32), repl, accept_len < G


# ---------------------------------------------------------------------------
# Engine wrapper
# ---------------------------------------------------------------------------

class GlideEngine:
    """A target Engine plus the glide draft block; linear or greedy tree
    speculation. The glide's own cache [B, own_capacity, Hkv*D] holds the
    prompt and every verified token, so it may not be smaller than the
    target cache (own_capacity None: the target's max_len). The kernel
    routes run when the target lives on a CUDA device."""

    def __init__(self, target: Engine, glide_params,
                 own_capacity: int | None = None):
        cap = own_capacity or target.max_len
        if cap < target.max_len:
            raise ValueError(f"own_capacity {cap} < the target's max_len "
                             f"{target.max_len}: the glide cache would drop "
                             f"verified tokens")
        if target.config.mesh is not None:
            glide_params = sharding.shard_glide_params(
                glide_params, target.mesh, target.model_config)
        if glide_params["wqkv"].device != target.device:
            raise ValueError(f"glide params lie on "
                             f"{glide_params['wqkv'].device}, the target on "
                             f"{target.device}")
        self.target = target
        self.glide_params = glide_params
        c = target.config
        B = target.local_batch
        self.own_k = torch.zeros((B, cap, c.n_kv_head * c.head_dim),
                                 dtype=target.kv_dtype, device=target.device)
        self.own_v = torch.zeros_like(self.own_k)
        self.own_len = torch.zeros(B, dtype=torch.int32, device=target.device)
        self.use_flash = target.device.type == "cuda"

    @torch.inference_mode()
    def encode(self, input_ids) -> torch.Tensor:
        """The target's chunked prefill, then the glide's own prefill over
        the same prompt in the same chunks (cross-attention causally bounded
        per position). input_ids is the whole batch's; returns the first
        generated token of the rank's rows [B/dp, 1]."""
        t = self.target
        buffer0 = t.encode(input_ids)
        input_ids = sharding.shard_tokens(t._tokens(input_ids), t.mesh)
        chunk = t.prefill_chunk
        self.own_len = torch.zeros_like(self.own_len)
        ar = torch.arange(chunk, dtype=torch.int32, device=t.device)[None, :]
        for i in range(input_ids.shape[1] // chunk):
            pos = self.own_len[:, None] + ar
            glide_lib.glide_forward(
                self.glide_params, t.params, t.config,
                input_ids[:, i * chunk:(i + 1) * chunk], pos, self.own_k,
                self.own_v, self.own_len, t.cache.k[-1], t.cache.v[-1],
                pos + 1, use_flash=self.use_flash, unembed=False)
            self.own_len = self.own_len + chunk
        return buffer0

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int, *, gamma: int = 4,
                 tree: SpecTree | None = None, eot_ids=()
                 ) -> tuple[torch.Tensor, torch.Tensor, SpecStats]:
        """Linear (tree None, gamma drafts a round) or greedy tree
        speculation. Returns (output [B, cap], gen_counts [B], stats), cap =
        max_new_tokens + gamma + 2 (linear) or + depth + 2 (tree), of the
        whole batch under dp. Timing starts after both prefills."""
        t = self.target
        eot = _eot_array(eot_ids, t.device)
        buffer0 = self.encode(input_ids)
        stats = SpecStats()
        _sync(t.device)
        t0 = time.perf_counter()
        common = (t.params, self.glide_params, t.config)
        if tree is None:
            self.own_len, output, gen_counts, rounds, accepted = glide_generate(
                *common, t.cache, self.own_k, self.own_v, self.own_len,
                buffer0, eot, gamma, max_new_tokens, self.use_flash, t.mesh)
            per_row = gamma
        else:
            (self.own_len, output, gen_counts, rounds,
             accepted) = glide_tree_generate(
                *common, tree, t.cache, self.own_k, self.own_v, self.own_len,
                buffer0, eot, max_new_tokens, self.use_flash, t.mesh)
            per_row = len(tree.branching)
        _sync(t.device)
        stats.wall_time_s = time.perf_counter() - t0
        stats.rounds = rounds
        output, gen_counts = finish_stats(
            t.mesh, stats, output, gen_counts,
            torch.tensor(accepted, device=t.device), per_row)
        return output, gen_counts, stats
