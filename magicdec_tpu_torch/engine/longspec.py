"""Standalone-draft speculative decoding, two models (port of
magicdec_tpu/engine/longspec.py).

A small draft model speculates gamma tokens and the large target verifies
them. The draft keeps its own KV cache in one of three modes:
  * "full"       classic SD over the draft's full KV cache (draft spec=None);
  * "snapkv"     the draft compresses its own prefill KV to the budget;
  * "streaming"  a sink + window budget cache.
Each round re-feeds the newest accepted token together with the round's
input, so the first draft step always has T=2 (the reference's ragged
double-advance made uniform). Where the JAX package runs every round inside
one lax.while_loop, the port runs a Python loop over rounds with one host
read per round, as engine/spec.py does.

Asymmetric tensor parallelism: the target Engine sharded over a tp mesh,
the draft Engine on the same mesh with replicate_tp=True (the whole draft
and its whole-head kernels on every rank). Each round the drafted tokens
are broadcast from tp rank 0, as the reference does
(tests/SnapKV/longspec_benchmark.py:54-64), so the ranks feed one verify
with the same tokens whatever their draft computed. Under dp both Engines
hold the rank's B/dp rows (the draft's too, replicated over tp only), the
round loop's flags are taken over every dp rank (spec.round_flags) and the
streams are gathered at the end, as engine/spec.py does.
"""

from __future__ import annotations

import time

import torch

from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine.backend import Engine
from magicdec_tpu_torch.engine.sampling import argmax_tokens
from magicdec_tpu_torch.engine.spec import (SpecStats, _accept_and_update,
                                            _eot_array, _sync, finish_stats,
                                            round_flags)
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.parallel.collectives import broadcast_tp
from magicdec_tpu_torch.parallel.sharding import shard_tokens


def _draft_step_fn(dconfig, mode: str, budget: int, sink: int):
    """One draft decode step on the draft's own cache (a KVCache in "full"
    mode, else a DraftKVCache), written in place; returns the greedy token
    [B, 1]. target_len [B]: the true position of the first token (SnapKV
    rotates fresh tokens there)."""
    def step(dparams, dcache, tokens, target_len, write_mask=None):
        T = tokens.shape[1]
        if mode == "full":
            impl = impls.target_attn(dconfig, dcache.lengths, T,
                                     write_mask=write_mask)
        elif mode == "snapkv":
            impl = impls.snapkv_draft_attn(dconfig, target_len, dcache.lengths,
                                           T, write_mask=write_mask)
        else:
            impl = impls.streaming_draft_attn(dconfig, dcache.lengths,
                                              dcache.evicted, budget, sink, T,
                                              write_mask=write_mask)
        logits = llama.forward(dparams, dconfig, tokens, impl,
                               (dcache.k, dcache.v), last_only=True)
        dcache.lengths = dcache.lengths + T
        return argmax_tokens(logits)
    return step


@torch.inference_mode()
def longspec_round(tparams, tconfig, dparams, step, tcache: KVCache, dcache,
                   buffer0, last_acc, stale, output, gen_counts, eot,
                   gamma: int, mesh=None):
    """One two-model round. At entry dcache.lengths is the slot of last_acc
    (the newest accepted token). The re-feed writes that slot only when it
    is stale (after a fully accepted round): a prefill-written slot keeps its
    bits (see spec.streaming_round). mesh: the target's tp mesh, whose rank
    0 broadcasts the drafted tokens. Caches and output are written in place;
    returns (bonus, last_acc, stale, gen_counts, info)."""
    lenT0, lenD0 = tcache.lengths, dcache.lengths
    mask0 = torch.stack([stale, torch.ones_like(stale)], dim=1)
    nxt = step(dparams, dcache, torch.cat([last_acc, buffer0], dim=1),
               lenT0 - 1, write_mask=mask0)
    drafted = [nxt]
    tlen = lenT0 + 1
    for _ in range(gamma - 1):
        nxt = step(dparams, dcache, nxt, tlen)
        tlen = tlen + 1
        drafted.append(nxt)
    buffer = broadcast_tp(torch.cat([buffer0] + drafted, dim=1), mesh)

    # target verify: plain decode over the gamma+1 tokens
    impl = impls.target_attn(tconfig, lenT0, gamma + 1)
    logits = llama.forward(tparams, tconfig, buffer, impl,
                           (tcache.k, tcache.v))
    target_tokens = argmax_tokens(logits)

    accept, bonus, gen_counts, terminal, accepted = _accept_and_update(
        buffer, target_tokens, eot, gamma, output, gen_counts)
    tcache.lengths = lenT0 + accept
    # the draft wrote slots lenD0..lenD0+gamma; the newest accepted token
    # sits at lenD0 + accept
    dcache.lengths = lenD0 + accept
    last_acc = torch.gather(buffer, 1, (accept[:, None] - 1).long())
    stale = accept == gamma + 1          # the last drafted token is unwritten
    return bonus, last_acc, stale, gen_counts, dict(
        terminal=terminal, accepted_drafts=accepted, accept_nums=accept)


class LongSpecEngine:
    """Two-model speculative decoding engine.

    target and draft are Engines on one device: the draft Engine carries the
    compression mode (spec=None -> "full"). Its budget cache is built by its
    own encode(), after which the compressed modes free its full prefill
    cache. Under tensor parallelism both Engines take the same mesh (the
    draft typically with replicate_tp=True).
    """

    def __init__(self, target: Engine, draft: Engine):
        if target.batch_size != draft.batch_size:
            raise ValueError(f"batch sizes differ: target {target.batch_size}, "
                             f"draft {draft.batch_size}")
        if target.device != draft.device:
            raise ValueError(f"target on {target.device}, draft on "
                             f"{draft.device}")
        if target.mesh != draft.mesh:
            raise ValueError("target and draft must run on the same mesh")
        self.target = target
        self.draft = draft
        self.mode = draft.spec or "full"

    @torch.inference_mode()
    def generate(self, input_ids, gamma: int, max_new_tokens: int,
                 eot_ids=()) -> tuple[torch.Tensor, torch.Tensor, SpecStats]:
        """Returns (output [B, cap], gen_counts [B], stats), cap =
        max_new_tokens + gamma + 2; rounds run under the condition of
        engine/spec.generate_selfspec, read on the host once per round."""
        dev = self.target.device
        mesh = self.target.mesh
        input_ids = torch.as_tensor(input_ids, dtype=torch.int32, device=dev)
        B = self.target.local_batch
        eot = _eot_array(eot_ids, dev)
        cap = max_new_tokens + gamma + 2
        output = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
        gen_counts = torch.zeros(B, dtype=torch.int32, device=dev)

        buffer0 = self.target.encode(input_ids)
        self.draft.encode(input_ids)
        if self.mode == "full":
            dcache = self.draft.cache
        else:
            dcache = self.draft.draft
            self.draft.drop_cache()      # the full prefill cache is not needed
        # invariant: dcache.lengths is the slot of the last prompt token
        dcache.lengths = dcache.lengths - 1
        last_acc = shard_tokens(input_ids, mesh)[:, -1:]
        stale = torch.zeros(B, dtype=torch.bool, device=dev)
        d = self.draft
        step = _draft_step_fn(d.config, self.mode, d.draft_budget, d.sink_size)
        tcache = self.target.cache

        stats = SpecStats()
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        terminal = torch.zeros((), dtype=torch.bool, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        while True:
            go, _ = round_flags(mesh, terminal, gen_counts, tcache.lengths,
                                max_new_tokens, gamma + 1, tcache.max_len)
            if not go:
                break
            buffer0, last_acc, stale, gen_counts, info = longspec_round(
                self.target.params, self.target.config, d.params, step,
                tcache, dcache, buffer0, last_acc, stale, output, gen_counts,
                eot, gamma, self.target.mesh)
            stats.rounds += 1
            accepted = accepted + info["accepted_drafts"]
            terminal = terminal | info["terminal"]
        idx = torch.clamp(gen_counts, max=cap - 1).long()
        output[torch.arange(B, device=dev), idx] = buffer0[:, 0]
        gen_counts = gen_counts + 1
        _sync(dev)
        stats.wall_time_s = time.perf_counter() - t0
        output, gen_counts = finish_stats(mesh, stats, output[:, :cap],
                                          gen_counts, accepted, gamma)
        return output, gen_counts, stats
