"""Speculative decoding control loops (port of the baseline and
self-speculation parts of magicdec_tpu/engine/spec.py: SnapKV,
StreamingLLM, Quest, RetroInfer and SqueezedAttention).

A round is gamma draft steps on the budget cache, one verify of gamma+1
tokens (SnapKV's also writes the draft cache), vectorized cumprod
acceptance, a length-only rollback, the output scatter and the bonus pick,
all on the device. Where the JAX package runs the rounds inside one
lax.while_loop, the port runs a Python loop over rounds with one host read
per round (of the flag that ends the loop, and for StreamingLLM and the
round-buffer drafts of whether to compact first), as the JAX package's
fused=False loop does.

Under dp (an Engine on a dp x tp mesh) each rank runs its B/dp rows. The
loop's flags are the JAX package's whole-batch reductions, so they are
taken over every dp rank before the host reads them (round_flags: one
all-reduce of four ints a round), every rank runs the same rounds, and the
output rows of the dp blocks are gathered at the end: every rank returns
the whole batch's stream and stats.

Spans (utils/profiling.span, recorded only while the recorder is on): a
`job` around each generate_* call; in generate_selfspec a `round` per round,
ending in its `round_flags` read (the first read, before any round, sits in
the job), and in snapkv_round gamma `draft.step`, a `verify` and an `accept`,
each step with `step_setup` (the attention impl: positions, rope tables)
and `forward` (llama.forward and the argmax); in generate_autoregressive a
`step` per step with `step_setup`, `forward` and `update`.

Acceptance semantics (as in the JAX package):
  * a drafted token equal to the target argmax and not EOS is accepted;
  * accept = 1 + length of the accepted cumprod prefix (the +1 emits the
    round's input token, the previous round's bonus);
  * emitted tokens are the buffer tokens [0..accept), the bonus
    target_tokens[accept-1] seeds the next round;
  * rollback rewinds cache lengths only.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import torch

from magicdec_tpu_torch import cache as cache_lib
from magicdec_tpu_torch.cache import DraftKVCache, KVCache
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine import quest as quest_lib
from magicdec_tpu_torch.engine import retro as retro_lib
from magicdec_tpu_torch.engine import squeeze as squeeze_lib
from magicdec_tpu_torch.engine.backend import Engine
from magicdec_tpu_torch.engine.sampling import argmax_tokens, sample
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.parallel.collectives import (all_gather_dp,
                                                     all_reduce_dp)
from magicdec_tpu_torch.parallel.sharding import shard_tokens
from magicdec_tpu_torch.utils.profiling import span


def _is_eot(tokens: torch.Tensor, eot: torch.Tensor) -> torch.Tensor:
    return (tokens == eot[0]) | (tokens == eot[1])


def _eot_array(eot_ids, device=None) -> torch.Tensor:
    ids = list(eot_ids)[:2] + [-1, -1]
    return torch.tensor(ids[:2], dtype=torch.int32, device=device)


def _accept_and_update(buffer, target_tokens, eot, gamma: int, output,
                       gen_counts):
    """Vectorized acceptance, output scatter, bonus/terminal computation.

    output [B, O + 1]: column O is a dump column that takes the writes the
    JAX package drops (out-of-range positions of rejected tokens), so the
    scatter needs no host sync. Returns (accept [B], bonus [B, 1], gen_counts,
    terminal (0-d bool), accepted_drafts (0-d int)); output is written in
    place."""
    draft_tokens = buffer[:, 1:]
    flag = (target_tokens[:, :gamma] == draft_tokens) & ~_is_eot(draft_tokens, eot)
    cum = torch.cumprod(flag.to(torch.int32), dim=1)
    accept = 1 + cum.sum(dim=1, dtype=torch.int32)          # [B] in [1, gamma+1]
    bonus = torch.gather(target_tokens, 1, (accept[:, None] - 1).long())

    O = output.shape[1] - 1
    ar = torch.arange(gamma + 1, dtype=torch.int32, device=buffer.device)
    pos = gen_counts[:, None] + ar[None, :]
    keep = ar[None, :] < accept[:, None]
    pos = torch.where(keep, torch.clamp(pos, max=O - 1), O)
    output.scatter_(1, pos.long(), buffer)
    gen_counts = gen_counts + accept

    terminal = ((cum.bool() & _is_eot(draft_tokens, eot)).any()
                | _is_eot(bonus, eot).any())
    return accept, bonus, gen_counts, terminal, cum.sum()


@torch.inference_mode()
def snapkv_round(params, config, cache: KVCache, draft: DraftKVCache,
                 buffer0, output, gen_counts, eot, gamma: int):
    """One SnapKV self-speculation round (the draft shares the target
    weights). Caches and output are written in place; returns
    (bonus [B, 1], gen_counts, info)."""
    lenT0, lenD0 = cache.lengths, draft.lengths
    lens, tok = lenD0, buffer0
    drafted = []
    for i in range(gamma):
        with span("draft.step", i):
            with span("step_setup"):
                impl = impls.snapkv_draft_attn(config, lenT0 + i, lens, 1)
            with span("forward"):
                logits = llama.forward(params, config, tok, impl,
                                       (draft.k, draft.v), last_only=True)
                tok = argmax_tokens(logits)
            lens = lens + 1
            drafted.append(tok)

    # verify: target attention, dual-append at the round-start draft offset
    # (overwriting the spec-written entries with target-quality k/v)
    with span("verify"):
        buffer = torch.cat([buffer0] + drafted, dim=1)      # [B, gamma+1]
        with span("step_setup"):
            impl = impls.verify_dual_attn(config, lenT0, lenD0, gamma + 1)
        with span("forward"):
            logits = llama.forward(params, config, buffer, impl,
                                   (cache.k, cache.v, draft.k, draft.v))
            target_tokens = argmax_tokens(logits)

    with span("accept"):
        accept, bonus, gen_counts, terminal, accepted = _accept_and_update(
            buffer, target_tokens, eot, gamma, output, gen_counts)
        cache.lengths = lenT0 + accept
        draft.lengths = lenD0 + accept
    return bonus, gen_counts, dict(terminal=terminal, accepted_drafts=accepted,
                                   accept_nums=accept)


@torch.inference_mode()
def streaming_round(params, config, cache: KVCache, draft: DraftKVCache,
                    buffer0, last_acc_tok, stale, output, gen_counts, eot,
                    gamma: int, budget: int, sink: int):
    """One StreamingLLM self-speculation round. Caches and output are written
    in place; returns (bonus [B, 1], last_acc [B, 1], stale [B], gen_counts,
    info).

    At entry draft.lengths is the slot of last_acc_tok (the newest accepted
    token), which is re-fed with the round's input, so the first draft step
    always has T=2. stale [B] bool: last_acc_tok's slot was never written
    (only after a fully accepted round: the last drafted token is not
    appended by the draft loop). The re-feed writes that slot only then: K/V
    computed at a prefill chunk's shape differ in low bits from K/V computed
    at a decode step's, and overwriting a prefill-written slot would break
    the full-budget bit-exactness."""
    lenT0, lenD0 = cache.lengths, draft.lengths

    def step(lens, tokens, write_mask=None):
        T = tokens.shape[1]
        impl = impls.streaming_draft_attn(config, lens, draft.evicted, budget,
                                          sink, T, write_mask)
        logits = llama.forward(params, config, tokens, impl,
                               (draft.k, draft.v), last_only=True)
        return lens + T, argmax_tokens(logits)

    mask0 = torch.stack([stale, torch.ones_like(stale)], dim=1)
    lens, nxt = step(lenD0, torch.cat([last_acc_tok, buffer0], dim=1), mask0)
    drafted = [nxt]
    for _ in range(gamma - 1):
        lens, nxt = step(lens, nxt)
        drafted.append(nxt)
    buffer = torch.cat([buffer0] + drafted, dim=1)          # [B, gamma+1]

    # verify: target only (a StreamingLLM verify never writes the draft)
    impl = impls.target_attn(config, lenT0, gamma + 1)
    logits = llama.forward(params, config, buffer, impl, (cache.k, cache.v))
    target_tokens = argmax_tokens(logits)

    accept, bonus, gen_counts, terminal, accepted = _accept_and_update(
        buffer, target_tokens, eot, gamma, output, gen_counts)
    cache.lengths = lenT0 + accept
    # last_acc sat at lenD0 and buffer[j] at lenD0 + 1 + j: the newest
    # accepted token buffer[accept - 1] is at lenD0 + accept
    draft.lengths = lenD0 + accept
    last_acc = torch.gather(buffer, 1, (accept[:, None] - 1).long())
    stale = accept == gamma + 1
    return bonus, last_acc, stale, gen_counts, dict(
        terminal=terminal, accepted_drafts=accepted, accept_nums=accept)


@dataclass
class SpecStats:
    rounds: int = 0
    total_drafted: int = 0
    total_accepted_drafts: int = 0
    generated_tokens: int = 0
    wall_time_s: float = 0.0
    compactions: int = 0        # StreamingLLM / round-buffer tail shifts
    index_build_s: float = 0.0  # RetroInfer/Squeeze index build at encode

    @property
    def acceptance_rate(self) -> float:
        return (self.total_accepted_drafts / self.total_drafted
                if self.total_drafted else 0.0)

    @property
    def avg_accepted_per_round(self) -> float:
        return (self.generated_tokens / self.rounds) if self.rounds else 0.0


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def round_flags(mesh, terminal, gen_counts, lengths, max_new_tokens: int,
                room: int, max_len: int, need=None) -> tuple[bool, bool]:
    """The round loop's condition and compaction flag, read on the host
    once a round: go = no sequence hit EOS (terminal, 0-d bool), some
    sequence has fewer than max_new_tokens tokens, and every cache length
    has room for `room` more within max_len; need = the 0-d bool of some
    sequence's window having to compact first (None: False). Under dp each
    is taken over every dp rank's sequences (one all-reduce of the four
    flags), so every rank runs the same rounds and compactions."""
    if need is None:
        need = torch.zeros_like(terminal)
    flags = torch.stack([terminal, gen_counts.min() < max_new_tokens,
                         lengths.max() + room > max_len,
                         need]).to(torch.int32)
    t, more, full, nd = all_reduce_dp(flags, mesh, "max").tolist()
    return bool(not t and more and not full), bool(nd)


def finish_stats(mesh, stats, output, gen_counts, accepted, drafted_per_row):
    """The whole batch's output [B, ...] and gen_counts [B] (the dp blocks'
    rows gathered in dp order) and stats: total_drafted = rounds x B x
    drafted_per_row, the accepted drafts summed over the dp ranks."""
    output = all_gather_dp(output, mesh)
    gen_counts = all_gather_dp(gen_counts, mesh)
    accepted = all_reduce_dp(accepted.reshape(1).to(torch.int64), mesh)
    stats.total_drafted = stats.rounds * output.shape[0] * drafted_per_row
    stats.total_accepted_drafts = int(accepted)
    stats.generated_tokens = int(gen_counts.sum())
    return output, gen_counts


def _job(generate):
    """Run `generate` (a decode entry) inside one `job` span."""
    @functools.wraps(generate)
    def job(*args, **kwargs):
        with span("job"):
            return generate(*args, **kwargs)
    return job


@_job
@torch.inference_mode()
def generate_autoregressive(engine: Engine, input_ids, max_new_tokens: int,
                            eot_ids=(), temperature: float = 0.0,
                            top_p: float = 1.0,
                            generator: torch.Generator | None = None
                            ) -> tuple[torch.Tensor, SpecStats]:
    """Baseline decode loop: 1-token steps with per-row EOS tracking, as the
    JAX package's fused while_loop. Returns (output [B, max_new_tokens],
    stats). With eot_ids the host reads the alive flags once per step; without
    them no row can stop early and the loop runs without host reads.
    temperature > 0 samples (nucleus top_p) from `generator`. Timing starts
    after prefill."""
    dev = engine.device
    eot = _eot_array(eot_ids, dev)
    tok = engine.encode(input_ids)
    B = tok.shape[0]
    stats = SpecStats()
    output = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    output[:, 0] = tok[:, 0]
    alive = ~_is_eot(tok[:, 0], eot)
    counts = torch.ones(B, dtype=torch.int32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    step = 1
    mesh = engine.mesh
    while step < max_new_tokens and (not eot_ids or bool(all_reduce_dp(
            alive.any().to(torch.int32).reshape(1), mesh, "max"))):
        with span("step", step):
            with span("step_setup"):
                impl = impls.target_attn(engine.config, engine.cache.lengths,
                                         1)
            with span("forward"):
                logits = llama.forward(engine.params, engine.config, tok,
                                       impl, (engine.cache.k, engine.cache.v))
            with span("update"):
                if temperature > 0.0:
                    nxt = sample(logits, generator, temperature, top_p)
                else:
                    nxt = argmax_tokens(logits)
                engine.cache.lengths = (engine.cache.lengths
                                        + alive.to(torch.int32))
                output[:, step] = torch.where(alive, nxt[:, 0], 0)
                counts = counts + alive.to(torch.int32)
                alive = alive & ~_is_eot(nxt[:, 0], eot)
        tok = nxt
        step += 1
    _sync(dev)
    stats.wall_time_s = time.perf_counter() - t0
    output, counts = all_gather_dp(output, mesh), all_gather_dp(counts, mesh)
    stats.generated_tokens = int(counts.sum())
    stats.rounds = int(counts.max())
    return output, stats


@_job
@torch.inference_mode()
def generate_selfspec(engine: Engine, input_ids, gamma: int,
                      max_new_tokens: int, eot_ids=()
                      ) -> tuple[torch.Tensor, torch.Tensor, SpecStats]:
    """Self-speculative generation (SnapKV, StreamingLLM, Quest, RetroInfer
    or SqueezedAttention). Returns (output [B, cap], gen_counts [B], stats)
    with cap = max_new_tokens + gamma + 2. Rounds run while no sequence hit
    EOS, some sequence has fewer than max_new_tokens tokens and the target
    cache has room for gamma + 1 more: the JAX fused loop's condition, read
    on the host once per round. For StreamingLLM and the round-buffer
    drafts that read also says whether to compact the draft window first
    (Quest then refreshes the page boxes that aged out of it; RetroInfer and
    SqueezedAttention on the long-generation path fold the aged rows into
    the cluster index). The round-buffer drafts' nprobe (Retro) and
    max_clusters (Squeeze) are max((budget - latest_k) // retro_cap, 1)."""
    if engine.spec not in ("snapkv", "streaming", "quest", "retro",
                           "squeeze"):
        raise ValueError(f"generate_selfspec needs spec='snapkv', "
                         f"'streaming', 'quest', 'retro' or 'squeeze', not "
                         f"{engine.spec!r}")
    streaming = engine.spec == "streaming"
    dev = engine.device
    mesh = engine.mesh
    input_ids = torch.as_tensor(input_ids, dtype=torch.int32, device=dev)
    local_ids = shard_tokens(input_ids, mesh)
    B = local_ids.shape[0]
    eot = _eot_array(eot_ids, dev)
    cap = max_new_tokens + gamma + 2
    output = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
    gen_counts = torch.zeros(B, dtype=torch.int32, device=dev)

    buffer0 = engine.encode(input_ids)
    if streaming:
        # invariant: draft.lengths is the slot of the newest accepted token
        last_acc = local_ids[:, -1:]
        stale = torch.zeros(B, dtype=torch.bool, device=dev)
        engine.draft.lengths = engine.draft.lengths - 1
    st = None       # the round-buffer drafts' state
    if engine.spec == "quest":
        st = quest_lib.QuestState.create(
            engine.cache, engine.spec_index, engine.draft_budget,
            engine.latest_k, engine.quest_page, gamma)
    elif engine.spec in ("retro", "squeeze"):
        nprobe = max((engine.draft_budget - engine.latest_k)
                     // engine.retro_cap, 1)
        kw = dict(nprobe=nprobe, cap=engine.retro_cap,
                  recent=engine.latest_k, gamma=gamma,
                  max_new_tokens=max_new_tokens)
        if engine.spec == "retro":
            st = retro_lib.RetroState.create(engine.cache, engine.spec_index,
                                             **kw)
        else:
            st = squeeze_lib.SqueezeState.create(
                engine.cache, engine.spec_index,
                threshold=engine.squeeze_threshold, **kw)
    stats = SpecStats(index_build_s=engine.index_build_s)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    terminal = torch.zeros((), dtype=torch.bool, device=dev)
    max_len = engine.cache.max_len
    _sync(dev)
    t0 = time.perf_counter()

    def read_flags(terminal, gen_counts):
        # the host's one read a round: run another round? compact first?
        with span("round_flags"):
            need = None
            if streaming:
                need = cache_lib.compaction_needed(
                    engine.draft, engine.compaction_trigger())
            elif st is not None:
                need = st.compaction_needed()
            return round_flags(mesh, terminal, gen_counts,
                               engine.cache.lengths, max_new_tokens,
                               gamma + 1, max_len, need)

    go, need = read_flags(terminal, gen_counts)
    while go:
        with span("round", stats.rounds):
            if st is not None:
                if need:
                    st.compact(engine.cache, engine.config.mesh)
                    stats.compactions += 1
                buffer0, gen_counts, info = retro_lib.roundtail_round(
                    engine.params, engine.config, engine.cache, st, buffer0,
                    output, gen_counts, eot, gamma)
            elif streaming:
                engine.compact_draft(need)
                stats.compactions += need
                buffer0, last_acc, stale, gen_counts, info = streaming_round(
                    engine.params, engine.config, engine.cache, engine.draft,
                    buffer0, last_acc, stale, output, gen_counts, eot, gamma,
                    engine.draft_budget, engine.sink_size)
            else:
                buffer0, gen_counts, info = snapkv_round(
                    engine.params, engine.config, engine.cache, engine.draft,
                    buffer0, output, gen_counts, eot, gamma)
            stats.rounds += 1
            accepted = accepted + info["accepted_drafts"]
            terminal = terminal | info["terminal"]
            go, need = read_flags(terminal, gen_counts)
    # final bonus token
    idx = torch.clamp(gen_counts, max=cap - 1).long()
    output[torch.arange(B, device=dev), idx] = buffer0[:, 0]
    gen_counts = gen_counts + 1
    _sync(dev)
    stats.wall_time_s = time.perf_counter() - t0
    output, gen_counts = finish_stats(mesh, stats, output[:, :cap],
                                      gen_counts, accepted, gamma)
    return output, gen_counts, stats
