"""Attention implementations plugged into the model's layer loop (port of
the main-path factories of magicdec_tpu/engine/attention_impls.py).

Each factory takes the step's metadata (positions, lengths; the same for
every layer), computes the rope tables and row bounds once, and returns an
`attn_impl(q, k, v, caches, l)` for models/llama.py: `caches` are the full
stacked [L, B, S, Hkv*D] tensors, written in place at layer l, and reads go
through the port's kernels (ops/flash_decode.py) straight out of the stacked
cache. Small query blocks (T*G <= 64) take the decode kernel, prefill chunks
the prefill kernel, and the StreamingLLM draft the two-interval decode
kernel; on the CPU each runs its plain version.

Tensor parallelism: under a tp mesh (config.mesh, the rank's local config)
q holds the rank's Hq/tp heads and the caches its (Hkv/tp)*D columns, whole
KV heads, and the kernels run through their per-shard forms (_flash_stacked,
flash_stacked_lse, _flash_prefill_dispatch, _flash_intervals: the JAX
package's shard_map wrappers, with its names). Attention is per KV head, so
a shard needs no collective; each form launches the same kernel on the
rank's shard (sharding.local_config checks the partition once). Off-mesh
each is the plain kernel.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch import cache as cache_lib
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops import snapkv as snapkv_ops
from magicdec_tpu_torch.ops.attention import decode_valid_upto
from magicdec_tpu_torch.ops.flash_decode import (flash_decode_intervals,
                                                 flash_decode_stacked,
                                                 flash_prefill)
from magicdec_tpu_torch.ops.rope import apply_rope, rope_cos_sin

# the decode kernel holds a KV head's T*G query rows in one CTA
FLASH_MAX_TG = 64


def _counted(form, mesh, q, out):
    """Count a launch on the card of a per-shard form on a tp shard (a mesh
    of tp > 1); returns out."""
    if mesh is not None and mesh.tp > 1 and q.is_cuda:
        form.launches += 1
    return out


def _flash_stacked(q, ck, cv, l: int, valid, mesh=None,
                   s_cap: int | None = None):
    """flash_decode_stacked on the rank's head shard (q [B, T, Hq/tp, D],
    caches [L, B, S, (Hkv/tp)*D]). Replaces the shard_map wrapper
    _flash_stacked (magicdec_tpu/engine/attention_impls.py:62)."""
    return _counted(_flash_stacked, mesh, q,
                    flash_decode_stacked(q, ck, cv, l, valid, s_cap=s_cap))


def _flash_prefill_dispatch(q, ck, cv, l: int, valid, mesh=None,
                            s_cap: int | None = None):
    """flash_prefill on the rank's head shard (as _flash_stacked's).
    Replaces the shard_map wrapper _flash_prefill_dispatch
    (magicdec_tpu/engine/attention_impls.py:99)."""
    return _counted(_flash_prefill_dispatch, mesh, q,
                    flash_prefill(q, ck, cv, l, valid, s_cap=s_cap))


def _flash_intervals(q, k, v, sink_end, lo, hi, mesh=None, k_sink=None):
    """flash_decode_intervals on the rank's head shard (flat k/v [B, S,
    (Hkv/tp)*D]). Replaces the shard_map wrapper _flash_intervals
    (magicdec_tpu/engine/attention_impls.py:117)."""
    return _counted(_flash_intervals, mesh, q, flash_decode_intervals(
        q, k, v, sink_end, lo, hi, k_sink=k_sink))


for _form in (_flash_stacked, _flash_prefill_dispatch, _flash_intervals):
    _form.launches = 0


def _attend_stacked(config: ModelArgs, q, ck, cv, l: int, valid,
                    cap: int | None = None) -> torch.Tensor:
    """Ragged prefix attention against stacked caches, kernel-dispatched.
    `cap` bounds the attended slots (chunked prefill's power-of-2 bucket)."""
    T = q.shape[1]
    if T * (config.n_head // config.n_kv_head) <= FLASH_MAX_TG:
        return _flash_stacked(q, ck, cv, l, valid, config.mesh, s_cap=cap)
    return _flash_prefill_dispatch(q, ck, cv, l, valid, config.mesh,
                                   s_cap=cap)


def flash_stacked_lse(q, ck, cv, l: int, valid, s_cap: int | None = None, *,
                      mesh=None):
    """flash_decode_stacked with the online-softmax state (m, l) returned,
    for a merge with another partial attention (ops/attention.merge_lse):
    the GliDe tree verify's prefix part. The decode kernel holds at most
    FLASH_MAX_TG rows per KV head, so larger query blocks (tree (4,2,2): 29
    nodes x G=4) run as chunks of FLASH_MAX_TG // G rows, one launch each;
    rows are independent, so the chunks give the bits of one launch. On a
    tp shard (mesh as _flash_stacked's) each launch counts on this form;
    it replaces the shard_map wrapper flash_stacked_lse
    (magicdec_tpu/engine/attention_impls.py:81)."""
    T = q.shape[1]
    G = q.shape[2] // (ck.shape[-1] // q.shape[-1])
    step = max(FLASH_MAX_TG // G, 1)
    parts = [_counted(flash_stacked_lse, mesh, q, flash_decode_stacked(
        q[:, i:i + step].contiguous(), ck, cv, l,
        valid[:, i:i + step].contiguous(), s_cap=s_cap, return_lse=True))
        for i in range(0, T, step)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


flash_stacked_lse.launches = 0


def _flat(ctx: torch.Tensor) -> torch.Tensor:
    B, T, H, D = ctx.shape
    return ctx.reshape(B, T, H * D)


def _positions(lengths_before: torch.Tensor, T: int) -> torch.Tensor:
    t = torch.arange(T, dtype=torch.int32, device=lengths_before.device)
    return lengths_before.to(torch.int32)[:, None] + t[None, :]


class _Slots:
    """The append slots of one step (cache.append_slots), computed once per
    cache size and shared by every layer's K and V writes."""

    def __init__(self, lengths: torch.Tensor, T: int, write_mask=None):
        self.lengths, self.T, self.write_mask = lengths, T, write_mask
        self._by_size: dict[int, cache_lib.AppendSlots] = {}

    def write(self, cache: torch.Tensor, new: torch.Tensor, l: int) -> None:
        S = cache.shape[2]
        if S not in self._by_size:
            self._by_size[S] = cache_lib.append_slots(self.lengths, self.T, S,
                                                      self.write_mask)
        cache_lib.write_slots(cache, new, l, self._by_size[S])


class _Rotary:
    """Rope tables for one step's positions, shared by every layer."""

    def __init__(self, config: ModelArgs, positions: torch.Tensor):
        self.cos, self.sin = rope_cos_sin(config, positions)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return apply_rope(x, self.cos, self.sin)


def _target_step_meta(config, lengths_before, T, uniform_start):
    """(rotary, valid [B, T] int32) of a target-cache step."""
    B = lengths_before.shape[0]
    if uniform_start is not None:
        positions = (uniform_start + torch.arange(
            T, dtype=torch.int32, device=lengths_before.device))[None, :]
        valid = (positions + 1).expand(B, T).contiguous()
    else:
        positions = _positions(lengths_before, T)
        valid = decode_valid_upto(lengths_before, T)
    return _Rotary(config, positions), valid


def _append_target(ck, cv, k, v, l, uniform_start, slots):
    if uniform_start is not None:
        cache_lib.append_at_layer_uniform(ck, k, uniform_start, l)
        cache_lib.append_at_layer_uniform(cv, v, uniform_start, l)
    else:
        slots.write(ck, k, l)
        slots.write(cv, v, l)


def target_attn(config: ModelArgs, lengths_before: torch.Tensor, T: int,
                cap: int | None = None, write_mask=None,
                uniform_start: int | None = None):
    """Decode/verify/prefill against the target cache; caches = (ck, cv).

    Queries sit at absolute positions lengths_before + t; K is rotated before
    it is appended. `cap` bounds the attended slots (lengths_before + T <=
    cap). `uniform_start` (int): every sequence writes at this offset
    (chunked prefill) — one slice write and [1, T] rope tables.
    """
    rot, valid = _target_step_meta(config, lengths_before, T, uniform_start)
    slots = _Slots(lengths_before, T, write_mask)

    def impl(q, k, v, caches, l):
        ck, cv = caches
        q, k = rot(q), rot(k)
        _append_target(ck, cv, k, v, l, uniform_start, slots)
        return _flat(_attend_stacked(config, q, ck, cv, l, valid, cap=cap))

    return impl


def verify_dual_attn(config: ModelArgs, lengths_before: torch.Tensor,
                     draft_lengths_before: torch.Tensor, T: int):
    """SnapKV verify: target attention that also appends the rotated k/v into
    the draft cache at its round-start offset, keeping the compressed cache
    in sync; acceptance then rewinds lengths only. caches = (ck, cv, dk, dv).
    """
    rot = _Rotary(config, _positions(lengths_before, T))
    valid = decode_valid_upto(lengths_before, T)
    target_slots = _Slots(lengths_before, T)
    draft_slots = _Slots(draft_lengths_before, T)

    def impl(q, k, v, caches, l):
        ck, cv, dk, dv = caches
        q, k = rot(q), rot(k)
        target_slots.write(ck, k, l)
        target_slots.write(cv, v, l)
        draft_slots.write(dk, k, l)
        draft_slots.write(dv, v, l)
        return _flat(_attend_stacked(config, q, ck, cv, l, valid))

    return impl


def snapkv_draft_attn(config: ModelArgs, target_positions_base: torch.Tensor,
                      draft_lengths_before: torch.Tensor, T: int,
                      write_mask=None):
    """Draft decode against a SnapKV-compressed cache: keys are rotated at
    their original positions, so queries rotate at the true context position
    (target length + offset) while the mask runs in draft-slot coordinates.
    caches = (dk, dv)."""
    rot = _Rotary(config, _positions(target_positions_base, T))
    valid = decode_valid_upto(draft_lengths_before, T)
    slots = _Slots(draft_lengths_before, T, write_mask)

    def impl(q, k, v, caches, l):
        dk, dv = caches
        q, k = rot(q), rot(k)
        slots.write(dk, k, l)
        slots.write(dv, v, l)
        return _flat(_attend_stacked(config, q, dk, dv, l, valid))

    return impl


def streaming_draft_attn(config: ModelArgs, draft_lengths_before: torch.Tensor,
                         evicted: torch.Tensor, budget: int, sink: int, T: int,
                         write_mask=None):
    """Draft decode against a StreamingLLM sink+window cache; caches =
    (dk, dv) of [L, B, size >= budget + slack, Hkv*D].

    K is stored rotated at its true position (evicted + slot; sink slots at
    their slot), bit-identical to what the target cache holds, and queries
    rotate at their true position too. Rope attention depends only on
    relative positions, and the StreamingLLM remap (sink at 0..sink-1, the
    live window contiguous after it) shifts queries and window keys by the
    same delta = sink - start - evicted, so only the sink keys need a twist:
    they are read rotated by -delta. With nothing evicted delta = 0, the
    twist is the identity and the draft reads what the target reads.

    Each layer rotates its sink rows [B, sink, Hkv*D] apart and the
    two-interval kernel reads slots < sink from them, so the cache layer is
    never copied. Query (b, t) attends to [0, min(sink, q_slot + 1)) u
    [start, q_slot + 1), q_slot = draft_lengths_before + t: the sink and
    the live window, causal up to its own slot.
    """
    B = draft_lengths_before.shape[0]
    Hkv, D = config.n_kv_head, config.head_dim
    q_slot = _positions(draft_lengths_before, T)                     # [B, T]
    rot = _Rotary(config, evicted.to(torch.int32)[:, None] + q_slot)
    slots = _Slots(draft_lengths_before, T, write_mask)
    start = cache_lib.window_start(draft_lengths_before.to(torch.int32) + T,
                                   budget, sink)                     # [B]
    delta = sink - start - evicted.to(torch.int32)                   # <= 0
    cos, sin = rope_cos_sin(config, -delta[:, None])                 # [B, 1, D]
    hi = q_slot + 1
    sink_end = torch.clamp(hi, max=sink)
    lo = start[:, None].expand(B, T).contiguous()

    def impl(q, k, v, caches, l):
        dk, dv = caches
        q, k = rot(q), rot(k)
        slots.write(dk, k, l)
        slots.write(dv, v, l)
        k_sink = apply_rope(dk[l, :, :sink].reshape(B, sink, Hkv, D), cos, sin)
        ctx = _flash_intervals(q, dk[l], dv[l], sink_end, lo, hi,
                               config.mesh,
                               k_sink=k_sink.reshape(B, sink, Hkv * D))
        return _flat(ctx)

    return impl


def prefill_snapkv_attn(config: ModelArgs, lengths_before: torch.Tensor,
                        T: int, context_len: int, budget: int, window: int,
                        cap: int | None = None,
                        uniform_start: int | None = None):
    """Last prefill chunk: target prefill attention plus the SnapKV
    draft-cache build, writing the first `budget` slots of dk/dv.
    caches = (ck, cv, dk, dv)."""
    rot, valid = _target_step_meta(config, lengths_before, T, uniform_start)
    slots = _Slots(lengths_before, T)
    Hkv, D = config.n_kv_head, config.head_dim

    def impl(q, k, v, caches, l):
        ck, cv, dk, dv = caches
        q, k = rot(q), rot(k)
        _append_target(ck, cv, k, v, l, uniform_start, slots)
        # the same kernel path as the plain prefill chunks: every engine must
        # build bit-identical prefill states
        ctx = _attend_stacked(config, q, ck, cv, l, valid, cap=cap)
        k_l, v_l = ck[l], cv[l]
        if cap is not None and cap < k_l.shape[1]:
            k_l, v_l = k_l[:, :cap], v_l[:, :cap]
        B, S = k_l.shape[:2]
        cku, cvu = k_l.reshape(B, S, Hkv, D), v_l.reshape(B, S, Hkv, D)
        scores = snapkv_ops.snapkv_scores(q, cku, context_len, window)
        sel_k, sel_v = snapkv_ops.snapkv_select(scores, cku, cvu, context_len,
                                                budget, window)
        dk[l, :, :budget] = sel_k.reshape(B, budget, -1)
        dv[l, :, :budget] = sel_v.reshape(B, budget, -1)
        return _flat(ctx)

    return impl
