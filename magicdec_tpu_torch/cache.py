"""KV cache state and in-place update functions (port of magicdec_tpu/cache.py).

K/V are stored packed as [L, B, S, Hkv*D] with a [B] int32 length vector,
the JAX package's layout. Where the JAX package returns updated copies (XLA
then aliases them in place), the port writes into the preallocated tensors
directly: appends are index writes into the cache, and rollback only rewinds
the lengths, so slots past a length keep stale but finite data that the
attention masks out.

The StreamingLLM draft cache keeps sink + window slots with `draft_headroom`
spare slots and compacts (gathers the live window down to the sink) once
some sequence's length passes a trigger, as the JAX package does. Where the
JAX package decides to compact on the device (lax.cond), the port's round
loop reads the decision together with the flag it already reads once per
round (compaction_needed), so compaction adds no host read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass
class KVCache:
    """Target cache. k/v: [L, B, S, Hkv*D] (packed); lengths: [B] int32."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def create(n_layer: int, batch: int, max_len: int, n_kv_head: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (n_layer, batch, max_len, n_kv_head * head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       lengths=torch.zeros(batch, dtype=torch.int32,
                                           device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def rollback(self, n) -> None:
        """Rewind lengths by n (int or [B]); data beyond stays as garbage."""
        self.lengths = torch.clamp(self.lengths - n, min=0).to(torch.int32)

    def set_lengths(self, lengths: torch.Tensor) -> None:
        self.lengths = lengths.to(torch.int32)


@dataclass
class DraftKVCache:
    """Draft cache (budget-bounded). k/v: [L, B, Sd, Hkv*D] (packed).

    `lengths` counts physical valid slots; `evicted` counts tokens compacted
    away (StreamingLLM only; always 0 for SnapKV).
    """
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    evicted: torch.Tensor

    @staticmethod
    def create(n_layer: int, batch: int, size: int, n_kv_head: int,
               head_dim: int, dtype=torch.bfloat16,
               device=None) -> "DraftKVCache":
        shape = (n_layer, batch, size, n_kv_head * head_dim)
        zero = torch.zeros(batch, dtype=torch.int32, device=device)
        return DraftKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device),
                            lengths=zero, evicted=zero.clone())

    @property
    def size(self) -> int:
        return self.k.shape[2]

    def rollback(self, n) -> None:
        self.lengths = torch.clamp(self.lengths - n, min=0).to(torch.int32)


class AppendSlots(NamedTuple):
    """Where one append writes: rows [B, T] of (b_idx, s_idx), and which of
    them keep their new value (the rest write back what they hold)."""
    b_idx: torch.Tensor
    s_idx: torch.Tensor
    keep: torch.Tensor


def append_slots(lengths: torch.Tensor, T: int, S: int,
                 write_mask: torch.Tensor | None = None) -> AppendSlots:
    """The slots of appending T rows at lengths [B] to a cache of S slots.

    Rows whose slot is >= S are dropped, and so are rows whose write_mask
    [B, T] entry is False: their slot keeps its contents (the JAX package's
    mode="drop" scatter). Without a host sync: a dropped row writes back the
    value it gathered, at its own slot when that is in range, else at slot
    min(lengths[b], S) - T + t. That slot lies below every slot this append
    keeps and is >= 0 (an out-of-range row has t >= S - lengths[b]), so no
    two rows of one sequence ever target the same slot.
    """
    assert S >= T, (S, T)
    B = lengths.shape[0]
    dev = lengths.device
    t = torch.arange(T, device=dev)
    s_idx = lengths.long()[:, None] + t[None, :]
    oob = s_idx >= S
    keep = ~oob if write_mask is None else (~oob & write_mask)
    base = torch.clamp(lengths.long(), max=S)[:, None]
    s_idx = torch.where(oob, base - T + t[None, :], s_idx)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, T)
    return AppendSlots(b_idx, s_idx, keep[..., None])


def write_slots(cache: torch.Tensor, new: torch.Tensor, l: int,
                slots: AppendSlots) -> None:
    """Write new K or V [B, T, H, D] (or packed [B, T, H*D]) into layer l of
    the stacked cache [L, B, S, H*D] at `slots`, in place."""
    B, T = new.shape[:2]
    layer = cache[l]
    old = layer[slots.b_idx, slots.s_idx]
    new = new.reshape(B, T, -1).to(cache.dtype)
    layer[slots.b_idx, slots.s_idx] = torch.where(slots.keep, new, old)


def append_at_layer(cache: torch.Tensor, new: torch.Tensor,
                    lengths: torch.Tensor, l: int,
                    write_mask: torch.Tensor | None = None) -> None:
    """Write new K or V [B, T, ...] into the stacked cache [L, B, S, H*D] at
    (l, b, lengths[b] + t), in place, with the drop semantics of
    append_slots."""
    write_slots(cache, new, l,
                append_slots(lengths, new.shape[1], cache.shape[2], write_mask))


def append_layer_kv(cache_k_l: torch.Tensor, cache_v_l: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    lengths: torch.Tensor) -> None:
    """Write k_new / v_new [B, T, H, D] (or packed [B, T, H*D]) at the
    per-sequence offsets lengths [B] into one flat cache layer [B, S, H*D]
    each (the GliDe block's own cache), in place. Callers guarantee
    lengths + T <= S; a row past the end is dropped (append_slots), never
    clamped onto a live slot."""
    slots = append_slots(lengths, k_new.shape[1], cache_k_l.shape[1])
    write_slots(cache_k_l.unsqueeze(0), k_new, 0, slots)
    write_slots(cache_v_l.unsqueeze(0), v_new, 0, slots)


def append_at_layer_uniform(cache: torch.Tensor, new: torch.Tensor,
                            start: int, l: int) -> None:
    """append_at_layer for the uniform case (every sequence writes at the same
    offset, as chunked prefill does): one slice copy, in place."""
    B, T = new.shape[:2]
    assert 0 <= start and start + T <= cache.shape[2], (start, T)
    cache[l, :, start:start + T] = new.reshape(B, T, -1).to(cache.dtype)


# ---------------------------------------------------------------------------
# StreamingLLM sink+window bookkeeping
# ---------------------------------------------------------------------------

def window_start(lengths: torch.Tensor, budget: int, sink: int) -> torch.Tensor:
    """First live window slot of each sequence: max(sink, lengths - (budget -
    sink)), so at most `budget` slots (sink + window) are ever attended."""
    return torch.clamp(lengths - (budget - sink), min=sink)


def streaming_positions(lengths: torch.Tensor, size: int, budget: int,
                        sink: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Remapped rope positions and validity for a sink+window draft cache.

    Slot s of sequence b (with lengths[b] physical entries) is a sink slot
    (s < sink: position s, valid), a window slot (start <= s < lengths:
    position sink + s - start) or invalid (evicted but not yet compacted, or
    empty); start = window_start(lengths, budget, sink).
    Returns (positions [B, size] int32, valid [B, size] bool)."""
    slot = torch.arange(size, dtype=torch.int32, device=lengths.device)[None, :]
    lens = lengths.to(torch.int32)[:, None]
    start = window_start(lens, budget, sink)
    in_sink = slot < torch.clamp(lens, max=sink)
    in_window = (slot >= start) & (slot < lens)
    positions = torch.where(slot < sink, slot, sink + slot - start)
    valid = in_sink | in_window
    return torch.where(valid, positions, 0).to(torch.int32), valid


def compaction_needed(draft: DraftKVCache, slack_trigger: int) -> torch.Tensor:
    """0-d bool on the draft's device: some sequence's length is past the
    trigger, so streaming_compact would gather."""
    return (draft.lengths > slack_trigger).any()


def streaming_compact(draft: DraftKVCache, budget: int, sink: int,
                      slack_trigger: int, need: bool | None = None) -> None:
    """Amortised window compaction: gather sink + live window to the front
    when some sequence's length exceeds `slack_trigger`.

    Slot s takes slot s if s < sink, else start + s - sink; the gather goes
    into new tensors (source and destination ranges overlap, so an in-place
    parallel copy would race). lengths become min(lengths, budget) and
    `evicted` grows by what was dropped, so slot s >= sink keeps holding
    true position evicted + s. `need`: the caller's host copy of
    compaction_needed (the round loop reads it with its own flag); None
    reads it here."""
    if need is None:
        need = bool(compaction_needed(draft, slack_trigger))
    if not need:
        return
    size = draft.size
    dev = draft.lengths.device
    slot = torch.arange(size, dtype=torch.int32, device=dev)[None, :]
    lens = draft.lengths.to(torch.int32)[:, None]
    start = window_start(lens, budget, sink)
    src = torch.where(slot < sink, slot, start + slot - sink).clamp(0, size - 1)
    b_idx = torch.arange(src.shape[0], device=dev)[:, None]
    draft.k = draft.k[:, b_idx, src.long()]
    draft.v = draft.v[:, b_idx, src.long()]
    new_len = torch.clamp(draft.lengths, max=budget)
    draft.evicted = (draft.evicted + draft.lengths - new_len).to(torch.int32)
    draft.lengths = new_len.to(torch.int32)
