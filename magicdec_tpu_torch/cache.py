"""KV cache state and in-place update functions (port of magicdec_tpu/cache.py).

K/V are stored packed as [L, B, S, Hkv*D] with a [B] int32 length vector,
the JAX package's layout. Where the JAX package returns updated copies (XLA
then aliases them in place), the port writes into the preallocated tensors
directly: appends are index writes into the cache, and rollback only rewinds
the lengths, so slots past a length keep stale but finite data that the
attention masks out.
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


def append_at_layer_uniform(cache: torch.Tensor, new: torch.Tensor,
                            start: int, l: int) -> None:
    """append_at_layer for the uniform case (every sequence writes at the same
    offset, as chunked prefill does): one slice copy, in place."""
    B, T = new.shape[:2]
    assert 0 <= start and start + T <= cache.shape[2], (start, T)
    cache[l, :, start:start + T] = new.reshape(B, T, -1).to(cache.dtype)
