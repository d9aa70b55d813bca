"""The round-buffer draft machinery shared by the retrieval drafts (port of
the round-buffer part of magicdec_tpu/engine/retro.py; the Quest draft uses
it now, RetroInfer and SqueezedAttention will).

Layout: one stacked draft buffer [L, B, R = NS + Wcap, Hkv*D] per
generation. Columns [0, NS) hold the round's gathered working set (pages or
clusters), refreshed by the round-opening draft step, with pad and dedup
holes expressed by a colmask [L, B, 1, R] int32. Columns [NS, R) hold a
rolling tail window of the newest rows: draft steps append their K/V
there, the verify dual-writes it (and the target cache), rollback rewinds
tail_len, and an amortised compaction shifts the window left. Every draft
step attends [top region | causal tail] through flash_decode_stacked_masked.

As elsewhere in the port, the buffers are written in place.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine.attention_impls import (_flat, _positions,
                                                       _Rotary, _Slots)
from magicdec_tpu_torch.engine.sampling import argmax_tokens
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops.flash_decode import flash_decode_stacked_masked


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


class _TailRows:
    """Row bounds of one draft step (one token) over the round buffer: it
    attends the top region's set bits and tail columns [NS, NS +
    tail_len_before + 1)."""

    def __init__(self, tail_len_before: torch.Tensor, NS: int):
        self.hi = NS + 1 + tail_len_before.to(torch.int32)[:, None]
        self.ns = torch.full_like(self.hi, NS)

    def attend(self, q, bufk, bufv, colmask, l):
        return flash_decode_stacked_masked(q, bufk, bufv, l, colmask, self.ns,
                                           self.ns, self.hi)


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
    rows = _TailRows(tail_len_before, NS)

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
    rows = _TailRows(tail_len_before, NS)

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
