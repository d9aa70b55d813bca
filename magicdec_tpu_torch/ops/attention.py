"""Dense ragged attention: the plain path and the numerical oracle (port of
magicdec_tpu/ops/attention.py).

The cache is a fixed-shape [B, S, Hkv, D] buffer and raggedness is a
per-query count of valid slots, so rollback is a length rewind and stale
tail slots are masked out. New K/V are appended before attention, so the
t-th query of sequence b attends to slots [0, len_before[b] + t].

Numerics follow the JAX oracle: logits and softmax in float32 from operands
in their storage dtype (exact bf16 products), probabilities rounded to V's
dtype before the P@V product, which accumulates in float32.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def _attend_masked(q, k, v, mask):
    """q [B,T,Hq,D], k/v [B,S,Hkv,D], mask [B,T,S] bool -> [B,T,Hq,D]."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D).float()
    logits = torch.einsum("bthgd,bshd->bthgs", qg, k.float()) * (D ** -0.5)
    logits = logits.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bthgs,bshd->bthgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_upto: torch.Tensor) -> torch.Tensor:
    """GQA attention over a fixed-shape cache with per-query slot bounds.

    q [B, T, Hq, D] (rotated); k, v [B, S, Hkv, D] including the freshly
    appended tokens; valid_upto [B, T] int — query (b, t) attends to slots
    < valid_upto[b, t]. Returns [B, T, Hq, D] in q's dtype.
    """
    S = k.shape[1]
    slot = torch.arange(S, device=k.device)
    mask = slot[None, None, :] < valid_upto[:, :, None]
    return _attend_masked(q, k, v, mask)


def masked_attention_general(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: torch.Tensor
                             ) -> torch.Tensor:
    """As masked_attention but with an explicit [B, T, S] bool mask (for
    valid sets that are not a slot prefix, such as sink + window)."""
    return _attend_masked(q, k, v, mask)


def decode_valid_upto(lengths_before: torch.Tensor, T: int,
                      cap: int | None = None) -> torch.Tensor:
    """valid_upto [B, T] int32 for T tokens appended after lengths_before [B]
    (causal)."""
    t = torch.arange(T, dtype=torch.int32, device=lengths_before.device)
    upto = lengths_before.to(torch.int32)[:, None] + t[None, :] + 1
    if cap is not None:
        upto = torch.clamp(upto, max=cap)
    return upto
