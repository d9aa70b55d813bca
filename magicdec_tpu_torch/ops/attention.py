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


def masked_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor):
    """As masked_attention_general, also returning the online-softmax state
    (m = row max of the scaled logits, l = sum exp(s - m)), so a caller can
    merge this attention with another over a disjoint slot set (merge_lse):
    the GliDe tree verify and tree draft attend [flash kernel over the
    prefix | this dense block over the tree slots].

    Returns (ctx [B, T, Hq, D] in q's dtype, m [B, T, Hq] f32, l [B, T, Hq]
    f32). A row with an empty mask gives m = NEG_INF, l = 0 and ctx = 0
    (finite, so a merge weight of 0 gives 0, not NaN)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D).float()
    logits = torch.einsum("bthgd,bshd->bthgs", qg, k.float()) * (D ** -0.5)
    valid = mask[:, :, None, None, :]
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bthgs,bshd->bthgd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l[..., None], min=1e-30)
    return (out.reshape(B, T, Hq, D).to(q.dtype), m.reshape(B, T, Hq),
            l.reshape(B, T, Hq))


def merge_lse(ctx_a, m_a, l_a, ctx_b, m_b, l_b) -> torch.Tensor:
    """Combine two partial softmax attentions over disjoint slot sets:
    ctx_* [B, T, Hq, D] (normalized), m_* / l_* [B, T, Hq] f32. Returns
    ctx_a's dtype."""
    m = torch.maximum(m_a, m_b)
    w_a = l_a * torch.exp(m_a - m)
    w_b = l_b * torch.exp(m_b - m)
    tot = torch.clamp(w_a + w_b, min=1e-30)
    out = (ctx_a.float() * w_a[..., None]
           + ctx_b.float() * w_b[..., None]) / tot[..., None]
    return out.to(ctx_a.dtype)


def decode_valid_upto(lengths_before: torch.Tensor, T: int,
                      cap: int | None = None) -> torch.Tensor:
    """valid_upto [B, T] int32 for T tokens appended after lengths_before [B]
    (causal)."""
    t = torch.arange(T, dtype=torch.int32, device=lengths_before.device)
    upto = lengths_before.to(torch.int32)[:, None] + t[None, :] + 1
    if cap is not None:
        upto = torch.clamp(upto, max=cap)
    return upto
