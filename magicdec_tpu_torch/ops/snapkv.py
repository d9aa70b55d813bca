"""SnapKV observation-window scoring and top-k KV selection (port of
magicdec_tpu/ops/snapkv.py).

The last prefill chunk's queries score every past key; softmax weights are
summed over the observation queries and each GQA group, avg-pooled along the
key axis (kernel 5), and the top-(budget - window) keys are selected per KV
head; the last `window` keys are always kept. Keys are streamed in chunks
with a two-pass online log-sum-exp, so peak memory is O(B*Hq*obs*chunk).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = float(torch.finfo(torch.float32).min)


def snapkv_scores(q_obs: torch.Tensor, k_all: torch.Tensor, context_len: int,
                  window: int, key_chunk: int = 1024) -> torch.Tensor:
    """Pooled, group-summed attention mass per key.

    q_obs [B, Tobs, Hq, D]: rotated queries of the last prefill chunk, at
    absolute positions context_len - Tobs + t. k_all [B, S, Hkv, D]: rotated
    keys (one target cache layer); slots >= context_len are masked.
    Returns scores [B, Hkv, S] float32, NEG_INF at keys that may not be
    selected (>= context_len - window).
    """
    B, Tobs, Hq, D = q_obs.shape
    S, Hkv = k_all.shape[1], k_all.shape[2]
    G = Hq // Hkv
    key_chunk = min(key_chunk, S)
    n_chunks = -(-S // key_chunk)
    dev = q_obs.device

    qf = (q_obs.float() * (D ** -0.5)).reshape(B, Tobs, Hkv, G, D)
    q_pos = context_len - Tobs + torch.arange(Tobs, device=dev)

    def chunk_logits(c):
        # [B, Tobs, Hkv, G, n] over keys [c*key_chunk, c*key_chunk + n);
        # a short last chunk equals the JAX zero-padded one: padded keys sit
        # past every query position and are causally masked
        kc = k_all[:, c * key_chunk:(c + 1) * key_chunk].float()
        logits = torch.einsum("bthgd,bshd->bthgs", qf, kc)
        j = c * key_chunk + torch.arange(kc.shape[1], device=dev)
        causal = j[None, :] <= q_pos[:, None]
        return logits.masked_fill(~causal[None, :, None, None, :], NEG_INF)

    # pass 1: online log-sum-exp per query over all causal keys
    m = torch.full((B, Tobs, Hkv, G), NEG_INF, device=dev)
    l = torch.zeros((B, Tobs, Hkv, G), device=dev)
    for c in range(n_chunks):
        logits = chunk_logits(c)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log(l)

    # pass 2: softmax probabilities summed over the queries and the group
    scores = torch.cat([torch.exp(chunk_logits(c) - lse[..., None]).sum(
        dim=(1, 3)) for c in range(n_chunks)], dim=-1)       # [B, Hkv, S]

    # avg-pool kernel 5, stride 1, zero "same" padding (count_include_pad)
    ksize, pad = 5, 2
    padded = F.pad(scores, (pad, pad))
    pooled = sum(padded[:, :, i:i + S] for i in range(ksize)) / ksize

    eligible = torch.arange(S, device=dev) < (context_len - window)
    return pooled.masked_fill(~eligible[None, None, :], NEG_INF)


def snapkv_select(scores: torch.Tensor, k_cache_l: torch.Tensor,
                  v_cache_l: torch.Tensor, context_len: int, budget: int,
                  window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gather building one layer of the draft cache.

    Returns (dk, dv) [B, budget, Hkv, D]: per-KV-head top-(budget - window)
    keys, re-sorted into slot order (at full budget the draft cache is then
    an exact copy of the target prefix, which the acceptance-1.0 invariant
    needs), followed by the last `window` keys in order.
    """
    topk = budget - window
    idx = torch.topk(scores, topk, dim=-1).indices              # [B, Hkv, k]
    idx = torch.sort(idx, dim=-1).values
    idx = idx.transpose(1, 2)[..., None].expand(-1, -1, -1, k_cache_l.shape[-1])
    dk_sel = torch.gather(k_cache_l, 1, idx)                    # [B, k, Hkv, D]
    dv_sel = torch.gather(v_cache_l, 1, idx)
    tail = slice(context_len - window, context_len)
    dk = torch.cat([dk_sel, k_cache_l[:, tail]], dim=1)
    dv = torch.cat([dv_sel, v_cache_l[:, tail]], dim=1)
    return dk, dv
