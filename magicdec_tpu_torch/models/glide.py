"""GliDe draft model: a one-layer decoder block with cross-attention into the
target's last-layer KV cache (port of magicdec_tpu/models/glide.py).

The block runs self-attention over its own small KV cache, then
cross-attends to the target model's last-layer keys/values (the target
cache's layer L-1), then an MLP; token embeddings and the unembedding are
shared with the target. The cross-attention reads activations the target
already computed, so the draft adds one layer of compute yet sees the
target's full-context representation.

The params are a flat dict in the JAX package's layout ([in, out] weights,
KV-head-major wqkv, w_gate_up [D, 2, I]), so llama.params_from_numpy carries
JAX glide params across as they are.

Under tensor parallelism (config: the target rank's local config, whose
mesh is set) the block is cut as a target layer (parallel/sharding.
shard_glide_params): the rank runs its heads and its FFN columns, the
row-parallel products (wo, wo_cross, w_down) are all-reduced over the tp
ranks, and the embedding and the head are the target's vocab-parallel ones
(llama.embed, then the rank's vocab columns gathered).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from magicdec_tpu_torch.cache import append_layer_kv
from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.engine.attention_impls import FLASH_MAX_TG
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops import attention as dense
from magicdec_tpu_torch.ops.flash_decode import (flash_decode,
                                                 flash_decode_intervals,
                                                 flash_prefill)
from magicdec_tpu_torch.ops.norms import rms_norm
from magicdec_tpu_torch.ops.rope import rope
from magicdec_tpu_torch.parallel.collectives import (all_gather_tp,
                                                     all_reduce_tp)

Params = dict[str, Any]


def init_glide_params(config: ModelArgs, dtype=torch.float32,
                      scale: float = 0.02, seed: int = 0,
                      device=None) -> Params:
    """Random-normal glide block params from a seeded torch.Generator on
    `device`. config is the target's (the block shares its widths)."""
    device = resolve_device(device)
    D = config.dim
    Dh, Hq, Hkv = config.head_dim, config.n_head, config.n_kv_head
    I = config.intermediate_size
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "self_norm": ones(D),
        "wqkv": rnd(D, (Hq + 2 * Hkv) * Dh),
        "wo": rnd(Hq * Dh, D),
        "cross_norm": ones(D),
        "wq_cross": rnd(D, Hq * Dh),
        "wo_cross": rnd(Hq * Dh, D),
        "ffn_norm": ones(D),
        "w_gate_up": rnd(D, 2, I),
        "w_down": rnd(I, D),
    }


def _tree_slice(flat: torch.Tensor, base: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S, HD] -> the n rows at [base[b], base[b] + n) per sequence
    (callers guarantee base + n <= S)."""
    rows = base.long()[:, None] + torch.arange(n, device=flat.device)[None, :]
    return flat[torch.arange(flat.shape[0], device=flat.device)[:, None], rows]


def _flash_flat(q, k, v, valid):
    """Ragged-causal attention over a flat cache [B, S, Hkv*D] through the
    port's kernels: the decode kernel (flash_decode, the intervals form) for
    T*G <= 64 rows per KV head, the prefill kernel over the cache as a
    one-layer stack for larger blocks."""
    G = q.shape[2] // (k.shape[-1] // q.shape[-1])
    if q.shape[1] * G <= FLASH_MAX_TG:
        return flash_decode(q, k, v, valid)
    return flash_prefill(q, k.unsqueeze(0), v.unsqueeze(0), 0, valid)


def glide_forward(glide: Params, target_params: Params, config: ModelArgs,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  own_k: torch.Tensor, own_v: torch.Tensor,
                  own_lengths: torch.Tensor, tgt_k_last: torch.Tensor,
                  tgt_v_last: torch.Tensor, tgt_valid_upto: torch.Tensor,
                  attn_mask=None, use_flash: bool = False,
                  tree=None, unembed: bool = True) -> torch.Tensor | None:
    """One glide step; returns logits [B, T, V] f32, or None with
    unembed=False (the glide's prefill keeps only its cache writes: under
    tp the logits of a whole chunk would cross the ranks for nothing).

    tokens [B, T] at absolute `positions` [B, T]; own_k / own_v
    [B, Sd, Hkv*D] are the glide's own self-attention cache, appended at
    own_lengths in place; tgt_k_last / tgt_v_last [B, S, Hkv*D] the target
    cache's last layer; tgt_valid_upto [B, T] int32 bounds the
    cross-attention (the target has verified only that many positions).

    Routes, as the JAX package's:
      * dense (attn_mask [B, T, Sd] bool, which replaces the causal
        self-mask, or neither a mask nor use_flash): the plain attention;
      * flash linear (use_flash): both attentions through the port's kernels
        (_flash_flat: the flat decode kernel, or the prefill kernel for a
        glide prefill chunk);
      * flash tree (use_flash and tree = (anc_rows [T, n] bool, tree_base
        [B])): self-attention = the intervals kernel with return_lse over
        the prefix [0, tree_base), merged (ops/attention.merge_lse) with a
        dense ancestor-masked block over the n tree slots at
        [tree_base, tree_base + n); cross-attention as flash linear.
    """
    c = config
    B, T = tokens.shape
    Hkv, Dh = c.n_kv_head, c.head_dim
    mesh = c.mesh
    x = llama.embed(target_params, c, tokens.reshape(-1)).reshape(B, T, -1)

    # self-attention over the glide's own cache
    h = rms_norm(x, glide["self_norm"], c.norm_eps)
    q, k, v = llama._split_qkv(h @ glide["wqkv"], c)
    q = rope(c, q, positions)
    k = rope(c, k, positions)
    append_layer_kv(own_k, own_v, k, v, own_lengths)
    Sd = own_k.shape[1]
    if use_flash and tree is not None:
        anc_rows, tree_base = tree
        n = anc_rows.shape[1]
        zero = torch.zeros((B, T), dtype=torch.int32, device=x.device)
        hi = tree_base.to(torch.int32)[:, None].expand(B, T).contiguous()
        ctx_p, m_p, l_p = flash_decode_intervals(q, own_k, own_v, zero, zero,
                                                 hi, return_lse=True)
        kt = _tree_slice(own_k, tree_base, n).reshape(B, n, Hkv, Dh)
        vt = _tree_slice(own_v, tree_base, n).reshape(B, n, Hkv, Dh)
        tm = torch.as_tensor(np.asarray(anc_rows), device=x.device)
        ctx_t, m_t, l_t = dense.masked_attention_lse(
            q, kt, vt, tm[None].expand(B, T, n))
        ctx = dense.merge_lse(ctx_p, m_p, l_p, ctx_t, m_t, l_t)
    elif use_flash:
        ctx = _flash_flat(q, own_k, own_v,
                          dense.decode_valid_upto(own_lengths, T))
    elif attn_mask is None:
        ctx = dense.masked_attention(q, own_k.reshape(B, Sd, Hkv, Dh),
                                     own_v.reshape(B, Sd, Hkv, Dh),
                                     dense.decode_valid_upto(own_lengths, T))
    else:
        ctx = dense.masked_attention_general(
            q, own_k.reshape(B, Sd, Hkv, Dh), own_v.reshape(B, Sd, Hkv, Dh),
            attn_mask)
    # the context in the block's dtype: an f32 block training against a bf16
    # target (train.glide_loss) keeps it in f32, as JAX's promotion does
    x = x + all_reduce_tp(ctx.reshape(B, T, -1).to(glide["wo"].dtype)
                          @ glide["wo"], mesh)

    # cross-attention into the target's last-layer KV (GQA layout shared),
    # bounded by the verified prefix, so the flash route needs no tree part
    h = rms_norm(x, glide["cross_norm"], c.norm_eps)
    qc = rope(c, (h @ glide["wq_cross"]).reshape(B, T, c.n_head, Dh),
              positions)
    if use_flash:
        ctx = _flash_flat(qc, tgt_k_last, tgt_v_last, tgt_valid_upto)
    else:
        S = tgt_k_last.shape[1]
        ctx = dense.masked_attention(qc, tgt_k_last.reshape(B, S, Hkv, Dh),
                                     tgt_v_last.reshape(B, S, Hkv, Dh),
                                     tgt_valid_upto)
    w = glide["wo_cross"]
    x = x + all_reduce_tp(ctx.reshape(B, T, -1).to(w.dtype) @ w, mesh)

    # SwiGLU MLP
    h = rms_norm(x, glide["ffn_norm"], c.norm_eps)
    w_gu = glide["w_gate_up"]
    gate_up = (h @ w_gu.reshape(w_gu.shape[0], -1)).reshape(B, T, 2, -1)
    x = x + all_reduce_tp((F.silu(gate_up[..., 0, :]) * gate_up[..., 1, :])
                          @ glide["w_down"], mesh)

    if not unembed:
        return None
    # the shared unembedding (final norm, f32 logits; the vocab columns
    # gathered under tp)
    logits = llama.unembed(target_params, c, x.reshape(B * T, -1))
    return all_gather_tp(logits, mesh, dim=1).reshape(B, T, -1)
