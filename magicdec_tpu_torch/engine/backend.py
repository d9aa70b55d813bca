"""Engine: the runtime layer owning KV state and the step functions (port of
the baseline and SnapKV parts of magicdec_tpu/engine/backend.py).

The caches are preallocated tensors that every step writes in place;
raggedness lives in length vectors, so rollback is length arithmetic.

Public surface:
  encode(input_ids)        chunked prefill (+ SnapKV draft build)
  inference(tokens)        target decode/verify without draft writes
  speculate(tokens)        one draft step (the gamma loop is in engine/spec.py)
  verify(tokens)           target verify, dual-writing the draft cache (SnapKV)
  rollback/set_lengths     length arithmetic on the cache state
  clear_kv()               reset lengths (buffers are reused)

Speculation modes: spec=None (baseline) and "snapkv".
"""

from __future__ import annotations

from typing import Optional

import torch

from magicdec_tpu_torch.cache import DraftKVCache, KVCache
from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine.sampling import argmax_tokens
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs

# speculation modes of the JAX package that the port does not have yet, and
# the ROADMAP.md item that ports each
_NOT_PORTED = {"streaming": "Queue A6 (StreamingLLM self-spec)",
               "quest": "Queue A10 (Quest)",
               "retro": "Queue A11 (RetroInfer and SqueezedAttention)",
               "squeeze": "Queue A11 (RetroInfer and SqueezedAttention)"}


# ---------------------------------------------------------------------------
# Step functions: caches written in place, greedy tokens returned
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill_chunk_step(params, config: ModelArgs, cache: KVCache, tokens,
                       last_only: bool = True, cap: int | None = None,
                       start: int | None = None) -> torch.Tensor:
    """One prefill chunk. `start` (int, optional): uniform chunk offset —
    every sequence prefills the same prompt length."""
    T = tokens.shape[1]
    impl = impls.target_attn(config, cache.lengths, T, cap=cap,
                             uniform_start=start)
    logits = llama.forward(params, config, tokens, impl, (cache.k, cache.v),
                           last_only=last_only)
    cache.lengths = cache.lengths + T
    return argmax_tokens(logits)


def _pow2_cap(frontier: int, max_len: int) -> int:
    """Power-of-2 attention bound >= the chunk's causal frontier: early
    prefill chunks neither read nor compute over the whole max_len cache."""
    cap = 128
    while cap < frontier:
        cap *= 2
    return min(cap, max_len)


@torch.inference_mode()
def prefill_last_chunk_snapkv_step(params, config: ModelArgs, cache: KVCache,
                                   draft: DraftKVCache, tokens,
                                   context_len: int, budget: int, window: int,
                                   start: int | None = None) -> torch.Tensor:
    """Final prefill chunk + SnapKV draft-cache construction."""
    T = tokens.shape[1]
    impl = impls.prefill_snapkv_attn(
        config, cache.lengths, T, context_len, budget, window,
        cap=_pow2_cap(context_len, cache.max_len), uniform_start=start)
    logits = llama.forward(params, config, tokens, impl,
                           (cache.k, cache.v, draft.k, draft.v),
                           last_only=True)
    cache.lengths = cache.lengths + T
    draft.lengths = torch.full_like(draft.lengths, budget)
    return argmax_tokens(logits)


@torch.inference_mode()
def target_decode_step(params, config: ModelArgs, cache: KVCache,
                       tokens) -> torch.Tensor:
    """Decode/verify without draft writes (the baseline)."""
    T = tokens.shape[1]
    impl = impls.target_attn(config, cache.lengths, T)
    logits = llama.forward(params, config, tokens, impl, (cache.k, cache.v))
    cache.lengths = cache.lengths + T
    return argmax_tokens(logits)


@torch.inference_mode()
def verify_dual_step(params, config: ModelArgs, cache: KVCache,
                     draft: DraftKVCache, tokens) -> torch.Tensor:
    """SnapKV verify: target attention, k/v appended to both caches at the
    round-start draft offset (overwriting the spec-written entries)."""
    T = tokens.shape[1]
    impl = impls.verify_dual_attn(config, cache.lengths, draft.lengths, T)
    logits = llama.forward(params, config, tokens, impl,
                           (cache.k, cache.v, draft.k, draft.v))
    cache.lengths = cache.lengths + T
    draft.lengths = draft.lengths + T
    return argmax_tokens(logits)


@torch.inference_mode()
def draft_decode_snapkv_step(params, config: ModelArgs, draft: DraftKVCache,
                             tokens, position_base) -> torch.Tensor:
    """One SnapKV draft step; queries rotate at true absolute positions."""
    T = tokens.shape[1]
    impl = impls.snapkv_draft_attn(config, position_base, draft.lengths, T)
    logits = llama.forward(params, config, tokens, impl, (draft.k, draft.v))
    draft.lengths = draft.lengths + T
    return argmax_tokens(logits)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine:
    def __init__(self, config: ModelArgs, params, *, batch_size: int,
                 max_len: int, spec: Optional[str] = None,
                 draft_budget: int = 0, window_size: int = 32,
                 prefill_chunk: int = 128,
                 kv_dtype=None, device=None):
        if spec in _NOT_PORTED:
            raise NotImplementedError(
                f"spec={spec!r} is not ported yet: ROADMAP.md {_NOT_PORTED[spec]}")
        if spec not in (None, "snapkv"):
            raise ValueError(f"unknown spec mode {spec!r}")
        if spec and draft_budget <= 0:
            raise ValueError("speculation needs draft_budget > 0")
        self.device = resolve_device(device)
        w = params["layers"]["wqkv"]
        if w.device != self.device:
            raise ValueError(f"params lie on {w.device}, the engine runs on "
                             f"{self.device}")
        self.config = config
        self.params = params
        self.batch_size = batch_size
        self.max_len = -(-max_len // 128) * 128     # tile alignment
        self.spec = spec
        self.draft_budget = draft_budget
        self.window_size = window_size
        self.prefill_chunk = prefill_chunk
        self.kv_dtype = kv_dtype or w.dtype
        c = config
        self.cache = KVCache.create(c.n_layer, batch_size, self.max_len,
                                    c.n_kv_head, c.head_dim, self.kv_dtype,
                                    self.device)
        self.draft: Optional[DraftKVCache] = None    # sized by encode
        self._draft_round_start_lengths = None

    def _size_draft(self, prefix_len: int):
        """The SnapKV draft cache for a prefix of prefix_len tokens: the
        budget plus every slot the target cache has left. Each round appends
        to both caches alike, so the draft never drops an append the target
        keeps (a dropped draft append would make draft and verify differ)."""
        size = self.draft_budget + self.max_len - prefix_len
        if self.draft is None or self.draft.size != size:
            c = self.config
            self.draft = DraftKVCache.create(
                c.n_layer, self.batch_size, size, c.n_kv_head, c.head_dim,
                self.kv_dtype, self.device)

    def _tokens(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.int32, device=self.device)

    # -- prefill ------------------------------------------------------------

    def encode(self, input_ids) -> torch.Tensor:
        """Chunked prefill; returns the first generated token [B, 1]. The last
        chunk builds the SnapKV draft cache."""
        input_ids = self._tokens(input_ids)
        B, P = input_ids.shape
        if B != self.batch_size:
            raise ValueError(f"batch {B} != engine batch {self.batch_size}")
        chunk = self.prefill_chunk
        if P % chunk:
            raise ValueError(f"prefix length {P} must be a multiple of {chunk}")
        if self.spec == "snapkv":
            if self.draft_budget > P:
                raise ValueError("SnapKV budget must fit the prefix")
            self._size_draft(P)
        n_chunks = P // chunk
        next_tok = None
        for i in range(n_chunks):
            tok = input_ids[:, i * chunk:(i + 1) * chunk]
            if self.spec == "snapkv" and i == n_chunks - 1:
                next_tok = prefill_last_chunk_snapkv_step(
                    self.params, self.config, self.cache, self.draft, tok,
                    context_len=P, budget=self.draft_budget,
                    window=self.window_size, start=i * chunk)
            else:
                cap = _pow2_cap((i + 1) * chunk, self.max_len)
                next_tok = prefill_chunk_step(self.params, self.config,
                                              self.cache, tok, cap=cap,
                                              start=i * chunk)
        if self.draft is not None:
            self._draft_round_start_lengths = self.draft.lengths
        return next_tok

    # -- decode-side API ------------------------------------------------------

    def inference(self, tokens) -> torch.Tensor:
        return target_decode_step(self.params, self.config, self.cache,
                                  self._tokens(tokens))

    def verify(self, tokens) -> torch.Tensor:
        if self.spec == "snapkv":
            return verify_dual_step(self.params, self.config, self.cache,
                                    self.draft, self._tokens(tokens))
        return self.inference(tokens)

    def speculate(self, tokens) -> torch.Tensor:
        """One SnapKV draft step: the first speculated token sits at absolute
        position target length + tokens already speculated this round."""
        offset = self.draft.lengths - self._draft_round_start_lengths
        return draft_decode_snapkv_step(self.params, self.config, self.draft,
                                        self._tokens(tokens),
                                        self.cache.lengths + offset)

    def begin_spec_round(self):
        """Snapshot draft lengths at round start (verify dual-writes here)."""
        self._draft_round_start_lengths = self.draft.lengths

    # -- state management -----------------------------------------------------

    def rollback_target(self, n):
        self.cache.rollback(n)

    def rollback_draft(self, n):
        self.draft.rollback(n)

    def set_lengths(self, target=None, draft=None):
        if target is not None:
            self.cache.set_lengths(self._tokens(target))
        if draft is not None:
            self.draft.lengths = self._tokens(draft)

    def clear_kv(self):
        zero = torch.zeros(self.batch_size, dtype=torch.int32,
                           device=self.device)
        self.cache.set_lengths(zero)
        if self.draft is not None:
            self.draft.lengths = zero.clone()
            self.draft.evicted = zero.clone()
