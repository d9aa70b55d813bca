"""Engine: the runtime layer owning KV state and the step functions (port of
magicdec_tpu/engine/backend.py).

The caches are preallocated tensors that every step writes in place;
raggedness lives in length vectors, so rollback is length arithmetic.

Public surface:
  encode(input_ids)        chunked prefill (+ SnapKV/StreamingLLM draft build,
                           Quest page boxes, RetroInfer/Squeeze cluster index)
  inference(tokens)        target decode/verify without draft writes
  speculate(tokens)        one draft step (the gamma loop is in engine/spec.py)
  verify(tokens)           target verify, dual-writing the draft cache (SnapKV)
  rollback/set_lengths     length arithmetic on the cache state
  compact_draft()          StreamingLLM window compaction (between rounds)
  drop_cache()             free the target cache (a standalone draft's)
  clear_kv()               reset lengths (buffers are reused)

Speculation modes: spec=None (baseline), "snapkv", "streaming", and
"quest", "retro" and "squeeze", which draft out of the target cache through
a round buffer that generate_selfspec allocates (no draft cache).

Parallelism: Engine(..., mesh=parallel.sharding.make_mesh(dp, tp)) in every
rank of a mesh (parallel/launch.run_world) shards the params over tp and
runs the rank's layers with sharding.local_config, so its caches hold the
rank's KV heads; replicate_tp=True keeps the model whole on every rank (the
asymmetric-TP draft of engine/longspec.py). Under dp the caches hold the
rank's B/dp rows: batch_size stays the whole batch, encode takes the whole
[B, P] prompt and keeps the rank's rows (sharding.shard_tokens), and the
decode-side calls (inference, verify, speculate) take and return the
rank's rows. mesh=None is the single-device path.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from magicdec_tpu_torch import cache as cache_lib
from magicdec_tpu_torch.cache import DraftKVCache, KVCache
from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine.quest import make_page_meta
from magicdec_tpu_torch.engine.retro import build_retro_state
from magicdec_tpu_torch.engine.sampling import argmax_tokens
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.parallel import sharding
from magicdec_tpu_torch.quant.int8 import is_quantized

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
def build_streaming_draft_step(cache: KVCache, draft: DraftKVCache,
                               budget: int, sink: int) -> None:
    """Fill the StreamingLLM draft cache from the target cache: the sink
    slots and the last budget - sink prefix slots, gathered verbatim (the
    draft shares the target's weights and stores K rotated at its true
    position, see attention_impls.streaming_draft_attn)."""
    B = cache.lengths.shape[0]
    dev = cache.lengths.device
    lens = cache.lengths.to(torch.int32)
    keep = torch.clamp(lens, max=budget)                              # [B]
    slot = torch.arange(draft.size, dtype=torch.int32, device=dev)[None, :]
    win_src = lens[:, None] - (keep[:, None] - slot)
    src = torch.where(slot < sink, slot, win_src).clamp(0, cache.max_len - 1)
    b_idx = torch.arange(B, device=dev)[:, None]
    draft.k = cache.k[:, b_idx, src.long()].to(draft.k.dtype)
    draft.v = cache.v[:, b_idx, src.long()].to(draft.v.dtype)
    draft.lengths = keep
    draft.evicted = torch.clamp(lens - keep, min=0).to(torch.int32)


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


@torch.inference_mode()
def draft_decode_streaming_step(params, config: ModelArgs,
                                draft: DraftKVCache, tokens, budget: int,
                                sink: int) -> torch.Tensor:
    """One StreamingLLM draft step (true-position K store, sink twist)."""
    T = tokens.shape[1]
    impl = impls.streaming_draft_attn(config, draft.lengths, draft.evicted,
                                      budget, sink, T)
    logits = llama.forward(params, config, tokens, impl, (draft.k, draft.v))
    draft.lengths = draft.lengths + T
    return argmax_tokens(logits)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine:
    """Owns the target cache and, with spec set, the draft cache.

    SnapKV sizes its draft cache at encode (budget plus the slots the target
    has left, so no draft append is dropped); StreamingLLM keeps
    draft_budget + draft_headroom slots and compacts once a length passes
    size - draft_headroom // 2. Quest, RetroInfer and SqueezedAttention keep
    no draft cache: encode builds their index (spec_index: the page boxes of
    quest_page-slot pages, or the cluster index and KV-fused store of
    retro_clusters clusters of at most retro_cap members), and the draft
    attends the selected pages or clusters plus a tail of the latest_k
    newest rows. retro_clusters=0 means max(max_len // 32, 8), the JAX
    package's sizing (max_len before rounding); squeeze_threshold is the
    normalised mass a cluster needs to be attended.

    mesh: a dp x tp mesh (parallel/sharding.make_mesh); the params may be
    the whole tree (plain or quantized) or the rank's plain shards
    (init_sharded_params), and self.config is the rank's local config
    (self.model_config the whole model's). replicate_tp keeps every weight
    and cache column whole on every rank. batch_size is the whole batch;
    the caches hold local_batch = batch_size / dp rows."""

    def __init__(self, config: ModelArgs, params, *, batch_size: int,
                 max_len: int, spec: Optional[str] = None,
                 draft_budget: int = 0, window_size: int = 32,
                 sink_size: int = 16, draft_headroom: int = 64,
                 latest_k: int = 128, quest_page: int = 128,
                 retro_clusters: int = 0, retro_cap: int = 32,
                 squeeze_threshold: float = 0.01,
                 prefill_chunk: int = 128,
                 kv_dtype=None, device=None, mesh=None,
                 replicate_tp: bool = False):
        if spec not in (None, "snapkv", "streaming", "quest", "retro",
                        "squeeze"):
            raise ValueError(f"unknown spec mode {spec!r}")
        if spec and draft_budget <= 0:
            raise ValueError("speculation needs draft_budget > 0")
        self.mesh = mesh
        self.model_config = config
        dp = 1 if mesh is None else mesh.dp
        if batch_size % dp:
            raise ValueError(f"batch {batch_size} does not divide dp={dp}")
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
            params = sharding.shard_params(params, mesh, config, replicate_tp)
            if not replicate_tp:
                config = sharding.local_config(config, mesh)
        self.device = resolve_device(device)
        emb = params["tok_embeddings"]      # quantization leaves it as it is
        if emb.device != self.device:
            raise ValueError(f"params lie on {emb.device}, the engine runs on "
                             f"{self.device}")
        self.config = config
        self.params = params
        self.batch_size = batch_size
        self.local_batch = batch_size // dp
        self.max_len = -(-max_len // 128) * 128     # tile alignment
        self.spec = spec
        self.draft_budget = draft_budget
        self.window_size = window_size
        self.sink_size = sink_size
        self.draft_headroom = draft_headroom
        self.latest_k = latest_k
        self.quest_page = quest_page
        self.retro_cap = retro_cap
        self.retro_clusters = retro_clusters or max(max_len // 32, 8)
        self.squeeze_threshold = squeeze_threshold
        self.index_build_s = 0.0    # the last encode's index build, seconds
        self.prefill_chunk = prefill_chunk
        # the weights' dtype, or bf16 under quantized weights (as the JAX
        # Engine)
        w = params["layers"]["wqkv"]
        self.kv_dtype = kv_dtype or (torch.bfloat16 if is_quantized(w)
                                     else w.dtype)
        self._create_cache()
        # SnapKV: sized by encode; StreamingLLM: budget + headroom slots
        self.draft: Optional[DraftKVCache] = None
        if spec == "streaming":
            self._new_draft(draft_budget + draft_headroom)
        self._draft_round_start_lengths = None
        self.spec_index = None      # Quest/Retro/Squeeze: built at encode

    def _create_cache(self):
        c = self.config
        self.cache = KVCache.create(c.n_layer, self.local_batch, self.max_len,
                                    c.n_kv_head, c.head_dim, self.kv_dtype,
                                    self.device)

    def _new_draft(self, size: int):
        c = self.config
        self.draft = DraftKVCache.create(c.n_layer, self.local_batch, size,
                                         c.n_kv_head, c.head_dim,
                                         self.kv_dtype, self.device)

    def drop_cache(self):
        """Free the target cache (recreated by the next encode): a
        compressed standalone draft needs only its budget cache after
        prefill."""
        self.cache = None

    def _size_draft(self, prefix_len: int):
        """The SnapKV draft cache for a prefix of prefix_len tokens: the
        budget plus every slot the target cache has left. Each round appends
        to both caches alike, so the draft never drops an append the target
        keeps (a dropped draft append would make draft and verify differ)."""
        size = self.draft_budget + self.max_len - prefix_len
        if self.draft is None or self.draft.size != size:
            self._new_draft(size)

    def _tokens(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.int32, device=self.device)

    # -- prefill ------------------------------------------------------------

    def encode(self, input_ids) -> torch.Tensor:
        """Chunked prefill of the whole batch's prompt [B, P] (under dp the
        rank prefills its rows); returns the first generated token of the
        rank's rows [B/dp, 1]. The last
        chunk builds the SnapKV draft cache; StreamingLLM gathers its draft
        cache from the target cache afterwards, Quest builds the page
        boxes of the prefilled cache, and RetroInfer/SqueezedAttention its
        cluster index and KV-fused store (timed in index_build_s, on the card
        up to a synchronize)."""
        if self.cache is None:
            self._create_cache()
        input_ids = self._tokens(input_ids)
        B, P = input_ids.shape
        if B != self.batch_size:
            raise ValueError(f"batch {B} != engine batch {self.batch_size}")
        input_ids = sharding.shard_tokens(input_ids, self.mesh)
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
        if self.spec == "streaming":
            build_streaming_draft_step(self.cache, self.draft,
                                       self.draft_budget, self.sink_size)
        elif self.spec == "quest":
            self.spec_index = make_page_meta(self.cache, self.quest_page)
        elif self.spec in ("retro", "squeeze"):
            t0 = time.perf_counter()
            self.spec_index = build_retro_state(self.cache,
                                                self.retro_clusters,
                                                self.retro_cap,
                                                mesh=self.config.mesh)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.index_build_s = time.perf_counter() - t0
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
        """One draft step. SnapKV: the first speculated token sits at
        absolute position target length + tokens already speculated this
        round. StreamingLLM: positions follow from the draft cache. Quest,
        RetroInfer and SqueezedAttention draft only inside generate_selfspec
        (their round buffer lives there)."""
        if self.spec in ("quest", "retro", "squeeze"):
            raise ValueError(f"spec={self.spec!r} drafts inside "
                             f"generate_selfspec only")
        if self.spec == "streaming":
            return draft_decode_streaming_step(
                self.params, self.config, self.draft, self._tokens(tokens),
                self.draft_budget, self.sink_size)
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

    def compaction_trigger(self) -> int:
        """StreamingLLM compacts once some draft length passes this."""
        return self.draft.size - self.draft_headroom // 2

    def compact_draft(self, need: bool | None = None):
        """StreamingLLM window compaction (between rounds). `need`: the
        host copy of cache.compaction_needed if the caller read it; None
        reads it here."""
        if self.spec == "streaming":
            cache_lib.streaming_compact(self.draft, self.draft_budget,
                                        self.sink_size,
                                        self.compaction_trigger(), need)

    def clear_kv(self):
        zero = torch.zeros(self.local_batch, dtype=torch.int32,
                           device=self.device)
        if self.cache is not None:
            self.cache.set_lengths(zero)
        if self.draft is not None:
            self.draft.lengths = zero.clone()
            self.draft.evicted = zero.clone()
