"""Continuous batching: per-request admission and eviction mid-generation
(port of magicdec_tpu/engine/serve.py).

The batch is a fixed B-row frame, and continuous batching is row recycling
around engine/spec.snapkv_round, the round generate_selfspec runs, so a
request's stream is the one a standalone generation of its prompt emits
(rows are independent in every batched op). After each round the host
reads the frame's counts, lengths and output in one transfer, finalizes
rows that reached their token budget, an EOT or the end of the cache, and
installs queued requests into the freed rows:

  * each new request is prefilled on a 1-row staging Engine (no
    whole-batch forward is spent on one row), then its target cache row,
    SnapKV draft row and first token are copied into the freed frame row
    in place (_install_row);
  * parked (empty) rows keep decoding garbage into their own output row,
    which nobody reads; their lengths are reset at finalize (_park_row) so
    they never overflow the frame.

The staging Engine sizes its draft cache per prompt (budget + max_len - P,
so no draft append is dropped); the frame's draft rows hold the largest of
those for the prompts actually served (run sizes them from its queue, and
an admission of a shorter prompt grows them, rows kept), and _install_row
copies the staging row into the front of the frame row. The JAX frame keeps
budget + 64 draft slots and drops draft appends past them; streams are
the same either way (the verify decides), rounds only while no row has
outgrown those 64 slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from magicdec_tpu_torch.cache import DraftKVCache, KVCache
from magicdec_tpu_torch.engine.backend import Engine
from magicdec_tpu_torch.engine.spec import _eot_array, snapkv_round

# the lengths a parked row decodes from: slots 0..8 hold stale but finite
# values, so its garbage decode never takes an empty softmax
PARK_LEN = 8


@dataclass
class Request:
    """One generation request. The prompt's length must be a multiple of
    the engine's prefill_chunk and at least draft_budget (SnapKV's
    constraint)."""
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int


@dataclass
class Completion:
    req_id: int
    tokens: np.ndarray          # generated tokens (<= max_new, EOT-clipped)
    prompt_len: int
    rounds: int                 # speculation rounds this request was live


@torch.inference_mode()
def _install_row(cache: KVCache, draft: DraftKVCache, buffer0, output,
                 gen_counts, st_cache: KVCache, st_draft: DraftKVCache,
                 st_tok, row: int) -> None:
    """Copy the staging engine's single row into frame row `row`, in place:
    the target cache row whole, the staging draft's slots into the front of
    the frame's draft row, the lengths, the first token; the row's output
    (dump column included) and count are zeroed."""
    cache.k[:, row] = st_cache.k[:, 0]
    cache.v[:, row] = st_cache.v[:, 0]
    cache.lengths[row] = st_cache.lengths[0]
    sd = st_draft.size
    if sd > draft.size:
        raise ValueError(f"staging draft of {sd} slots does not fit the "
                         f"frame's {draft.size}")
    draft.k[:, row, :sd] = st_draft.k[:, 0]
    draft.v[:, row, :sd] = st_draft.v[:, 0]
    draft.lengths[row] = st_draft.lengths[0]
    draft.evicted[row] = st_draft.evicted[0]
    buffer0[row, 0] = st_tok[0, 0]
    output[row] = 0
    gen_counts[row] = 0


@torch.inference_mode()
def _park_row(cache: KVCache, draft: DraftKVCache, row: int) -> None:
    """Reset a finalized row's lengths, so its dead decode can never
    overflow the frame."""
    cache.lengths[row] = PARK_LEN
    draft.lengths[row] = PARK_LEN
    draft.evicted[row] = 0


class ServeEngine:
    """Continuous-batching server over SnapKV self-speculation.

    Usage:
        srv = ServeEngine(config, params, batch_size=4, max_len=4096,
                          draft_budget=128, gamma=4, max_new_cap=128)
        done = srv.run([Request(0, prompt0, 64), Request(1, prompt1, 96)])

    Runs on the current CUDA device unless `device` says otherwise (with no
    GPU and no device it raises, as Engine does). After run: `rounds`,
    `live_row_rounds` (the live rows summed over rounds; occupancy =
    live_row_rounds / (rounds * B)), `host_reads` (one per round),
    `admissions` and acceptance_rate (the live rows' accepted drafts over
    their drafted tokens; parked rows' garbage rounds are not counted)."""

    def __init__(self, config, params, *, batch_size: int, max_len: int,
                 draft_budget: int, gamma: int = 4, max_new_cap: int = 256,
                 window_size: int = 32, prefill_chunk: int = 128,
                 eot_ids=(), kv_dtype=None, device=None):
        kw = dict(max_len=max_len, spec="snapkv", draft_budget=draft_budget,
                  window_size=window_size, prefill_chunk=prefill_chunk,
                  kv_dtype=kv_dtype, device=device)
        self.frame = Engine(config, params, batch_size=batch_size, **kw)
        self.stage = Engine(config, params, batch_size=1, **kw)
        self.device = dev = self.frame.device
        self.gamma = gamma
        self.max_new_cap = max_new_cap
        self.eot = _eot_array(eot_ids, dev)
        self.eot_ids = tuple(eot_ids)
        B = batch_size
        cap = max_new_cap + gamma + 2
        self.buffer0 = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        # column cap is snapkv_round's dump column
        self.output = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
        self.gen_counts = torch.zeros(B, dtype=torch.int32, device=dev)
        self._live = torch.zeros(B, dtype=torch.int32, device=dev)
        self._accepted = torch.zeros((), dtype=torch.int64, device=dev)
        self.row_req: list[Request | None] = [None] * B
        self.row_rounds = [0] * B
        self.rounds = 0
        self.live_row_rounds = 0
        self.host_reads = 0
        self.admissions = 0

    # -- admission ---------------------------------------------------------

    @torch.inference_mode()
    def _fit_draft(self, prompt_len: int):
        """Grow the frame's draft rows to the staging draft of a prompt of
        prompt_len tokens (budget + max_len - prompt_len slots), keeping
        the rows installed so far. Sized to the prompts served rather than
        the shortest one the frame could admit, which would make each draft
        row about as long as its target cache row."""
        frame = self.frame
        need = frame.draft_budget + frame.max_len - prompt_len
        old = frame.draft
        if old is not None and need <= old.size:
            return
        frame._new_draft(need)
        if old is None:
            return
        new = frame.draft
        new.k[:, :, :old.size] = old.k
        new.v[:, :, :old.size] = old.v
        new.lengths.copy_(old.lengths)
        new.evicted.copy_(old.evicted)

    def _admit(self, row: int, req: Request):
        if req.max_new_tokens > self.max_new_cap:
            raise ValueError(f"request {req.req_id}: max_new_tokens "
                             f"{req.max_new_tokens} > max_new_cap "
                             f"{self.max_new_cap}")
        self._fit_draft(len(req.prompt))
        self.stage.clear_kv()
        tok = self.stage.encode(np.asarray(req.prompt)[None, :])
        _install_row(self.frame.cache, self.frame.draft, self.buffer0,
                     self.output, self.gen_counts, self.stage.cache,
                     self.stage.draft, tok, row)
        self.row_req[row] = req
        self.row_rounds[row] = 0
        self._live[row] = 1
        self.admissions += 1

    def _finalize(self, row: int, counts: np.ndarray,
                  out_np: np.ndarray) -> Completion:
        req = self.row_req[row]
        n = min(int(counts[row]), req.max_new_tokens)
        toks = out_np[row, :n].copy()
        for e in self.eot_ids:                      # clip at the first EOT
            hit = np.nonzero(toks == e)[0]
            if hit.size:
                toks = toks[:hit[0] + 1]
        self.row_req[row] = None
        self._live[row] = 0
        _park_row(self.frame.cache, self.frame.draft, row)
        return Completion(req.req_id, toks, len(req.prompt),
                          self.row_rounds[row])

    # -- the serving loop --------------------------------------------------

    @torch.inference_mode()
    def run(self, requests, max_rounds: int | None = None):
        """Serve `requests` (list[Request], FIFO) to completion; returns
        list[Completion] in finish order. One host read per round."""
        queue = list(requests)
        done: list[Completion] = []
        B = self.frame.batch_size
        if queue:                   # one draft allocation for the whole queue
            self._fit_draft(min(len(r.prompt) for r in queue))
        for row in range(B):                        # initial fill
            if queue and self.row_req[row] is None:
                self._admit(row, queue.pop(0))

        frame = self.frame
        while any(r is not None for r in self.row_req):
            self.buffer0, self.gen_counts, info = snapkv_round(
                frame.params, frame.config, frame.cache, frame.draft,
                self.buffer0, self.output, self.gen_counts, self.eot,
                self.gamma)
            self._accepted += ((info["accept_nums"] - 1) * self._live).sum()
            self.rounds += 1
            for row in range(B):
                if self.row_req[row] is not None:
                    self.row_rounds[row] += 1
                    self.live_row_rounds += 1

            # counts, target lengths and output in one device-to-host copy
            # (snapkv_round rebinds the lengths: read them off the cache)
            host = torch.cat([self.gen_counts[:, None],
                              frame.cache.lengths[:, None],
                              self.output], dim=1).cpu().numpy()
            self.host_reads += 1
            counts, lengths, out_np = host[:, 0], host[:, 1], host[:, 2:]
            for row in range(B):
                req = self.row_req[row]
                if req is None:
                    continue
                seg = out_np[row, :int(counts[row])]
                hit_eot = any((seg == e).any() for e in self.eot_ids)
                full = int(counts[row]) >= req.max_new_tokens
                near_cap = (int(lengths[row]) + self.gamma + 1
                            > frame.max_len)
                if full or hit_eot or near_cap:
                    done.append(self._finalize(row, counts, out_np))
                    if queue:
                        self._admit(row, queue.pop(0))
            if max_rounds is not None and self.rounds >= max_rounds:
                break
        return done

    @property
    def acceptance_rate(self) -> float:
        drafted = self.live_row_rounds * self.gamma
        return int(self._accepted) / drafted if drafted else 0.0

    @property
    def occupancy(self) -> float:
        """Live rows over frame rows, averaged over the rounds run."""
        return (self.live_row_rounds / (self.rounds * self.frame.batch_size)
                if self.rounds else 0.0)
