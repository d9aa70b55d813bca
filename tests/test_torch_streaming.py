"""The port's StreamingLLM path on the CPU against the JAX package.

flash_decode_intervals' plain version against the JAX kernel in Pallas
interpret mode (tolerance 2e-5, the JAX kernel tests' own), the sink+window
bookkeeping of cache.py, one streaming_draft_attn step with evicted > 0, and
generate_selfspec(spec="streaming") token for token against the JAX package's.
float32, JAX matmuls at "highest" precision (conftest.py), TF32 off in
torch. Weights and prompts are those of tests/test_selfspec.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu import cache as jcache
from magicdec_tpu.engine import attention_impls as jimpls
from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.spec import generate_selfspec as j_spec
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu.ops.pallas import flash_decode as jfd
from magicdec_tpu_torch import cache as tcache
from magicdec_tpu_torch.cache import DraftKVCache
from magicdec_tpu_torch.engine import attention_impls as timpls
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import (_eot_array, generate_autoregressive,
                                            generate_selfspec as t_spec,
                                            streaming_round)
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy
from magicdec_tpu_torch.ops import flash_decode as tfd

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-5, atol=2e-5)

# ---------------------------------------------------------------------------
# flash_decode_intervals
# ---------------------------------------------------------------------------

B4, Hkv4, G4, D16 = 4, 4, 2, 16


def _flat_inputs(S, T, seed, D=D16):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B4, S, Hkv4 * D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B4, S, Hkv4 * D)).astype(np.float32)
    q = rng.standard_normal((B4, T, Hkv4 * G4, D)).astype(np.float32)
    return q, k, v


def _bounds(sink, lo, width, T):
    """[B, T] int32 (sink_end, lo, hi): row t of sequence b attends to
    [0, sink) u [lo[b] + t, lo[b] + t + width)."""
    t = np.arange(T)[None, :]
    lo = np.asarray(lo)[:, None] + t
    return (np.full(lo.shape, sink, np.int32), lo.astype(np.int32),
            (lo + width).astype(np.int32))


# (S, sink, window starts, window width, head_dim): the case of
# tests/test_flash_decode.py (a 16-slot sink and 60-slot windows), a gap of
# whole 64-slot tiles between a 128-slot sink and the window, a window past
# the first 256-slot split of the decode kernel, windows that start inside
# the sink, and the gap case at head_dim 128 (the kernels' larger build)
INTERVAL_CASES = {
    "sink16_window60": (256, 16, [64, 80, 100, 64], 60, D16),
    "gap_of_whole_tiles": (384, 128, [320, 256, 200, 300], 60, D16),
    "window_past_split": (704, 16, [520, 600, 16, 640], 62, D16),
    "window_inside_sink": (256, 32, [0, 10, 31, 32], 40, D16),
    "gap_of_whole_tiles_d128": (384, 128, [320, 256, 200, 300], 60, 128),
}


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("case", sorted(INTERVAL_CASES))
def test_intervals_plain_matches_jax_kernel(case, T):
    S, sink, lo, width, D = INTERVAL_CASES[case]
    q, k, v = _flat_inputs(S, T, seed=S + T, D=D)
    a, lo, hi = _bounds(sink, lo, width, T)
    ref = jfd.flash_decode_intervals(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(a),
                                     jnp.asarray(lo), jnp.asarray(hi),
                                     s_block=128, interpret=True)
    tt = [torch.from_numpy(x) for x in (q, k, v, a, lo, hi)]
    out = tfd.flash_decode_intervals(*tt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flat_flash_decode_matches_jax_kernel():
    S, T = 264, 2
    q, k, v = _flat_inputs(S, T, seed=9)
    valid = np.asarray([[200, 201], [263, 264], [3, 4], [129, 130]], np.int32)
    ref = jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(valid), s_block=128, interpret=True)
    out = tfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_intervals_sink_rows_replace_the_cache_rows():
    """k_sink [B, n, Hkv*D] stands for the K of slots < n and is read
    nowhere else; with the cache's own rows it changes nothing."""
    S, T, n = 256, 2, 16
    q, k, v = (torch.from_numpy(x) for x in _flat_inputs(S, T, seed=4))
    a, lo, hi = (torch.from_numpy(x) for x in _bounds(n, [64, 80, 100, 64],
                                                       60, T))
    twisted = torch.randn((B4, n, Hkv4 * D16),
                          generator=torch.Generator().manual_seed(0))
    k_swapped = k.clone()
    k_swapped[:, :n] = twisted
    out = tfd.flash_decode_intervals(q, k, v, a, lo, hi, k_sink=twisted)
    torch.testing.assert_close(
        out, tfd.flash_decode_intervals(q, k_swapped, v, a, lo, hi),
        rtol=0, atol=0)
    same = tfd.flash_decode_intervals(q, k, v, a, lo, hi,
                                      k_sink=k[:, :n].contiguous())
    torch.testing.assert_close(same, tfd.flash_decode_intervals(q, k, v, a,
                                                                lo, hi),
                               rtol=0, atol=0)
    assert not torch.equal(out, same)


def test_intervals_limit_is_the_decode_limit():
    """intervals_plain_f32_and_limit: the f32 tolerance of the decode
    kernels, and the bf16 rounding bound, on the two-interval plain
    version."""
    S, T = 256, 2
    q, k, v = (torch.from_numpy(x) for x in _flat_inputs(S, T, seed=5))
    a, lo, hi = (torch.from_numpy(x) for x in _bounds(16, [64, 80, 100, 64],
                                                       60, T))
    ref, limit = tfd.intervals_plain_f32_and_limit(q, k, v, a, lo, hi)
    torch.testing.assert_close(ref, tfd.intervals_plain(q, k, v, a, lo, hi))
    torch.testing.assert_close(limit, 2e-5 + 2e-5 * ref.abs())
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref_b, limit_b = tfd.intervals_plain_f32_and_limit(qb, kb, vb, a, lo, hi)
    ref_abs = tfd.intervals_plain(qb.float(), kb.float(), vb.float().abs(), a,
                                  lo, hi)
    torch.testing.assert_close(
        limit_b, 1.1 * 2.0 ** -8 * (ref_b.abs() + ref_abs) + 1e-5)


# ---------------------------------------------------------------------------
# cache.py: streaming_positions, streaming_compact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [[5, 11], [0, 2], [8, 12]])
def test_streaming_positions_match_jax(lengths):
    budget, sink, size = 8, 2, 12
    jp, jv = jcache.streaming_positions(jnp.asarray(lengths, jnp.int32), size,
                                        budget, sink)
    tp, tv = tcache.streaming_positions(torch.tensor(lengths, dtype=torch.int32),
                                        size, budget, sink)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("lengths,trigger", [([9, 4], 8), ([5, 3], 8),
                                             ([9, 10], 8)])
def test_streaming_compact_matches_jax(lengths, trigger):
    """A gather when some length passes the trigger (sequences within the
    budget keep their slots), a no-op below it."""
    budget, sink, L, Bc, size, HD = 6, 2, 2, 2, 10, 3
    rng = np.random.default_rng(trigger + sum(lengths))
    k = rng.standard_normal((L, Bc, size, HD)).astype(np.float32)
    v = rng.standard_normal((L, Bc, size, HD)).astype(np.float32)
    evicted = np.asarray([1, 0], np.int32)
    jd = jcache.streaming_compact(
        jcache.DraftKVCache(jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths, jnp.int32),
                            jnp.asarray(evicted)), budget, sink, trigger)
    td = DraftKVCache(torch.from_numpy(k), torch.from_numpy(v),
                      torch.tensor(lengths, dtype=torch.int32),
                      torch.from_numpy(evicted))
    tcache.streaming_compact(td, budget, sink, trigger)
    for name in ("k", "v", "lengths", "evicted"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))


def test_streaming_compact_takes_the_callers_flag():
    """need=False skips the gather whatever the lengths (the round loop has
    read the flag already); need=True gathers."""
    d = DraftKVCache.create(1, 1, 10, 1, 1, torch.float32)
    d.k = torch.arange(10.0).reshape(1, 1, 10, 1)
    d.lengths = torch.tensor([9], dtype=torch.int32)
    assert bool(tcache.compaction_needed(d, 8))
    tcache.streaming_compact(d, 6, 2, 8, need=False)
    assert d.lengths.tolist() == [9]
    tcache.streaming_compact(d, 6, 2, 8, need=True)
    assert d.k[0, 0, :6, 0].tolist() == [0, 1, 5, 6, 7, 8]
    assert (d.lengths.tolist(), d.evicted.tolist()) == ([6], [3])


# ---------------------------------------------------------------------------
# streaming_draft_attn: one step with evicted > 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 2])
def test_streaming_draft_attn_step_matches_jax(T):
    """Two sequences with evicted slots (delta != 0, the sink twist on) and
    the window start past the sink; T=2 with the re-feed's write mask."""
    kw = dict(block_size=512, vocab_size=64, n_layer=1, n_head=4, n_kv_head=2,
              dim=64)
    jcfg, tcfg = JArgs(**kw), TArgs(**kw)
    Bq, size, sink, budget = 2, 24, 4, 16
    Hkv, D, Hq = 2, 16, 4
    rng = np.random.default_rng(T)
    dk = rng.standard_normal((1, Bq, size, Hkv * D)).astype(np.float32)
    dv = rng.standard_normal((1, Bq, size, Hkv * D)).astype(np.float32)
    q = rng.standard_normal((Bq, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, T, Hkv, D)).astype(np.float32)
    lens = np.asarray([17, 20], np.int32)
    evicted = np.asarray([3, 40], np.int32)
    wm = np.asarray([[False, True], [True, True]])[:, :T] if T == 2 else None
    jimpl = jimpls.streaming_draft_attn(
        jcfg, jnp.asarray(lens), jnp.asarray(evicted), budget, sink,
        write_mask=None if wm is None else jnp.asarray(wm))
    jctx, (jdk, jdv) = jimpl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             (jnp.asarray(dk), jnp.asarray(dv)), jnp.int32(0))
    tdk, tdv = torch.from_numpy(dk.copy()), torch.from_numpy(dv.copy())
    timpl = timpls.streaming_draft_attn(
        tcfg, torch.from_numpy(lens), torch.from_numpy(evicted), budget, sink,
        T, write_mask=None if wm is None else torch.from_numpy(wm))
    tctx = timpl(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 (tdk, tdv), 0)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(tdk.numpy(), np.asarray(jdk), **TOL)
    np.testing.assert_array_equal(tdv.numpy(), np.asarray(jdv))


# ---------------------------------------------------------------------------
# generate_selfspec(spec="streaming") against the JAX package's
# ---------------------------------------------------------------------------

CFG_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=4,
              n_kv_head=2, dim=64, intermediate_size=128)
JCFG, TCFG = JArgs(**CFG_KW), TArgs(**CFG_KW)
B, PREFIX, MAX_NEW, SINK = 2, 64, 24, 4
ENGINE_KW = dict(batch_size=B, max_len=256, prefill_chunk=32)


@pytest.fixture(scope="module")
def jparams():
    return j_init(jax.random.PRNGKey(0), JCFG, jnp.float32, scale=0.5)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(7).integers(0, JCFG.vocab_size,
                                             size=(B, PREFIX)).astype(np.int32)


@pytest.fixture(scope="module")
def ar_tokens(tparams, prompt):
    eng = TEngine(TCFG, tparams, device="cpu", **ENGINE_KW)
    return generate_autoregressive(eng, prompt, MAX_NEW)[0].numpy()


def _full_budget(gamma):
    return PREFIX + MAX_NEW + gamma + 4


# (gamma, budget, draft_headroom): full budget and budget 32 at gamma 1 and
# 3, and budget 32 with 16 headroom slots, where the window compacts
STREAMING_CASES = [(1, "full", 64), (3, "full", 64), (1, 32, 64), (3, 32, 64),
                   (3, 32, 16)]


@pytest.mark.parametrize("gamma,budget,headroom", STREAMING_CASES)
def test_streaming_stream_equals_jax_and_ar(jparams, tparams, prompt,
                                            ar_tokens, gamma, budget,
                                            headroom):
    budget = _full_budget(gamma) if budget == "full" else budget
    kw = dict(spec="streaming", draft_budget=budget, sink_size=SINK,
              draft_headroom=headroom, **ENGINE_KW)
    eng = TEngine(TCFG, tparams, device="cpu", **kw)
    out, counts, stats = t_spec(eng, prompt, gamma=gamma,
                                max_new_tokens=MAX_NEW)
    out, counts = out.numpy(), counts.numpy()
    jout, jcounts, jstats = j_spec(JEngine(JCFG, jparams, **kw),
                                   jnp.asarray(prompt), gamma=gamma,
                                   max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert stats.rounds == jstats.rounds
    assert stats.total_accepted_drafts == jstats.total_accepted_drafts
    for b in range(B):                      # invariant 1: lossless
        n = min(counts[b], MAX_NEW)
        assert n > 0
        np.testing.assert_array_equal(out[b, :n], ar_tokens[b, :n])
    if budget == _full_budget(gamma):       # invariant 2: exactly 1.0
        assert stats.acceptance_rate == 1.0, stats
        assert int(eng.draft.evicted.max()) == 0
    if headroom == 16:                      # the window was compacted
        assert int(eng.draft.evicted.min()) > 0


def test_streaming_refeed_preserves_fresh_slots(tparams, prompt):
    """The round's T=2 re-feed must not overwrite the last accepted token's
    K/V when its slot is fresh (stale=False), and must write it when stale
    (the slot was never written): the port's counterpart of
    tests/test_selfspec.py's sentinel test."""
    budget, gamma = PREFIX + MAX_NEW + 16, 3
    for stale_flag in (False, True):
        eng = TEngine(TCFG, tparams, spec="streaming", draft_budget=budget,
                      sink_size=SINK, device="cpu", **ENGINE_KW)
        buffer0 = eng.encode(prompt)
        d = eng.draft
        d.lengths = d.lengths - 1
        slot = int(d.lengths[0])
        with torch.inference_mode():    # the draft holds inference tensors
            d.k[:, :, slot] = 7.25
        out = torch.zeros((B, MAX_NEW + 9), dtype=torch.int32)
        gc = torch.zeros(B, dtype=torch.int32)
        stale = torch.full((B,), stale_flag)
        streaming_round(eng.params, eng.config, eng.cache, d, buffer0,
                        torch.from_numpy(prompt[:, -1:]), stale, out, gc,
                        _eot_array(()), gamma, budget, eng.sink_size)
        kept = bool((d.k[:, :, slot] == 7.25).all())
        assert kept != stale_flag


def test_streaming_speculate_api_matches_the_round(tparams, prompt, ar_tokens):
    """Engine.speculate() steps on a full-budget streaming draft give the
    target's own greedy tokens, and compact_draft() below the trigger leaves
    the cache as it was."""
    gamma = 3
    eng = TEngine(TCFG, tparams, spec="streaming",
                  draft_budget=_full_budget(gamma), sink_size=SINK,
                  device="cpu", **ENGINE_KW)
    buf = [eng.encode(prompt)]
    assert eng.draft.lengths.tolist() == [PREFIX] * B
    for _ in range(gamma):
        buf.append(eng.speculate(buf[-1]))
    np.testing.assert_array_equal(torch.cat(buf, 1).numpy(),
                                  ar_tokens[:, :gamma + 1])
    k_before = eng.draft.k
    eng.compact_draft()
    assert eng.draft.k is k_before
