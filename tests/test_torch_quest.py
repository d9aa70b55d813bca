"""The port's Quest path on the CPU against the JAX package.

flash_decode_stacked_masked's plain version (and its wrapper's CPU path)
against the JAX kernel in Pallas interpret mode (tolerance 2e-5, the JAX
kernel tests' own), page_gather against the JAX kernel in interpret mode
(exactly), the page boxes (exactly), one round-opening draft step, and
generate_selfspec(spec="quest") token for token against the JAX package's.
float32, JAX matmuls at "highest" precision (conftest.py), TF32 off in
torch. The model and sizes are those of tests/test_quest.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.cache import KVCache as JKVCache
from magicdec_tpu.engine import quest as jquest
from magicdec_tpu.engine import retro as jretro
from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.spec import generate_selfspec as j_spec
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu.ops.pallas import flash_decode as jfd
from magicdec_tpu.ops.pallas import page_gather as jpg
from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import quest as tquest
from magicdec_tpu_torch.engine import retro as tretro
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                            generate_selfspec as t_spec)
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy
from magicdec_tpu_torch.ops import flash_decode as tfd
from magicdec_tpu_torch.ops.page_gather import page_gather, page_gather_plain

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-5, atol=2e-5)

# ---------------------------------------------------------------------------
# flash_decode_stacked_masked
# ---------------------------------------------------------------------------

L2, B4, Hkv4, G2, D16 = 2, 4, 4, 2, 16


def _masked_inputs(S, NS, T, seed, D=D16):
    """Stacked caches, q, a 70% colmask with tail bits 1, and the draft's
    bounds: row t of sequence b attends the top bits and tail columns
    [NS, NS + tail_len[b] + t + 1)."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((L2, B4, S, Hkv4 * D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((L2, B4, S, Hkv4 * D)).astype(np.float32)
    q = rng.standard_normal((B4, T, Hkv4 * G2, D)).astype(np.float32)
    colmask = (rng.random((L2, B4, 1, S)) < 0.7).astype(np.int32)
    colmask[..., NS:] = 1
    tail_len = np.asarray([40, 3, S - NS - T - 1, 17], np.int32)
    ns = np.full((B4, T), NS, np.int32)
    hi = (NS + tail_len[:, None] + np.arange(1, T + 1)[None, :]).astype(np.int32)
    return q, k, v, colmask, ns, hi


# the (S, NS, T) cases of tests/test_flash_decode.py at head_dim 16, and
# the second at head_dim 128 (the kernels' larger build)
MASKED_CASES = [pytest.param(256, 128, 1, D16, id="256-128-1"),
                pytest.param(264, 96, 2, D16, id="264-96-2"),
                pytest.param(264, 96, 2, 128, id="264-96-2-d128")]


@pytest.mark.parametrize("S,NS,T,D", MASKED_CASES)
def test_stacked_masked_plain_matches_jax_kernel(S, NS, T, D):
    q, k, v, cm, ns, hi = _masked_inputs(S, NS, T, seed=S + T, D=D)
    tt = [torch.from_numpy(x) for x in (q, k, v)]
    tcm, tns, thi = (torch.from_numpy(x) for x in (cm, ns, hi))
    for layer in range(L2):
        ref = jfd.flash_decode_stacked_masked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(layer),
            jnp.asarray(cm), jnp.asarray(ns), jnp.asarray(ns), jnp.asarray(hi),
            s_block=128, interpret=True)
        plain = tfd.stacked_masked_plain(*tt, layer, tcm, tns, tns, thi)
        np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)
        out = tfd.flash_decode_stacked_masked(*tt, layer, tcm, tns, tns, thi)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_stacked_masked_limit_is_the_decode_limit():
    """stacked_masked_plain_f32_and_limit: the decode kernels' limit on the
    masked plain version, and it rejects an output that ignores the bits
    (the kernel fault of treating every top-region tile as full)."""
    q, k, v, cm, ns, hi = (torch.from_numpy(x)
                           for x in _masked_inputs(256, 128, 1, seed=3))
    ref, limit = tfd.stacked_masked_plain_f32_and_limit(q, k, v, 1, cm, ns,
                                                        ns, hi)
    torch.testing.assert_close(ref, tfd.stacked_masked_plain(q, k, v, 1, cm,
                                                             ns, ns, hi))
    torch.testing.assert_close(limit, 2e-5 + 2e-5 * ref.abs())
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref_b, limit_b = tfd.stacked_masked_plain_f32_and_limit(qb, kb, vb, 1, cm,
                                                            ns, ns, hi)
    ref_abs = tfd.stacked_masked_plain(qb.float(), kb.float(),
                                       vb.float().abs(), 1, cm, ns, ns, hi)
    torch.testing.assert_close(
        limit_b, 1.1 * 2.0 ** -8 * (ref_b.abs() + ref_abs) + 1e-5)
    ignored = tfd.stacked_masked_plain(q, k, v, 1, torch.ones_like(cm), ns,
                                       ns, hi)
    assert not bool(((ignored - ref).abs() <= limit).all())


# ---------------------------------------------------------------------------
# page_gather
# ---------------------------------------------------------------------------

def _gather_inputs():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 512, 128)).astype(np.float32)
    v = rng.standard_normal((2, 3, 512, 128)).astype(np.float32)
    # repeated and out-of-order pages
    pages = np.asarray([[0, 3], [2, 2], [1, 0]], np.int32)
    return k, v, pages


def test_page_gather_matches_jax_kernel():
    k, v, pages = _gather_inputs()
    tk, tv, tp = (torch.from_numpy(x) for x in (k, v, pages))
    for layer in (0, 1):
        jk, jv = jpg.page_gather(jnp.asarray(k), jnp.asarray(v),
                                 jnp.int32(layer), jnp.asarray(pages),
                                 page=128, interpret=True)
        ks, vs = page_gather(tk, tv, layer, tp, 128)
        np.testing.assert_array_equal(ks.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(vs.numpy(), np.asarray(jv))


def test_page_gather_writes_into_a_round_buffer_view():
    """out= views of a round buffer's top region at one layer receive the
    pages; the rest of the buffer is untouched."""
    k, v, pages = (torch.from_numpy(x) for x in _gather_inputs())
    bufk = torch.full((2, 3, 256 + 64, 128), 7.0)
    bufv = torch.full((2, 3, 256 + 64, 128), 7.0)
    out = page_gather(k, v, 1, pages, 128,
                      out=(bufk[1, :, :256].view(3, 2, 128, 128),
                           bufv[1, :, :256].view(3, 2, 128, 128)))
    ks, vs = page_gather_plain(k, v, 1, pages, 128)
    assert torch.equal(bufk[1, :, :256].reshape(3, 2, 128, 128), ks)
    assert torch.equal(bufv[1, :, :256].reshape(3, 2, 128, 128), vs)
    assert out[0].data_ptr() == bufk[1].data_ptr()
    assert bool((bufk[0] == 7).all() and (bufk[1, :, 256:] == 7).all())


# ---------------------------------------------------------------------------
# page boxes
# ---------------------------------------------------------------------------

def _caches(L, B, S, HD, lengths, seed):
    k = np.random.default_rng(seed).standard_normal((L, B, S, HD)).astype(
        np.float32)
    lengths = np.asarray(lengths, np.int32)
    jc = JKVCache(jnp.asarray(k), jnp.zeros_like(jnp.asarray(k)),
                  jnp.asarray(lengths))
    tc = KVCache(torch.from_numpy(k), torch.zeros(k.shape),
                 torch.from_numpy(lengths))
    return jc, tc


def test_make_page_meta_matches_jax():
    """A full page, a partly valid one and an empty one."""
    jc, tc = _caches(2, 2, 256, 8, [200, 128], seed=0)
    for jx, tx in zip(jquest.make_page_meta(jc, page=128),
                      tquest.make_page_meta(tc, page=128)):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_update_page_meta_matches_jax():
    """The boxes of the pages from span_start on, after the sequences grew;
    one span start near the end of the cache (the window is clipped)."""
    jc, tc = _caches(2, 3, 768, 8, [300, 420, 700], seed=1)
    jmin, jmax = jquest.make_page_meta(jc, page=128)
    tmin, tmax = tquest.make_page_meta(tc, page=128)
    k2 = np.asarray(jc.k).copy()
    k2[:, 0, 300:304] = 9.0
    k2[:, 1, 420:424] = -9.0
    grown = np.asarray([304, 424, 704], np.int32)
    jc2 = JKVCache(jnp.asarray(k2), jc.v, jnp.asarray(grown))
    tc2 = KVCache(torch.from_numpy(k2), tc.v, torch.from_numpy(grown))
    span_start = np.asarray([300, 150, 690], np.int32)
    jmin, jmax = jquest.update_page_meta(jc2, jmin, jmax,
                                         jnp.asarray(span_start), 160,
                                         page=128)
    tquest.update_page_meta(tc2, tmin, tmax, torch.from_numpy(span_start),
                            160, page=128)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))


# ---------------------------------------------------------------------------
# the round buffer: init_tail, tail_compact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [[300, 70], [40, 250]])
def test_init_tail_and_tail_compact_match_jax(lengths):
    """The tail filled from the cache (a prefix shorter than keep included),
    then grown past the trigger by one sequence and shifted: every
    sequence keeps its newest keep rows."""
    NS, Wcap, keep = 64, 48, 32
    jc, tc = _caches(2, 2, 384, 8, lengths, seed=2)
    jt = jretro.init_tail(jc, NS, Wcap, keep)
    tt = tretro.init_tail(tc, NS, Wcap, keep)
    for t, j in zip(tt, jt):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    grown = np.asarray([45, 20], np.int32)
    jk, jv, jlen, jbase = jretro.tail_compact(
        jt[0], jt[1], jnp.asarray(grown), jt[4], NS=NS, keep=keep,
        trigger=Wcap - 5)
    tlen, tbase = tretro.tail_compact(tt[0], tt[1], torch.from_numpy(grown),
                                      tt[4], NS=NS, keep=keep)
    for t, j in ((tt[0], jk), (tt[1], jv), (tlen, jlen), (tbase, jbase)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tlen.tolist() == [keep, 20]


# ---------------------------------------------------------------------------
# one round-opening draft step
# ---------------------------------------------------------------------------

def test_roundtail_select_attn_step_matches_jax():
    """Score, select, gather, stamp the colmask, append to the tail, attend:
    sequence 0 has more scoreable pages than it selects, sequence 1 fewer
    (one page slot is a NEG_INF tie, invalid whatever index it holds)."""
    kw = dict(block_size=512, vocab_size=64, n_layer=1, n_head=4, n_kv_head=2,
              dim=64)
    jcfg, tcfg = JArgs(**kw), TArgs(**kw)
    Bq, S, page, n_pages, Wcap, Hkv, D, Hq = 2, 256, 16, 3, 32, 2, 16, 4
    NS = n_pages * page
    rng = np.random.default_rng(5)
    ck = rng.standard_normal((1, Bq, S, Hkv * D)).astype(np.float32)
    cv = rng.standard_normal((1, Bq, S, Hkv * D)).astype(np.float32)
    q = rng.standard_normal((Bq, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, 1, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, 1, Hkv, D)).astype(np.float32)
    tail_base = np.asarray([150, 20], np.int32)
    tail_len = np.asarray([20, 9], np.int32)
    lens = tail_base + tail_len
    bufk = rng.standard_normal((1, Bq, NS + Wcap, Hkv * D)).astype(np.float32)
    bufv = rng.standard_normal((1, Bq, NS + Wcap, Hkv * D)).astype(np.float32)
    cm = np.ones((1, Bq, 1, NS + Wcap), np.int32)
    cm[..., :NS] = 0

    jc = JKVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lens))
    jmin, jmax = jquest.make_page_meta(jc, page=page)
    jsel = jquest.quest_select_gather_fn(jcfg, jmin, jmax,
                                         jnp.asarray(tail_base),
                                         n_pages=n_pages, page=page)
    jimpl = jretro.roundtail_select_attn(jcfg, jnp.asarray(lens),
                                         jnp.asarray(tail_len),
                                         jnp.asarray(tail_base), jsel, NS=NS)
    jctx, (_, _, jbk, jbv, jcm) = jimpl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        (jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(bufk),
         jnp.asarray(bufv), jnp.asarray(cm)), jnp.int32(0))

    tc = KVCache(torch.from_numpy(ck), torch.from_numpy(cv),
                 torch.from_numpy(lens))
    tmin, tmax = tquest.make_page_meta(tc, page=page)
    ttb = torch.from_numpy(tail_base)
    tsel = tquest.quest_select_gather_fn(tcfg, tmin, tmax, ttb,
                                         n_pages=n_pages, page=page)
    tbk, tbv, tcm = (torch.from_numpy(x.copy()) for x in (bufk, bufv, cm))
    timpl = tretro.roundtail_select_attn(tcfg, torch.from_numpy(lens),
                                         torch.from_numpy(tail_len), ttb,
                                         tsel, NS=NS)
    tctx = timpl(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 (tc.k, tc.v, tbk, tbv, tcm), 0)

    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    assert tcm[0, 1, 0, :NS].sum() < tcm[0, 0, 0, :NS].sum()  # an invalid page
    live = np.asarray(jcm)[:, :, 0] > 0     # [1, B, R]: the attended rows
    for t_buf, j_buf in ((tbk, jbk), (tbv, jbv)):
        np.testing.assert_allclose(t_buf.numpy()[live], np.asarray(j_buf)[live],
                                   **TOL)


# ---------------------------------------------------------------------------
# generate_selfspec(spec="quest") against the JAX package's
# ---------------------------------------------------------------------------

JCFG, TCFG = JArgs.from_name("test-tiny"), TArgs.from_name("test-tiny")
B, P, GAMMA = 2, 512, 3
# 48 new tokens: the tails pass the compaction trigger (128 + 8*5 - 5 =
# 163 rows) before the end, so both runs compact once
NEW = 48
ENGINE_KW = dict(batch_size=B, max_len=P + NEW + GAMMA + 16, prefill_chunk=128)


@pytest.fixture(scope="module")
def jparams():
    return j_init(jax.random.PRNGKey(0), JCFG, jnp.float32, scale=0.3)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, JCFG.vocab_size,
                                             size=(B, P)).astype(np.int32)


@pytest.fixture(scope="module")
def ar_tokens(tparams, prompt):
    eng = TEngine(TCFG, tparams, device="cpu", **ENGINE_KW)
    return generate_autoregressive(eng, prompt, NEW)[0].numpy()


@pytest.mark.parametrize("budget", [P + 128, 256])
def test_quest_stream_equals_jax_and_ar(jparams, tparams, prompt, ar_tokens,
                                        budget):
    kw = dict(spec="quest", draft_budget=budget, latest_k=128, **ENGINE_KW)
    eng = TEngine(TCFG, tparams, device="cpu", **kw)
    out, counts, stats = t_spec(eng, prompt, gamma=GAMMA, max_new_tokens=NEW)
    out, counts = out.numpy(), counts.numpy()
    jout, jcounts, jstats = j_spec(JEngine(JCFG, jparams, **kw),
                                   jnp.asarray(prompt), gamma=GAMMA,
                                   max_new_tokens=NEW)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert stats.rounds == jstats.rounds
    assert stats.total_accepted_drafts == jstats.total_accepted_drafts
    assert stats.compactions >= 1
    for b in range(B):                      # invariant 1: lossless
        n = min(counts[b], NEW)
        assert n > 0
        np.testing.assert_array_equal(out[b, :n], ar_tokens[b, :n])
    if budget == P + 128:                   # full coverage
        assert stats.acceptance_rate >= 0.9, stats


def test_quest_rejects_a_budget_below_the_tail(tparams, prompt):
    eng = TEngine(TCFG, tparams, spec="quest", draft_budget=200, latest_k=128,
                  device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="latest_k"):
        t_spec(eng, prompt, gamma=GAMMA, max_new_tokens=NEW)
    with pytest.raises(ValueError, match="generate_selfspec"):
        eng.speculate(torch.zeros((B, 1), dtype=torch.int32))
