"""The port's GliDe speculation on the CPU against the JAX package.

The return_lse plain versions of the decode kernels against the JAX
kernels' return_lse outputs in Pallas interpret mode (tolerance 2e-5, the
JAX kernel tests' own; ctx and m compared where the row is not empty),
masked_attention_lse and merge_lse, SpecTree and _tree_mask, glide_forward
on its dense, flash-linear and flash-tree routes (the JAX flash routes in
interpret mode), one greedy tree round on the flash route, and the linear
and tree streams of GlideEngine.generate token for token against the JAX
engine's and the port's AR stream. Then the compaction's drop of writes
past the cache end (the JAX package clamps them onto live slots), and the
stochastic verifiers' distributions, as tests/test_glide.py checks them but
in one vectorised call over thousands of rows. float32, JAX matmuls at
"highest" precision (conftest.py), TF32 off in torch; the model and sizes
are those of tests/test_glide.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine import glide_engine as jge
from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.models import glide as jglide
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu.ops import attention as jatt
from magicdec_tpu.ops.pallas import flash_decode as jfd
from magicdec_tpu_torch.engine import glide_engine as tge
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import _eot_array, generate_autoregressive
from magicdec_tpu_torch.models import glide as tglide
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy
from magicdec_tpu_torch.ops import attention as tatt
from magicdec_tpu_torch.ops import flash_decode as tfd

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-5, atol=2e-5)
JCFG, TCFG = JArgs.from_name("test-tiny"), TArgs.from_name("test-tiny")
B, P, NEW = 2, 256, 24


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the return_lse forms, masked_attention_lse, merge_lse
# ---------------------------------------------------------------------------

def _assert_lse_close(got, ref):
    """(ctx, m, l) of the port against the JAX kernel's: ctx and m where the
    row is not empty (the JAX kernel's empty-row ctx is 0/0), l everywhere,
    l == 0 exactly on empty rows and the port's ctx 0 there."""
    ctx, m, l = (x.numpy() for x in got)
    rctx, rm, rl = (_np(x) for x in ref)
    live = rl > 0
    np.testing.assert_allclose(l, rl, **TOL)
    assert (l[~live] == 0).all() and (ctx[~live] == 0).all()
    np.testing.assert_allclose(m[live], rm[live], **TOL)
    np.testing.assert_allclose(ctx[live], rctx[live], **TOL)


@pytest.mark.parametrize("T,D", [pytest.param(1, 16, id="1"),
                                 pytest.param(4, 16, id="4"),
                                 pytest.param(4, 128, id="4-d128")])
def test_stacked_lse_plain_matches_jax_kernel(T, D):
    """attention_plain_lse (and the wrapper's CPU path) against
    flash_decode_stacked(return_lse=True) in interpret mode: ragged rows, a
    partial last block (s_block=128), one empty row; head_dim 16 and 128."""
    L, Bk, S, Hkv, G = 2, 4, 264, 2, 2
    rng = np.random.default_rng(T)
    k = (rng.standard_normal((L, Bk, S, Hkv * D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((L, Bk, S, Hkv * D)).astype(np.float32)
    q = rng.standard_normal((Bk, T, Hkv * G, D)).astype(np.float32)
    valid = (np.asarray([200, 263 - T, 3, 129])[:, None]
             + np.arange(1, T + 1)[None, :]).astype(np.int32)
    valid[2, 0] = 0
    for layer in range(L):
        ref = jfd.flash_decode_stacked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.int32(layer),
                                       jnp.asarray(valid), s_block=128,
                                       interpret=True, return_lse=True)
        got = tfd.flash_decode_stacked(_t(q), _t(k), _t(v), layer, _t(valid),
                                       return_lse=True)
        _assert_lse_close(got, ref)


@pytest.mark.parametrize("T,D", [pytest.param(1, 16, id="1"),
                                 pytest.param(3, 16, id="3"),
                                 pytest.param(3, 128, id="3-d128")])
def test_intervals_lse_plain_matches_jax_kernel(T, D):
    """intervals_plain_lse against flash_decode_intervals(return_lse=True)
    in interpret mode: sink + gap + window rows, a prefix-only row (the
    glide tree draft's [0, tree_base)) and one empty row; head_dim 16 and
    128."""
    Bk, S, Hkv, G = 4, 300, 2, 2
    rng = np.random.default_rng(10 + T)
    k = (rng.standard_normal((Bk, S, Hkv * D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((Bk, S, Hkv * D)).astype(np.float32)
    q = rng.standard_normal((Bk, T, Hkv * G, D)).astype(np.float32)
    t = np.arange(T)[None, :]
    a = np.broadcast_to(np.asarray([16, 0, 16, 0])[:, None], (Bk, T))
    lo = np.broadcast_to(np.asarray([100, 0, 200, 0])[:, None], (Bk, T))
    hi = np.asarray([250, 140, 296 - T, 0])[:, None] + t * np.asarray(
        [1, 0, 1, 0])[:, None]
    rows = [np.ascontiguousarray(x, np.int32) for x in (a, lo, hi)]
    ref = jfd.flash_decode_intervals(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v),
                                     *(jnp.asarray(r) for r in rows),
                                     s_block=128, interpret=True,
                                     return_lse=True)
    got = tfd.flash_decode_intervals(_t(q), _t(k), _t(v),
                                     *(_t(r) for r in rows), return_lse=True)
    _assert_lse_close(got, ref)
    assert (got[2][3].numpy() == 0).all()          # the empty row


def test_masked_attention_lse_and_merge_match_jax():
    """Both functions on the same inputs as the JAX package's; an empty-mask
    row gives m = NEG_INF, l = 0, ctx = 0; the merge of two disjoint halves
    is one attention over their union, and a merge with an empty part is
    finite."""
    Bq, T, S, Hkv, G, D = 2, 3, 40, 2, 2, 16
    rng = np.random.default_rng(0)
    q = rng.standard_normal((Bq, T, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    mask = rng.random((Bq, T, S)) < 0.6
    mask[1, 2] = False
    half = np.arange(S) < 17
    parts = []
    for mk in (mask & half, mask & ~half):
        ref = jatt.masked_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(mk))
        got = tatt.masked_attention_lse(_t(q), _t(k), _t(v), _t(mk))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
        assert float(got[2][1, 2].max()) == 0.0
        assert (got[1][1, 2] == tatt.NEG_INF).all()
        assert (got[0][1, 2] == 0).all()
        parts.append((got, ref))
    (ga, ra), (gb, rb) = parts
    merged = tatt.merge_lse(*ga, *gb)
    np.testing.assert_allclose(merged.numpy(),
                               _np(jatt.merge_lse(*ra, *rb)), **TOL)
    whole = tatt.masked_attention_general(_t(q), _t(k), _t(v), _t(mask))
    live = mask.any(-1)
    np.testing.assert_allclose(merged.numpy()[live], whole.numpy()[live],
                               **TOL)
    assert torch.isfinite(merged).all()


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branching", [(2, 3), (2, 2), (4, 2, 2)])
def test_spec_tree_and_tree_mask_match_jax(branching):
    jt, tt = jge.SpecTree(branching), tge.SpecTree(branching)
    assert tt.n_nodes == jt.n_nodes
    for name in ("parents", "depth", "ancestor"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    for a, b in zip(tt.levels, jt.levels):
        np.testing.assert_array_equal(a, b)
    base = np.asarray([5, 37], np.int32)
    lvl = tt.levels[1]
    for anc in (tt.ancestor, tt.ancestor[lvl]):
        ref = jge._tree_mask(jnp.asarray(anc), jnp.asarray(base), tt.n_nodes,
                             64)
        got = tge._tree_mask(anc, _t(base), tt.n_nodes, 64)
        np.testing.assert_array_equal(got.numpy(), _np(ref))
    if branching == (2, 3):
        assert tt.parents.tolist() == [-1, 0, 0, 1, 1, 1, 2, 2, 2]


# ---------------------------------------------------------------------------
# the glide block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jp = j_init(jax.random.PRNGKey(0), JCFG, jnp.float32, scale=0.3)
    jg = jglide.init_glide_params(jax.random.PRNGKey(5), JCFG, scale=0.3)
    to_np = (lambda tree: jax.tree_util.tree_map(np.asarray, tree))
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, size=(B, P)).astype(np.int32)
    return dict(jp=jp, jg=jg, tp=params_from_numpy(to_np(jp), device="cpu"),
                tg=params_from_numpy(to_np(jg), device="cpu"), prompt=prompt)


def test_params_from_numpy_carries_glide_params(models):
    """The flat glide dict in the JAX layout (w_gate_up [D, 2, I]) comes
    across key for key and bit for bit; init_glide_params makes the same
    keys, shapes and dtype."""
    jg, tg = models["jg"], models["tg"]
    assert set(tg) == set(jg)
    for key, val in jg.items():
        np.testing.assert_array_equal(tg[key].numpy(), _np(val))
    mine = tglide.init_glide_params(TCFG, torch.bfloat16, scale=0.3, seed=5,
                                    device="cpu")
    assert {k_: tuple(v_.shape) for k_, v_ in mine.items()} == {
        k_: tuple(v_.shape) for k_, v_ in jg.items()}
    assert all(v_.dtype == torch.bfloat16 for v_ in mine.values())
    assert torch.equal(mine["w_down"], tglide.init_glide_params(
        TCFG, torch.bfloat16, scale=0.3, seed=5, device="cpu")["w_down"])


def _glide_inputs(seed, T, Sd=320, S=320):
    """Caches of both packages' glide_forward: an own cache holding 200
    entries per sequence and a target last layer of 260 verified slots."""
    rng = np.random.default_rng(seed)
    HD = JCFG.n_kv_head * JCFG.head_dim
    own = [(rng.standard_normal((B, Sd, HD)) * 0.5).astype(np.float32)
           for _ in range(2)]
    tgt = [(rng.standard_normal((B, S, HD)) * 0.5).astype(np.float32)
           for _ in range(2)]
    toks = rng.integers(0, JCFG.vocab_size, (B, T)).astype(np.int32)
    own_len = np.asarray([200, 190], np.int32)
    pos = (np.asarray([260, 250])[:, None] + np.arange(T)[None, :]).astype(
        np.int32)
    valid = np.broadcast_to(np.asarray([260, 250], np.int32)[:, None],
                            (B, T)).copy()
    return own, tgt, toks, own_len, pos, valid


@pytest.mark.parametrize("route", ["dense", "dense_mask", "flash_linear",
                                   "flash_tree"])
def test_glide_forward_routes_match_jax(models, route):
    """Logits within 2e-5 of the JAX package's same route (its flash routes
    in interpret mode) and the own caches equal within 2e-5 (their K/V are
    products of the same operands)."""
    tree = tge.SpecTree((4, 2, 2))
    lvl = tree.levels[2]
    T = len(lvl) if route != "dense" else 3
    own, tgt, toks, own_len, pos, valid = _glide_inputs(7, T)
    base = own_len
    j_kw, t_kw = {}, {}
    if route == "dense_mask":
        anc = tree.ancestor[lvl]
        j_kw = dict(attn_mask=jge._tree_mask(jnp.asarray(anc),
                                             jnp.asarray(base), tree.n_nodes,
                                             own[0].shape[1]))
        t_kw = dict(attn_mask=tge._tree_mask(anc, _t(base), tree.n_nodes,
                                             own[0].shape[1]))
    elif route == "flash_linear":
        j_kw = t_kw = dict(use_flash=True)
    elif route == "flash_tree":
        anc = tree.ancestor[lvl]
        j_kw = dict(use_flash=True, tree=(anc, jnp.asarray(base)))
        t_kw = dict(use_flash=True, tree=(anc, _t(base)))
    start = own_len + (int(lvl[0]) if route in ("dense_mask", "flash_tree")
                       else 0)
    jl, jk, jv = jglide.glide_forward(
        models["jg"], models["jp"], JCFG, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(own[0]), jnp.asarray(own[1]), jnp.asarray(start),
        jnp.asarray(tgt[0]), jnp.asarray(tgt[1]), jnp.asarray(valid), **j_kw)
    tk, tv = _t(own[0]), _t(own[1])
    tl = tglide.glide_forward(models["tg"], models["tp"], TCFG, _t(toks),
                              _t(pos), tk, tv, _t(start), _t(tgt[0]),
                              _t(tgt[1]), _t(valid), **t_kw)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)


def test_glide_forward_prefill_chunk_flash_route(models):
    """A 128-token glide prefill chunk (T*G > 64) on the flash route takes
    the prefill kernel's plain version for both attentions and gives the
    dense route's logits."""
    own, tgt, toks, own_len, _, _ = _glide_inputs(3, 128)
    pos = (own_len[:, None] + np.arange(128)[None, :]).astype(np.int32)
    outs = []
    for flash in (False, True):
        tk, tv = _t(own[0]), _t(own[1])
        outs.append(tglide.glide_forward(
            models["tg"], models["tp"], TCFG, _t(toks), _t(pos), tk, tv,
            _t(own_len), _t(tgt[0]), _t(tgt[1]), _t(pos + 1), use_flash=flash))
    torch.testing.assert_close(outs[1], outs[0], rtol=2e-5, atol=2e-5)


def _engines(models, max_len, tree=None):
    target = TEngine(TCFG, models["tp"], batch_size=B, max_len=max_len,
                     prefill_chunk=128, kv_dtype=torch.float32, device="cpu")
    jtarget = JEngine(JCFG, models["jp"], batch_size=B, max_len=max_len,
                      prefill_chunk=128, kv_dtype=jnp.float32)
    return tge.GlideEngine(target, models["tg"]), jge.GlideEngine(
        jtarget, models["jg"])


def test_greedy_tree_round_flash_route_matches_jax(models):
    """One greedy tree (2,2) round on the flash route (the port's plain
    versions; the JAX kernels in interpret mode) after both encodes: the
    same emitted tokens, emit_len and bonus, and the same caches (within
    1e-4)."""
    tree_t, tree_j = tge.SpecTree((2, 2)), jge.SpecTree((2, 2))
    t_eng, j_eng = _engines(models, P + NEW + 8 * tree_t.n_nodes)
    root_t = t_eng.encode(models["prompt"])
    root_j = j_eng.encode(jnp.asarray(models["prompt"]))
    np.testing.assert_array_equal(root_t.numpy(), _np(root_j))
    np.testing.assert_allclose(t_eng.own_k.numpy(), _np(j_eng.own_k), **TOL)
    eot_t, eot_j = _eot_array(()), jnp.asarray([-1, -1], jnp.int32)
    tc = t_eng.target.cache
    own_len, emitted, emit_len, bonus, _ = tge.glide_tree_round(
        models["tp"], models["tg"], TCFG, tree_t, tc, t_eng.own_k,
        t_eng.own_v, t_eng.own_len, root_t, eot_t, use_flash=True)
    (jc, jk, jv, jlen, jemit, jel, jbonus, _) = jge.glide_tree_round(
        models["jp"], models["jg"], JCFG, tree_j, j_eng.target.cache,
        j_eng.own_k, j_eng.own_v, j_eng.own_len, root_j, eot_j,
        use_flash=True)
    np.testing.assert_array_equal(emitted.numpy(), _np(jemit))
    np.testing.assert_array_equal(emit_len.numpy(), _np(jel))
    np.testing.assert_array_equal(bonus.numpy(), _np(jbonus))
    np.testing.assert_array_equal(own_len.numpy(), _np(jlen))
    np.testing.assert_array_equal(tc.lengths.numpy(), _np(jc.lengths))
    # K/V entries reach ~10: the f32 products of the two packages, summed in
    # other orders, differ by up to ~5e-5 there
    for a, b in ((t_eng.own_k, jk), (t_eng.own_v, jv), (tc.k, jc.k),
                 (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=2e-5, atol=1e-4)


@pytest.fixture(scope="module")
def ar_stream(models):
    eng = TEngine(TCFG, models["tp"], batch_size=B, max_len=P + NEW + 16,
                  prefill_chunk=128, device="cpu")
    out, _ = generate_autoregressive(eng, models["prompt"], NEW)
    return out.numpy()


@pytest.mark.parametrize("branching", [None, (2, 2), (4, 2, 2)])
def test_glide_streams_match_jax_and_ar(models, ar_stream, branching):
    """GlideEngine.generate, linear (gamma 3) and greedy tree: the output,
    counts, rounds and accepted drafts equal the JAX engine's, and the
    stream is the AR stream (invariant 1; exact for the tree in float32)."""
    tt = None if branching is None else tge.SpecTree(branching)
    jt = None if branching is None else jge.SpecTree(branching)
    max_len = P + NEW + (24 if tt is None else 8 * tt.n_nodes)
    t_eng, j_eng = _engines(models, max_len)
    out, counts, stats = t_eng.generate(models["prompt"], NEW, gamma=3,
                                        tree=tt)
    jout, jcounts, jstats = j_eng.generate(jnp.asarray(models["prompt"]), NEW,
                                           gamma=3, tree=jt)
    np.testing.assert_array_equal(counts.numpy(), _np(jcounts))
    np.testing.assert_array_equal(out.numpy(), _np(jout))
    assert (stats.rounds, stats.total_accepted_drafts) == (
        jstats.rounds, jstats.total_accepted_drafts)
    n = min(int(counts.min()), NEW)
    np.testing.assert_array_equal(out.numpy()[:, :n], ar_stream[:, :n])
    assert int(t_eng.own_len[0]) == int(t_eng.target.cache.lengths[0])


def test_glide_engine_refuses_a_small_own_cache(models):
    target = TEngine(TCFG, models["tp"], batch_size=B, max_len=P + 64,
                     device="cpu")
    with pytest.raises(ValueError, match="own_capacity"):
        tge.GlideEngine(target, models["tg"], own_capacity=P)


def test_compact_path_drops_writes_past_the_cache_end():
    """base + depth + 1 > capacity: the path rows whose destination lies
    past the end are dropped and every live prefix row keeps its bits, in
    the flat and the stacked layout (the JAX package's per-3 write clamps
    the slice start and overwrites live prefix rows). A row in range still
    moves."""
    rng = np.random.default_rng(2)
    S, HD = 16, 8
    flat = torch.from_numpy(rng.standard_normal((2, S, HD)).astype(np.float32))
    stacked = torch.from_numpy(rng.standard_normal((3, 2, S, HD)).astype(
        np.float32))
    base = torch.tensor([14, 5], dtype=torch.int32)    # row 0: 14 + 3 > 16
    path = torch.tensor([[0, 1, 1], [0, 2, 6]])
    before = (flat.clone(), stacked.clone())
    tge._compact_path((flat,), base, path)
    tge._compact_path((stacked,), base, path)
    for got, was in [(flat, before[0])] + [(stacked[l], before[1][l])
                                           for l in range(3)]:
        assert torch.equal(got[0, :16], was[0, :16])   # slots 14, 15 keep
        assert torch.equal(got[1, :6], was[1, :6])     # their nodes (path
        assert torch.equal(got[1, 6], was[1, 7])       # 0, 1); 16 dropped
        assert torch.equal(got[1, 7], was[1, 11])
    # the JAX package's flat write clamps: it overwrites prefix slot 13
    jflat = jge._compact_path((jnp.asarray(before[0].numpy()),),
                              jnp.asarray(base.numpy()),
                              jnp.asarray(path.numpy(), jnp.int32),
                              jnp.asarray([3, 3]))[0]
    assert not np.array_equal(_np(jflat)[0, :14], before[0].numpy()[0, :14])


# ---------------------------------------------------------------------------
# stochastic verification
# ---------------------------------------------------------------------------

def test_stochastic_verify_edge_cases():
    """Identical distributions accept every token; disjoint ones reject the
    first and draw the replacement from the target."""
    g = torch.Generator().manual_seed(0)
    V, G = 16, 4
    p = torch.softmax(torch.randn((B, G, V), generator=g), -1)
    toks = torch.randint(0, V, (B, G), generator=g, dtype=torch.int32)
    acc, _, has = tge.stochastic_verify(g, p, p, toks)
    assert acc.tolist() == [G, G] and not has.any()
    dp = torch.zeros((B, 3, 8))
    dp[..., 0] = 1.0
    tp = torch.zeros((B, 3, 8))
    tp[..., 5] = 1.0
    acc, repl, has = tge.stochastic_verify(g, dp, tp,
                                           torch.zeros((B, 3), dtype=torch.int32))
    assert acc.tolist() == [0, 0] and has.all() and repl.tolist() == [5, 5]


def test_stochastic_verify_marginal_matches_target():
    """Over 3000 rows in one call, the emitted first token's frequencies
    equal the target distribution (atol 0.04, tests/test_glide.py's)."""
    g = torch.Generator().manual_seed(1)
    n, V = 3000, 4
    dp = torch.tensor([0.7, 0.1, 0.1, 0.1]).expand(n, 1, V)
    tp = torch.tensor([0.4, 0.3, 0.2, 0.1]).expand(n, 1, V)
    tok = torch.multinomial(dp[:, 0], 1, generator=g).to(torch.int32)
    acc, repl, _ = tge.stochastic_verify(g, dp, tp, tok)
    emitted = torch.where(acc == 1, tok[:, 0], repl)
    freq = torch.bincount(emitted.long(), minlength=V).double() / n
    np.testing.assert_allclose(freq.numpy(), tp[0, 0].numpy(), atol=0.04)


def test_stochastic_tree_walk_marginal_matches_target():
    """Depth-1 tree with 2 sampled children, 4000 rows in one call: the
    emitted first token's frequencies equal the target distribution (atol
    0.035, tests/test_glide.py's)."""
    g = torch.Generator().manual_seed(2)
    n, V = 4000, 4
    tree = tge.SpecTree((2,))
    q = torch.tensor([0.7, 0.1, 0.1, 0.1])
    p = torch.tensor([0.4, 0.3, 0.2, 0.1])
    draws = torch.multinomial(q.expand(n, V), 2, replacement=True,
                              generator=g).to(torch.int32)
    node_tokens = torch.cat([torch.zeros((n, 1), dtype=torch.int32), draws], 1)
    path, emit_len, bonus = tge.stochastic_tree_walk(
        g, tree, node_tokens, p.expand(n, tree.n_nodes, V),
        q.expand(n, tree.n_nodes, V))
    child = torch.gather(node_tokens, 1, path[:, 1:2])[:, 0]
    emitted = torch.where(emit_len == 2, child, bonus[:, 0])
    freq = torch.bincount(emitted.long(), minlength=V).double() / n
    np.testing.assert_allclose(freq.numpy(), p.numpy(), atol=0.035)


@pytest.mark.parametrize("use_flash", [False, True])
def test_stochastic_tree_round_runs_and_is_plausible(models, use_flash):
    """One stochastic tree (2,2) round after encode, on both routes:
    shapes, 1 <= emit_len <= depth + 1, the emitted path starts at the root,
    and both cache lengths advance by emit_len."""
    tree = tge.SpecTree((2, 2))
    t_eng, _ = _engines(models, P + NEW + 8 * tree.n_nodes)
    root = t_eng.encode(models["prompt"])
    cache = t_eng.target.cache
    own_len, emitted, emit_len, bonus, _ = tge.glide_tree_round_stochastic(
        models["tp"], models["tg"], TCFG, tree, cache, t_eng.own_k,
        t_eng.own_v, t_eng.own_len, root, _eot_array(()),
        torch.Generator().manual_seed(3), use_flash=use_flash)
    assert emitted.shape == (B, 3) and bonus.shape == (B, 1)
    el = emit_len.numpy()
    assert ((1 <= el) & (el <= 3)).all()
    assert torch.equal(emitted[:, 0], root[:, 0])
    np.testing.assert_array_equal(cache.lengths.numpy(), P + el)
    np.testing.assert_array_equal(own_len.numpy(), P + el)


# ---------------------------------------------------------------------------
# the row bucket (C1): every decode-phase forward of a batch, one shape
# ---------------------------------------------------------------------------

def test_row_bucket_is_fixed_by_the_batch(models, monkeypatch):
    """llama.row_bucket gives every forward of at most DECODE_ROWS_PER_SEQ
    tokens a sequence (AR and draft steps, a verify, the tree (4,2,2)
    verify's 29 nodes) B * 32 rows rounded up to 64, and a prefill chunk
    B * T; llama.forward runs every weight product at that row count (the
    last_only unembedding too)."""
    from magicdec_tpu_torch.engine import attention_impls as impls
    from magicdec_tpu_torch.models import llama

    assert llama.DECODE_ROWS_PER_SEQ == 32
    for b in (2, 8, 16):
        want = -(-b * 32 // 64) * 64
        assert {llama.row_bucket(b, t) for t in (1, 2, 5, 7, 29, 32)} == {want}
        assert llama.row_bucket(b, 128) == b * 128
    assert (llama.row_bucket(8, 1), llama.row_bucket(16, 5)) == (256, 512)
    seen = []
    real = llama.qmatmul
    monkeypatch.setattr(llama, "qmatmul",
                        lambda x, w: seen.append(x.shape[0]) or real(x, w))
    real_mm = llama._matmul_f32
    monkeypatch.setattr(llama, "_matmul_f32", lambda x, w: (
        seen.append(x.shape[0]), real_mm(x, w))[1])
    shape = (TCFG.n_layer, 3, 256, TCFG.n_kv_head * TCFG.head_dim)
    caches = (torch.zeros(shape), torch.zeros(shape))
    lens = torch.full((3,), 40, dtype=torch.int32)
    for T, last_only in ((1, True), (7, False), (29, False)):
        seen.clear()
        toks = torch.zeros((3, T), dtype=torch.int32)
        llama.forward(models["tp"], TCFG, toks,
                      impls.target_attn(TCFG, lens, T), caches,
                      last_only=last_only)
        assert set(seen) == {128}, (T, set(seen))


def test_categorical_from_logits_or_probs():
    """sampling.categorical draws the same tokens from logits as from their
    softmax under one seed, with the shape [..., num_samples], and refuses
    both or neither."""
    from magicdec_tpu_torch.engine import sampling

    logits = torch.randn((3, 5, 16), generator=torch.Generator().manual_seed(0))
    a = sampling.categorical(torch.Generator().manual_seed(4), logits=logits,
                             num_samples=2)
    b = sampling.categorical(torch.Generator().manual_seed(4),
                             probs=torch.softmax(logits, -1), num_samples=2)
    assert a.shape == (3, 5, 2) and a.dtype == torch.int32
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="exactly one"):
        sampling.categorical(torch.Generator(), logits=logits,
                             probs=torch.softmax(logits, -1))
