"""The port's RetroInfer path on the CPU against the JAX package.

k-means, the member slot table, the cluster index, the KV-fused store and
the index fold against the JAX functions (slot tables, counts and store
rows equal, centroids within 1e-5: the two frameworks sum the f32 products
in other orders); centroid_scores' plain version (and its wrapper's CPU
path) against the JAX kernel in Pallas interpret mode (1e-5, the JAX kernel
test's tolerance); page_gather_single against the JAX kernel in interpret
mode (exactly, into new tensors and into round-buffer views); one
round-opening draft step (2e-5, the decode kernels' tolerance); and
generate_selfspec(spec="retro") token for token against the JAX package's
and the port's AR stream, on the tail-covers path and on the fold path.
float32, JAX matmuls at "highest" precision (conftest.py), TF32 off in
torch. The model and sizes are those of tests/test_retro.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.cache import KVCache as JKVCache
from magicdec_tpu.engine import retro as jretro
from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.spec import generate_selfspec as j_spec
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu.ops import kmeans as jkmeans
from magicdec_tpu.ops.pallas import gemm_softmax as jgs
from magicdec_tpu.ops.pallas import page_gather as jpg
from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import retro as tretro
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                            generate_selfspec as t_spec)
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy
from magicdec_tpu_torch.ops import gemm_softmax as tgs
from magicdec_tpu_torch.ops import kmeans as tkmeans
from magicdec_tpu_torch.ops.page_gather import (page_gather_single,
                                                page_gather_single_plain)

torch.backends.cuda.matmul.allow_tf32 = False
CENT_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-5, atol=2e-5)


def _caches(L, B, S, HD, lengths, seed):
    """The same random K/V caches for both packages."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, S, HD)).astype(np.float32)
    v = rng.standard_normal((L, B, S, HD)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    jc = JKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    tc = KVCache(torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(lengths))
    return jc, tc


# ---------------------------------------------------------------------------
# k-means, the member table, the index and the store
# ---------------------------------------------------------------------------

def test_kmeans_separates_blobs_as_jax():
    """tests/test_retro.py's blob case (two tight blobs at +5 and -5)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((64, 8)) * 0.1 + 5.0,
                        rng.standard_normal((64, 8)) * 0.1 - 5.0]
                       ).astype(np.float32)[None]
    valid = np.ones((1, 128), np.float32)
    jc, ja = jkmeans.kmeans(jnp.asarray(x), jnp.asarray(valid), n_clusters=2,
                            iters=6)
    tc, ta = tkmeans.kmeans(torch.from_numpy(x), torch.from_numpy(valid),
                            n_clusters=2, iters=6)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **CENT_TOL)
    a = ta.numpy()[0]
    assert len(set(a[:64])) == 1 and len(set(a[64:])) == 1 and a[0] != a[64]


def test_kmeans_ragged_keys_match_jax():
    """Random keys of two sequences, one ending early (invalid slots are
    seeds but no members), more clusters than the short one fills."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 256, 32)).astype(np.float32)
    valid = (np.arange(256)[None] < np.asarray([[256], [40]])).astype(
        np.float32)
    jc, ja = jkmeans.kmeans(jnp.asarray(x), jnp.asarray(valid), n_clusters=12)
    tc, ta = tkmeans.kmeans(torch.from_numpy(x), torch.from_numpy(valid),
                            n_clusters=12)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **CENT_TOL)


def test_member_slot_table_matches_jax():
    """Ragged validity and clusters overflowing cap (members past cap are
    dropped in slot order)."""
    rng = np.random.default_rng(2)
    assign = rng.integers(0, 6, size=(2, 3, 200)).astype(np.int32)
    assign[0, 0, :90] = 4                       # one cluster far over cap
    valid = (np.arange(200)[None, None]
             < np.asarray([[200, 150, 0], [7, 200, 199]])[..., None])
    want = jretro.member_slot_table(jnp.asarray(assign), jnp.asarray(valid),
                                    6, 40)
    got = tretro.member_slot_table(torch.from_numpy(assign),
                                   torch.from_numpy(valid), 6, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lengths", [[200, 256], [70, 130]])
def test_build_cluster_index_and_store_match_jax(lengths):
    """Centroids within 1e-5, the slot tables equal, every valid slot a
    member at most once, and the KV-fused store bit-equal (from the same
    slots)."""
    cfg = JArgs.from_name("test-tiny")
    C, cap = 8, 24
    jc, tc = _caches(2, 2, 256, cfg.n_kv_head * cfg.head_dim, lengths, seed=3)
    jcent, jslots = jretro.build_cluster_index(cfg, jc, n_clusters=C, cap=cap)
    tcent, tslots = tretro.build_cluster_index(tc, n_clusters=C, cap=cap)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), **CENT_TOL)
    s = tslots.numpy()
    for b, n in enumerate(lengths):
        members = s[:, b][s[:, b] >= 0]
        assert (members < n).all()
        for l in range(2):
            m = s[l, b][s[l, b] >= 0]
            assert len(np.unique(m)) == len(m)
    jstore = jretro.build_clustered_store(jc, jslots, cap)
    tstore = tretro.build_clustered_store(tc, tslots, cap)
    np.testing.assert_array_equal(tstore.numpy(), np.asarray(jstore))
    state = tretro.build_retro_state(tc, C, cap)
    np.testing.assert_array_equal(state[3].numpy(), (s >= 0).sum(-1))
    np.testing.assert_array_equal(state[4].numpy(), lengths)
    assert state[4].data_ptr() != tc.lengths.data_ptr()


@pytest.mark.parametrize("cap", [96, 44])
def test_update_cluster_index_matches_jax(cap):
    """tests/test_retro.py's fold case: sequence 0 ages 10 generated rows
    out of its tail, sequence 1 none; then a window below indexed_upto adds
    nothing. At cap 44 some clusters are full and drop their aged rows.
    Slot tables, counts and the whole store equal the JAX results."""
    cfg = JArgs.from_name("test-tiny").replace(n_layer=1)
    C = 4
    jc0, tc0 = _caches(1, 2, 256, cfg.n_kv_head * cfg.head_dim, [160, 150],
                       seed=4)
    jcent, jslots = jretro.build_cluster_index(cfg, jc0, n_clusters=C, cap=cap)
    jstore = jretro.build_clustered_store(jc0, jslots, cap)
    jcounts = jnp.sum(jslots >= 0, axis=-1).astype(jnp.int32)
    tcent, tslots, tstore, tcounts, upto = tretro.build_retro_state(tc0, C,
                                                                    cap)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    jc = JKVCache(jc0.k, jc0.v, jnp.asarray([200, 180], jnp.int32))
    tc = KVCache(tc0.k, tc0.v, torch.tensor([200, 180], dtype=torch.int32))
    windows = [([160, 150], [170, 150]), ([150, 150], [160, 150])]
    for old, new in windows:
        jslots, jstore, jcounts = jretro.update_cluster_index(
            cfg, jc, jcent, jslots, jstore, jcounts, jnp.asarray(old),
            jnp.asarray(new), jc0.lengths, age_max=16, cap=cap)
        tretro.update_cluster_index(
            tc, tcent, tslots, tstore, tcounts, torch.tensor(old),
            torch.tensor(new), upto, age_max=16, cap=cap)
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(tstore.numpy(), np.asarray(jstore))
    s = tslots.numpy()[0]
    joined = [a for a in range(160, 170) if (s[0] == a).sum() == 1]
    assert all((s[0] == a).sum() <= 1 for a in range(150, 170))
    assert (len(joined) == 10) == (cap == 96) and joined
    assert not (s[1] >= 150).any()


# ---------------------------------------------------------------------------
# centroid_scores and page_gather_single
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,G", [(1, 2), (1, 4), (2, 4)])
def test_centroid_scores_plain_matches_jax_kernel(T, G):
    """T*G = 2, 4, 8 query rows per KV head (the JAX kernel pads to 8 and
    removes the pad rows' mass); the wrapper's CPU path and a strided view
    of [B, C, Hkv*D] centroids (the port's layout) give the same."""
    B, Hkv, D, C = 3, 2, 16, 24
    rng = np.random.default_rng(T * 10 + G)
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    cent = rng.standard_normal((B, C, Hkv * D)).astype(np.float32)
    cent_h = np.ascontiguousarray(cent.reshape(B, C, Hkv, D).transpose(0, 2, 1, 3))
    want = np.asarray(jgs.centroid_scores(jnp.asarray(q), jnp.asarray(cent_h),
                                          interpret=True))
    tq = torch.from_numpy(q)
    plain = tgs.centroid_scores_plain(tq, torch.from_numpy(cent_h))
    np.testing.assert_allclose(plain.numpy(), want, **CENT_TOL)
    view = torch.from_numpy(cent).view(B, C, Hkv, D).transpose(1, 2)
    assert not view.is_contiguous()
    np.testing.assert_allclose(tgs.centroid_scores(tq, view).numpy(), want,
                               **CENT_TOL)
    np.testing.assert_allclose(want.sum(-1), np.full((B, Hkv), T * G),
                               rtol=1e-5)


def _store(seed=5):
    """A KV-fused store [2 layers, 3 sequences, 6 clusters * 2cap, 32] with
    cap 16 and cluster ids with repeats and out of order."""
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((2, 3, 6 * 32, 32)).astype(np.float32)
    pages = np.asarray([[5, 0, 3], [2, 2, 4], [1, 0, 5]], np.int32)
    return store, pages


def test_page_gather_single_matches_jax_kernel():
    store, pages = _store()
    ts, tp = torch.from_numpy(store), torch.from_numpy(pages)
    for layer in (0, 1):
        want = np.asarray(jpg.page_gather_single(
            jnp.asarray(store), jnp.int32(layer), jnp.asarray(pages), page=32,
            interpret=True))
        np.testing.assert_array_equal(
            page_gather_single_plain(ts, layer, tp, 32).numpy(), want)
        np.testing.assert_array_equal(
            page_gather_single(ts, layer, tp, 32).numpy(), want)


def test_page_gather_single_splits_into_round_buffer_views():
    """out = the K and V top regions of a round buffer at one layer: each
    cluster's first cap rows land in bufk, its last cap rows in bufv, the
    rest of the buffers is untouched."""
    store, pages = _store()
    ts, tp = torch.from_numpy(store), torch.from_numpy(pages)
    want = np.asarray(jpg.page_gather_single(
        jnp.asarray(store), jnp.int32(1), jnp.asarray(pages), page=32,
        interpret=True))                                    # [3, 3, 32, 32]
    NS = 3 * 16
    bufk = torch.full((2, 3, NS + 8, 32), 7.0)
    bufv = torch.full((2, 3, NS + 8, 32), 7.0)
    out = page_gather_single(ts, 1, tp, 32,
                             out=(bufk[1, :, :NS].view(3, 3, 16, 32),
                                  bufv[1, :, :NS].view(3, 3, 16, 32)))
    np.testing.assert_array_equal(bufk[1, :, :NS].view(3, 3, 16, 32).numpy(),
                                  want[:, :, :16])
    np.testing.assert_array_equal(bufv[1, :, :NS].view(3, 3, 16, 32).numpy(),
                                  want[:, :, 16:])
    assert out[1].data_ptr() == bufv[1].data_ptr()
    for buf in (bufk, bufv):
        assert bool((buf[0] == 7).all() and (buf[1, :, NS:] == 7).all())


# ---------------------------------------------------------------------------
# one round-opening draft step
# ---------------------------------------------------------------------------

def test_retro_select_attn_step_matches_jax():
    """Score the centroids, take the top nprobe clusters, gather them (the
    port from its KV-fused store, the JAX package on the CPU from the cache
    rows), stamp the colmask (pad members and the members the tail holds:
    exact dedup), append, attend."""
    kw = dict(block_size=512, vocab_size=64, n_layer=1, n_head=4, n_kv_head=2,
              dim=64)
    jcfg, tcfg = JArgs(**kw), TArgs(**kw)
    Bq, S, C, cap, nprobe, Wcap, Hkv, D, Hq = 2, 256, 8, 32, 3, 32, 2, 16, 4
    NS = nprobe * cap
    rng = np.random.default_rng(6)
    q = rng.standard_normal((Bq, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, 1, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, 1, Hkv, D)).astype(np.float32)
    tail_base = np.asarray([150, 20], np.int32)
    tail_len = np.asarray([50, 9], np.int32)
    lens = tail_base + tail_len
    jc, tc = _caches(1, Bq, S, Hkv * D, lens, seed=7)
    bufk = rng.standard_normal((1, Bq, NS + Wcap, Hkv * D)).astype(np.float32)
    bufv = rng.standard_normal((1, Bq, NS + Wcap, Hkv * D)).astype(np.float32)
    cm = np.ones((1, Bq, 1, NS + Wcap), np.int32)
    cm[..., :NS] = 0

    jcent, jslots = jretro.build_cluster_index(jcfg, jc, n_clusters=C, cap=cap)
    jsel = jretro.retro_select_gather_fn(jcfg, jcent, jslots, None,
                                         jnp.asarray(tail_base), nprobe=nprobe)
    jimpl = jretro.roundtail_select_attn(jcfg, jnp.asarray(lens),
                                         jnp.asarray(tail_len),
                                         jnp.asarray(tail_base), jsel, NS=NS)
    jctx, (_, _, jbk, jbv, jcm) = jimpl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        (jc.k, jc.v, jnp.asarray(bufk), jnp.asarray(bufv), jnp.asarray(cm)),
        jnp.int32(0))

    tcent, tslots, tstore, _, _ = tretro.build_retro_state(tc, C, cap)
    tsel = tretro.retro_select_gather_fn(tcfg, tcent, tslots, tstore,
                                         nprobe=nprobe)
    tbk, tbv, tcm = (torch.from_numpy(x.copy()) for x in (bufk, bufv, cm))
    timpl = tretro.roundtail_select_attn(
        tcfg, torch.from_numpy(lens), torch.from_numpy(tail_len),
        torch.from_numpy(tail_base), tsel, NS=NS)
    tctx = timpl(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 (tc.k, tc.v, tbk, tbv, tcm), 0)

    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    top = tcm.numpy()[0, :, 0, :NS]
    assert 0 < top[0].sum() < NS        # pad members and dedup holes
    live = np.asarray(jcm)[:, :, 0] > 0
    for t_buf, j_buf in ((tbk, jbk), (tbv, jbv)):
        np.testing.assert_array_equal(t_buf.numpy()[live],
                                      np.asarray(j_buf)[live])


# ---------------------------------------------------------------------------
# generate_selfspec(spec="retro") against the JAX package's
# ---------------------------------------------------------------------------

JCFG, TCFG = JArgs.from_name("test-tiny"), TArgs.from_name("test-tiny")
B, P, GAMMA = 2, 512, 3
NEW, NEW_LONG = 24, 72       # the tail-covers and fold paths of test_retro.py


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
    eng = TEngine(TCFG, tparams, device="cpu", batch_size=B,
                  max_len=P + NEW_LONG + 16, prefill_chunk=128)
    return generate_autoregressive(eng, prompt, NEW_LONG)[0].numpy()


def stream_vs_jax(spec, jparams, tparams, prompt, ar_tokens, new, latest_k,
                  **extra):
    """Run both packages' generate_selfspec with the same settings and hold
    the port to the JAX package (streams, counts, rounds, accepted drafts)
    and to its own AR stream. Returns (port engine, stats)."""
    kw = dict(batch_size=B, max_len=P + new + GAMMA + 16, spec=spec,
              draft_budget=256, latest_k=latest_k, prefill_chunk=128,
              retro_cap=16, **extra)
    eng = TEngine(TCFG, tparams, device="cpu", **kw)
    out, counts, stats = t_spec(eng, prompt, gamma=GAMMA, max_new_tokens=new)
    out, counts = out.numpy(), counts.numpy()
    jout, jcounts, jstats = j_spec(JEngine(JCFG, jparams, **kw),
                                   jnp.asarray(prompt), gamma=GAMMA,
                                   max_new_tokens=new)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert stats.rounds == jstats.rounds
    assert stats.total_accepted_drafts == jstats.total_accepted_drafts
    for b in range(B):                      # invariant 1: lossless
        n = min(counts[b], new)
        assert n > 0
        np.testing.assert_array_equal(out[b, :n], ar_tokens[b, :n])
    return eng, stats


@pytest.mark.parametrize("path", ["tail_covers", "fold"])
def test_retro_stream_equals_jax_and_ar(jparams, tparams, prompt, ar_tokens,
                                        monkeypatch, path):
    """The tail-covers path (24 new tokens, latest_k 64) and the fold path
    (TAIL_COVERS_MAX lowered to 0 in both packages, 72 new tokens, latest_k
    32): the tail compacts and the aged generated rows join the index."""
    if path == "fold":
        monkeypatch.setattr(jretro, "TAIL_COVERS_MAX", 0)
        monkeypatch.setattr(tretro, "TAIL_COVERS_MAX", 0)
        jax.clear_caches()      # a cached trace may hold the other constant
    new, latest_k = (NEW, 64) if path == "tail_covers" else (NEW_LONG, 32)
    eng, stats = stream_vs_jax("retro", jparams, tparams, prompt, ar_tokens,
                               new, latest_k)
    assert eng.retro_clusters == (P + new + GAMMA + 16) // 32
    if path == "fold":
        jax.clear_caches()
        assert stats.compactions >= 1
        slots = eng.spec_index[1]
        assert bool((slots >= P).any())     # generated rows were folded in


def test_retro_full_coverage_gathers_the_right_rows(tparams, prompt):
    """8 clusters of up to 512 members cover every prefix row with no
    overflow, so the draft attends every row the verify does (in cluster
    order): in f32 it accepts nearly every draft. A gather of wrong rows
    would not."""
    new = NEW
    eng = TEngine(TCFG, tparams, device="cpu", batch_size=B,
                  max_len=P + new + GAMMA + 16, spec="retro",
                  draft_budget=128 + 8 * 512, latest_k=128, prefill_chunk=128,
                  retro_clusters=8, retro_cap=512)
    out, counts, stats = t_spec(eng, prompt, gamma=GAMMA, max_new_tokens=new)
    counts_c = eng.spec_index[3]
    assert int(counts_c.max()) < 512 and int(counts_c.sum()) == 2 * B * P
    assert stats.acceptance_rate >= 0.9, stats
    assert stats.index_build_s > 0.0


def test_retro_drafts_inside_generate_selfspec_only(tparams):
    eng = TEngine(TCFG, tparams, spec="retro", draft_budget=256,
                  device="cpu", batch_size=B, max_len=P + 64)
    assert eng.retro_clusters == (P + 64) // 32 and eng.retro_cap == 32
    with pytest.raises(ValueError, match="generate_selfspec"):
        eng.speculate(torch.zeros((B, 1), dtype=torch.int32))
