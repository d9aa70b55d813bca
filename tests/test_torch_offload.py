"""The port's host offload path (engine/offload.py, engine/wave_buffer.py,
retro.HostClusterStore) on the CPU against the JAX package.

The config, weights, prompt and sizes of tests/test_offload.py, carried
over with params_from_numpy. float32, JAX matmuls at "highest" precision
(conftest.py), TF32 off in torch. The six cases of tests/test_offload.py
run on the port; the layer-at-a-time prefill's state is held against
JAX's (centroids, tails and a layer's output within 1e-5 of each
tensor's largest magnitude, as the frameworks sum f32 products in other
orders; member_valid and the first token exactly); one clustering pass on
the same keys gives the same member sets and blocks; every generation
mode's stream equals JAX's, also with int8 weights; the wave buffer (built
here with g++) round-trips bytes; and HostClusterStore gathers what JAX's
gathers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine import offload as joff
from magicdec_tpu.engine import retro as jretro
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import offload as toff
from magicdec_tpu_torch.engine import retro as tretro
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.wave_buffer import (HostBlockStore,
                                                   HostWaveBuffer)
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy
from magicdec_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)
def _close(got, want):
    """Within 1e-5 of the reference tensor's largest magnitude: the K/V of a
    layer's output carry the f32 rounding of the layers before (2.5e-6 of
    the largest element here)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))

CFG_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=4,
              n_kv_head=2, dim=64, intermediate_size=128)
JCFG, TCFG = JArgs(**CFG_KW), TArgs(**CFG_KW)
B, P, NEW = 2, 256, 12
NCLUST, CAP, NPROBE, KEEP, GAMMA = 16, 32, 4, 64, 3
HD = TCFG.n_kv_head * TCFG.head_dim
U = min(NCLUST, (GAMMA + 1) * NPROBE)
KW = dict(nprobe=NPROBE, cap=CAP)


@pytest.fixture(scope="module")
def jparams():
    return j_init(jax.random.PRNGKey(0), JCFG, jnp.float32, scale=0.4)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (B, P), 0,
                                       JCFG.vocab_size, dtype=jnp.int32))


def _j_setup(jparams, prompt):
    store = joff.HostBlockStore(JCFG.n_layer, B, NCLUST, CAP, HD, np.float32)
    state, buffer0 = joff.offload_prefill(
        jparams, JCFG, store, jnp.asarray(prompt), n_clusters=NCLUST, cap=CAP,
        tail_keep=KEEP)
    return store, state, buffer0


def _t_setup(tparams, prompt):
    store = HostBlockStore(TCFG.n_layer, B, NCLUST, CAP, HD, torch.float32)
    state, buffer0 = toff.offload_prefill(
        tparams, TCFG, store, prompt, n_clusters=NCLUST, cap=CAP,
        tail_keep=KEEP, device="cpu")
    return store, state, buffer0


@pytest.fixture(scope="module")
def jax_run(jparams, prompt):
    """JAX's prefill store and state, and every generation mode's
    stream."""
    store, state, buffer0 = _j_setup(jparams, prompt)
    out = {"gen": joff.offload_generate(jparams, JCFG, state, store, buffer0,
                                        NEW, **KW)[0],
           "hostloop": joff.offload_generate_hostloop(
               jparams, JCFG, state, store, buffer0, NEW, **KW)[0],
           "spec": joff.offload_generate_spec(
               jparams, JCFG, state, store, buffer0, NEW, gamma=GAMMA,
               **KW)[0],
           "spec_lru": joff.offload_generate_spec(
               jparams, JCFG, state, store, buffer0, NEW, gamma=GAMMA,
               lru=joff.ClusterLRU(store, nslots=NCLUST), **KW)[0],
           "hostloop_lru": joff.offload_generate_hostloop(
               jparams, JCFG, state, store, buffer0, NEW,
               lru=joff.ClusterLRU(store, nslots=NPROBE + 2), **KW)[0]}
    return store, state, np.asarray(buffer0), {k: np.asarray(v)
                                               for k, v in out.items()}


@pytest.fixture(scope="module")
def port(tparams, prompt):
    """The port's prefill store and state, shared: a generation leaves the
    state as it was (test_generation_leaves_the_state_unchanged) and the
    counters are read as differences."""
    return _t_setup(tparams, prompt)


# ---------------------------------------------------------------------------
# the six cases of tests/test_offload.py, on the port
# ---------------------------------------------------------------------------

def test_host_offload_decode_equals_device_twin(tparams, port):
    store, state, buffer0 = port
    out_host, _ = toff.offload_generate(tparams, TCFG, state, store, buffer0,
                                        NEW, device="cpu", **KW)
    blocks = torch.stack([store.gather_clusters(
        l, np.tile(np.arange(NCLUST), (B, 1))) for l in range(TCFG.n_layer)])
    out_dev, _ = toff.offload_generate(
        tparams, TCFG, state, store, buffer0, NEW, device="cpu",
        fetch_fn=toff.device_fetch_fn(blocks), **KW)
    assert torch.equal(out_host, out_dev)
    assert store.buf.gathered_slots > 0      # the host path really served


def test_offload_prefill_matches_dense_forward_logits(tparams, prompt, port):
    _, _, buffer0 = port
    eng = TEngine(TCFG, tparams, batch_size=B, max_len=P + 16,
                  prefill_chunk=128, device="cpu")
    assert torch.equal(buffer0, eng.encode(prompt))


def test_hostloop_decode_equals_io_callback_decode(tparams, port):
    store, state, buffer0 = port
    out_cb, _ = toff.offload_generate(tparams, TCFG, state, store, buffer0,
                                      NEW, device="cpu", **KW)
    out_hl, _ = toff.offload_generate_hostloop(
        tparams, TCFG, state, store, buffer0, NEW, device="cpu", **KW)
    assert torch.equal(out_cb, out_hl)


def test_spec_over_offload_lossless_vs_hostloop(tparams, port):
    store, state, buffer0 = port
    out_ar, _ = toff.offload_generate_hostloop(
        tparams, TCFG, state, store, buffer0, NEW, device="cpu", **KW)
    before = store.buf.gathered_slots
    out_sp, _, stats = toff.offload_generate_spec(
        tparams, TCFG, state, store, buffer0, NEW, gamma=GAMMA, device="cpu",
        **KW)
    assert torch.equal(out_sp[:, :NEW], out_ar[:, :NEW])
    # one union gather per (layer, round), at most U clusters a sequence
    assert (stats["rounds"] * TCFG.n_layer * B * U
            == store.buf.gathered_slots - before)


def test_lru_spec_stream_identical_and_fewer_host_fetches(tparams, port):
    store, state, buffer0 = port
    out_plain, _, _ = toff.offload_generate_spec(
        tparams, TCFG, state, store, buffer0, NEW, gamma=GAMMA, device="cpu",
        **KW)
    lru = toff.ClusterLRU(store, nslots=NCLUST, device="cpu")
    before = store.buf.gathered_slots
    out_lru, _, stats = toff.offload_generate_spec(
        tparams, TCFG, state, store, buffer0, NEW, gamma=GAMMA, lru=lru,
        device="cpu", **KW)
    fetched = store.buf.gathered_slots - before
    assert torch.equal(out_lru, out_plain)
    plain_fetches = stats["rounds"] * TCFG.n_layer * B * U
    assert lru.misses == fetched
    assert lru.hits > 0 and fetched < plain_fetches
    assert lru.hit_rate > 0.3, lru.hit_rate     # adjacent rounds overlap


def test_lru_hostloop_stream_identical(tparams, port):
    store, state, buffer0 = port
    out_plain, _ = toff.offload_generate_hostloop(
        tparams, TCFG, state, store, buffer0, NEW, device="cpu", **KW)
    lru = toff.ClusterLRU(store, nslots=NPROBE + 2, device="cpu")  # evicts
    out_lru, _ = toff.offload_generate_hostloop(
        tparams, TCFG, state, store, buffer0, NEW, lru=lru, device="cpu", **KW)
    assert torch.equal(out_lru, out_plain)
    assert lru.misses > 0 and lru.evictions > 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_offload_prefill_state_matches_jax(jax_run, port):
    jstore, jstate, jbuf0, _ = jax_run
    store, state, buffer0 = port
    np.testing.assert_array_equal(buffer0.numpy(), jbuf0)
    _close(state.centroids.numpy(), jstate.centroids)
    np.testing.assert_array_equal(state.member_valid.numpy(),
                                  np.asarray(jstate.member_valid))
    for name in ("tail_k", "tail_v"):
        _close(getattr(state, name).numpy(), getattr(jstate, name))
    for name in ("tail_len", "tail_base"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    assert state.prefix_len == jstate.prefix_len == P
    # the host store holds JAX's blocks (the same members, f32 K/V values)
    every = np.tile(np.arange(NCLUST), (B, 1))
    for l in range(TCFG.n_layer):
        _close(store.gather_clusters(l, every).numpy(),
               jstore.gather_clusters(l, every))


def test_layer_prefill_matches_jax(jparams, tparams):
    """One layer over the prefix: x_next, K rotated and V within _close (JAX
    attends with the dense oracle, the port with flash_prefill's plain
    version: both f32)."""
    x = np.random.default_rng(3).standard_normal((B, P, JCFG.dim)).astype(
        np.float32)
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    jx, jk, jv = joff._layer_prefill(jlp, JCFG, jnp.asarray(x), mega=128)
    tx, tk, tv = toff._layer_prefill(toff._layer_params(tparams, 1), TCFG,
                                     torch.from_numpy(x), mega=128)
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        _close(got.numpy(), want)


@pytest.mark.parametrize("segment", [8192, 128])
def test_cluster_layer_matches_jax(segment):
    """One clustering pass on the same keys: centroids within 1e-5, member
    sets and the gathered blocks exactly; segment 128 clusters the 256
    slots in two segments of 8 clusters."""
    rng = np.random.default_rng(5)
    kf = rng.standard_normal((B, P, HD)).astype(np.float32)
    vf = rng.standard_normal((B, P, HD)).astype(np.float32)
    jc, jm, jb = joff._cluster_layer(jnp.asarray(kf), jnp.asarray(vf), NCLUST,
                                     CAP, segment=segment)
    tc, tm, tb = toff._cluster_layer(torch.from_numpy(kf),
                                     torch.from_numpy(vf), NCLUST, CAP,
                                     segment=segment)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


MODES = ("gen", "hostloop", "spec", "spec_lru", "hostloop_lru")


@pytest.mark.parametrize("mode", MODES)
def test_stream_matches_jax(mode, jax_run, tparams, port):
    want = jax_run[-1]
    store, state, buffer0 = port
    if mode == "gen":
        out = toff.offload_generate(tparams, TCFG, state, store, buffer0, NEW,
                                    device="cpu", **KW)[0]
    elif mode.startswith("hostloop"):
        lru = (toff.ClusterLRU(store, nslots=NPROBE + 2, device="cpu")
               if mode.endswith("lru") else None)
        out = toff.offload_generate_hostloop(tparams, TCFG, state, store,
                                             buffer0, NEW, lru=lru,
                                             device="cpu", **KW)[0]
    else:
        lru = (toff.ClusterLRU(store, nslots=NCLUST, device="cpu")
               if mode.endswith("lru") else None)
        out = toff.offload_generate_spec(tparams, TCFG, state, store, buffer0,
                                         NEW, gamma=GAMMA, lru=lru,
                                         device="cpu", **KW)[0]
    np.testing.assert_array_equal(out.numpy(), want[mode])


def test_generation_leaves_the_state_unchanged(tparams, port):
    store, state, buffer0 = port
    tail_k = state.tail_k.clone()
    _, after = toff.offload_generate_hostloop(tparams, TCFG, state, store,
                                              buffer0, NEW, device="cpu", **KW)
    assert torch.equal(state.tail_k, tail_k)
    assert torch.equal(after.tail_len, state.tail_len + NEW - 1)


def test_refusals(tparams, port):
    """User errors raise ValueError: a tail too short for the generation,
    a store shape other than the clustering's, an LRU smaller than the
    round's union, a dtype the store does not hold."""
    store, state, buffer0 = port
    with pytest.raises(ValueError, match="tail"):
        toff.offload_generate_spec(tparams, TCFG, state, store, buffer0, 80,
                                   gamma=GAMMA, device="cpu", **KW)
    with pytest.raises(ValueError, match="tail"):
        toff.offload_generate(tparams, TCFG, state, store, buffer0, 80,
                              device="cpu", **KW)
    with pytest.raises(ValueError, match="store holds"):
        store.put_layer(0, torch.zeros((B, NCLUST // 2, 2, CAP, HD)))
    with pytest.raises(ValueError, match="store holds"):
        store.put_layer(0, torch.zeros((B, NCLUST, 2, CAP, HD),
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="LRU"):
        toff.offload_generate_spec(
            tparams, TCFG, state, store, buffer0, NEW, gamma=GAMMA,
            lru=toff.ClusterLRU(store, nslots=U - 1, device="cpu"),
            device="cpu", **KW)
    lru = toff.ClusterLRU(store, nslots=2, device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        lru.admit(0, np.array([[0, 1, 2], [0, 0, 0]]))


# ---------------------------------------------------------------------------
# the wave buffer and the stores
# ---------------------------------------------------------------------------

def test_wave_buffer_is_built_here_and_round_trips():
    """csrc/wave_buffer.cpp built with g++ into the package's build dir (never
    native/); bytes in and out; a gather equals numpy's fancy index, into a
    new array and into a given tensor."""
    lib = _build.lib_path("wave_buffer")
    assert lib.parent == _build.BUILD_DIR and "native" not in str(lib)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((32, 64)).astype(np.float32)
    buf = HostWaveBuffer(32, 64 * 4)
    buf.put(0, data)
    assert lib.exists()
    ids = np.array([5, 0, 31, 7, 7], np.int64)
    out = buf.gather(ids).view(np.float32).reshape(5, 64)
    np.testing.assert_array_equal(out, data[ids])
    host = torch.empty(5 * 64, dtype=torch.float32)
    buf.gather(ids, out=host)
    np.testing.assert_array_equal(host.numpy().reshape(5, 64), data[ids])
    assert buf.gathered_slots == 10
    with pytest.raises(ValueError):
        buf.gather(np.array([32]))
    with pytest.raises(ValueError):
        buf.put(30, data[:4])


def test_block_store_moves_bfloat16_as_bytes():
    """A bf16 store needs no numpy bfloat16: blocks go in and come back bit
    for bit, on the host and through fetch."""
    g = torch.Generator().manual_seed(0)
    blocks = torch.randn((2, 3, B, NCLUST, 2, CAP, 16), generator=g)
    blocks = blocks.to(torch.bfloat16)
    store = HostBlockStore(3, B, NCLUST, CAP, 16, torch.bfloat16)
    for l in range(3):
        store.put_layer(l, blocks[0, l])
    top = np.array([[3, 0, 15], [7, 7, 1]])
    got = store.gather_clusters(2, top)
    want = blocks[0, 2][torch.arange(B)[:, None], torch.from_numpy(top)]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(store.fetch(2, top, "cpu"), want)
    assert store.fetches == 2 and store.bytes_fetched == 2 * want.numel() * 2


def test_host_cluster_store_matches_jax():
    """HostClusterStore.gather_clusters against JAX's on the same cache and
    slot table, and against a direct gather from the cache."""
    rng = np.random.default_rng(2)
    L, S, C, cap = 2, 192, 8, 40
    k = rng.standard_normal((L, B, S, HD)).astype(np.float32)
    v = rng.standard_normal((L, B, S, HD)).astype(np.float32)
    lengths = np.array([S, 150], np.int32)
    tc = KVCache(torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(lengths))
    _, slots = tretro.build_cluster_index(tc, C, cap)
    from magicdec_tpu.cache import KVCache as JKVCache
    jc = JKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    jstore = jretro.HostClusterStore(JCFG, jc, jnp.asarray(slots.numpy()), cap)
    tstore = tretro.HostClusterStore(TCFG, tc, slots, cap)
    assert tstore.shape == jstore.shape
    np.testing.assert_array_equal(tstore.member_valid.numpy(),
                                  np.asarray(jstore.member_valid))
    top = np.array([[0, 3, 7], [5, 5, 2]], np.int64)
    for l in range(L):
        got = tstore.gather_clusters(l, top).numpy()
        np.testing.assert_array_equal(got, jstore.gather_clusters(l, top))
    s = np.clip(slots.numpy()[1, 0, 3], 0, S - 1)
    np.testing.assert_array_equal(got[0, 1, 0], k[1, 0][s])
    np.testing.assert_array_equal(got[0, 1, 1], v[1, 0][s])


def test_int8_weights_stream_matches_jax(jparams, prompt):
    """int8 weights through the offload path, each layer's weight sliced
    before qmatmul (the port refuses a stacked int8 qT): the hostloop
    stream equals JAX's on the same quantized weights, and the spec stream
    equals it."""
    from magicdec_tpu.quant.int8 import quantize_params as j_quantize

    n = 6
    jq = j_quantize(jparams, "int8")
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                           device="cpu")
    store, state, buffer0 = _j_setup(jq, prompt)
    want = np.asarray(joff.offload_generate_hostloop(
        jq, JCFG, state, store, buffer0, n, **KW)[0])
    store, state, buffer0 = _t_setup(tq, prompt)
    out = toff.offload_generate_hostloop(tq, TCFG, state, store, buffer0, n,
                                         device="cpu", **KW)[0]
    np.testing.assert_array_equal(out.numpy(), want)
    spec = toff.offload_generate_spec(tq, TCFG, state, store, buffer0, n,
                                      gamma=GAMMA, device="cpu", **KW)[0]
    assert torch.equal(spec[:, :n], out)
