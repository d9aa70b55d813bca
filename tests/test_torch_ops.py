"""The port's primitives against the JAX package's, on the CPU in float32.

The same numpy inputs (made from a seed) go through both packages. JAX runs
matmuls at "highest" precision (conftest.py) and torch on the CPU computes
float32 products in full precision, so agreement is to float32 rounding;
the tolerances below allow for the two frameworks summing in different
orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu import cache as jcache
from magicdec_tpu.engine import sampling as jsampling
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.ops import attention as jattn
from magicdec_tpu.ops import norms as jnorms
from magicdec_tpu.ops import rope as jrope
from magicdec_tpu.ops import snapkv as jsnap
from magicdec_tpu_torch import cache as tcache
from magicdec_tpu_torch.engine import sampling as tsampling
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.ops import attention as tattn
from magicdec_tpu_torch.ops import norms as tnorms
from magicdec_tpu_torch.ops import rope as trope
from magicdec_tpu_torch.ops import snapkv as tsnap

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-5, atol=2e-5)   # float32, different summation order


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_tables_match():
    from magicdec_tpu.models.config import TRANSFORMER_CONFIGS as JT
    from magicdec_tpu_torch.models.config import TRANSFORMER_CONFIGS as TT
    assert JT == TT
    for name in ("llama-3.2-1b", "meta-llama/Llama-3.1-8B-Instruct", "test-tiny"):
        assert vars(TArgs.from_name(name)) == vars(JArgs.from_name(name))
    assert vars(TArgs.from_name("test-tiny").replace(dim=256)) == \
        vars(JArgs.from_name("test-tiny").replace(dim=256))
    with pytest.raises(ValueError):
        TArgs.from_name("no-such-model")


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = tnorms.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-31"])
def test_rope_matches_jax(name):
    jc, tc = JArgs.from_name(name), TArgs.from_name(name)
    np.testing.assert_array_equal(trope.rope_inv_freq(tc), jrope.rope_inv_freq(jc))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, tc.head_dim)).astype(np.float32)
    pos = rng.integers(0, 900, size=(2, 6)).astype(np.int32)
    ref = jrope.rope(jc, jnp.asarray(x), jnp.asarray(pos))
    out = trope.rope(tc, _t(x), _t(pos))
    # cos/sin of positions up to ~900 rad: one float32 ulp of the angle
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_rope_linear_interpolation_matches_jax():
    jc = JArgs.from_name("llama-2-7b-32k").replace(n_layer=1, dim=64, n_head=4)
    tc = TArgs.from_name("llama-2-7b-32k").replace(n_layer=1, dim=64, n_head=4)
    pos = np.arange(0, 64, dtype=np.int32)[None, :] * 37
    jcos, jsin = jrope.rope_cos_sin(jc, jnp.asarray(pos))
    tcos, tsin = trope.rope_cos_sin(tc, _t(pos))
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-5)


def _qkv(seed, B=2, T=3, S=40, Hkv=2, G=3, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def test_decode_valid_upto_matches_jax():
    lens = np.asarray([0, 5, 17], np.int32)
    for cap in (None, 8):
        ref = jattn.decode_valid_upto(jnp.asarray(lens), 4, cap)
        out = tattn.decode_valid_upto(_t(lens), 4, cap)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_masked_attention_matches_jax():
    q, k, v = _qkv(2)
    valid = tattn.decode_valid_upto(torch.tensor([10, 36], dtype=torch.int32), 3)
    ref = jattn.masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(valid.numpy()))
    out = tattn.masked_attention(_t(q), _t(k), _t(v), valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_masked_attention_general_matches_jax():
    q, k, v = _qkv(3)
    rng = np.random.default_rng(4)
    mask = rng.random((2, 3, 40)) < 0.6
    mask[..., 0] = True                       # no empty row
    ref = jattn.masked_attention_general(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(mask))
    out = tattn.masked_attention_general(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_append_at_layer_write_mask_and_drop_match_jax():
    rng = np.random.default_rng(5)
    L, B, S, HD, T = 2, 3, 12, 8, 4
    cache = rng.standard_normal((L, B, S, HD)).astype(np.float32)
    new = rng.standard_normal((B, T, 2, HD // 2)).astype(np.float32)
    # sequence 1 runs past the end (rows dropped), sequence 2 starts at 0
    lengths = np.asarray([3, 10, 0], np.int32)
    mask = np.asarray([[True, False, True, True], [True, True, True, True],
                       [False, True, True, False]])
    for wm in (None, mask):
        ref = jcache.append_at_layer(jnp.asarray(cache), jnp.asarray(new),
                                     jnp.asarray(lengths), jnp.int32(1),
                                     None if wm is None else jnp.asarray(wm))
        out = _t(cache).clone()
        tcache.append_at_layer(out, _t(new), _t(lengths), 1,
                               None if wm is None else _t(wm))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_append_at_layer_lengths_past_capacity_match_jax():
    rng = np.random.default_rng(6)
    cache = rng.standard_normal((1, 2, 8, 4)).astype(np.float32)
    new = rng.standard_normal((2, 3, 4)).astype(np.float32)
    lengths = np.asarray([9, 7], np.int32)    # a draft length past its size
    ref = jcache.append_at_layer(jnp.asarray(cache), jnp.asarray(new),
                                 jnp.asarray(lengths), jnp.int32(0))
    out = _t(cache).clone()
    tcache.append_at_layer(out, _t(new), _t(lengths), 0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_append_at_layer_uniform_matches_jax():
    rng = np.random.default_rng(7)
    cache = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    new = rng.standard_normal((2, 4, 8)).astype(np.float32)
    ref = jcache.append_at_layer_uniform(jnp.asarray(cache), jnp.asarray(new),
                                         jnp.int32(8), jnp.int32(1))
    out = _t(cache).clone()
    tcache.append_at_layer_uniform(out, _t(new), 8, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cache_rollback_rewinds_lengths_only():
    c = tcache.KVCache.create(1, 2, 16, 1, 4, torch.float32, "cpu")
    c.k.fill_(3.0)
    c.set_lengths(torch.tensor([5, 2], dtype=torch.int32))
    c.rollback(3)
    assert c.lengths.tolist() == [2, 0] and c.lengths.dtype == torch.int32
    assert bool((c.k == 3.0).all())
    d = tcache.DraftKVCache.create(1, 2, 8, 1, 4, torch.float32, "cpu")
    d.lengths = torch.tensor([4, 6], dtype=torch.int32)
    d.rollback(torch.tensor([1, 2], dtype=torch.int32))
    assert d.lengths.tolist() == [3, 4] and d.size == 8


def _snap_inputs(seed, B=2, Tobs=8, S=64, Hkv=2, G=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tobs, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("key_chunk", [16, 24])
def test_snapkv_scores_match_jax(key_chunk):
    q, k, _ = _snap_inputs(8)
    ref = jsnap.snapkv_scores(jnp.asarray(q), jnp.asarray(k), 56, 8,
                              key_chunk=key_chunk)
    out = tsnap.snapkv_scores(_t(q), _t(k), 56, 8, key_chunk=key_chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_snapkv_select_matches_jax():
    """Tie-free scores (a random permutation), so torch.topk and
    lax.top_k select the same set."""
    q, k, v = _snap_inputs(9)
    rng = np.random.default_rng(10)
    scores = np.stack([np.stack([rng.permutation(64) for _ in range(2)])
                       for _ in range(2)]).astype(np.float32)
    scores[..., 48:] = float(jsnap.NEG_INF)
    ref_k, ref_v = jsnap.snapkv_select(jnp.asarray(scores), jnp.asarray(k),
                                       jnp.asarray(v), 56, 24, 8)
    out_k, out_v = tsnap.snapkv_select(_t(scores), _t(k), _t(v), 56, 24, 8)
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(ref_v))


def test_snapkv_full_budget_selects_identity():
    q, k, v = _snap_inputs(11)
    scores = tsnap.snapkv_scores(_t(q), _t(k), 64, 8)
    dk, dv = tsnap.snapkv_select(scores, _t(k), _t(v), 64, 64, 8)
    np.testing.assert_array_equal(dk.numpy(), k)
    np.testing.assert_array_equal(dv.numpy(), v)


def test_sampling_matches_jax():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((3, 1, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tsampling.argmax_tokens(_t(logits)).numpy(),
        np.asarray(jsampling.argmax_tokens(jnp.asarray(logits))))
    for p in (0.5, 0.9):
        ref = jsampling.top_p_filter(jnp.asarray(logits), p)
        out = tsampling.top_p_filter(_t(logits), p)
        np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(np.asarray(ref)))
    g = torch.Generator().manual_seed(0)
    tok = tsampling.sample(_t(logits), g, temperature=0.7, top_p=0.5)
    kept = ~np.isinf(tsampling.top_p_filter(_t(logits) / 0.7, 0.5).numpy())
    assert tok.dtype == torch.int32 and tok.shape == (3, 1)
    for b in range(3):
        assert kept[b, 0, int(tok[b, 0])]
