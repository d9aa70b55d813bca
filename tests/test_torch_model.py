"""The port's model core and checkpoint loader against the JAX package's.

Both packages get the same weights (JAX's init_params, carried over with
params_from_numpy) and the same tokens. float32, JAX matmuls at "highest"
precision (conftest.py), TF32 off in torch. The logits tolerance (1e-4) is
for the two frameworks summing the projections and attention in different
orders over a few layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.checkpoint import store as jstore
from magicdec_tpu.engine import attention_impls as jimpls
from magicdec_tpu.models import llama as jllama
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu_torch.checkpoint import store as tstore
from magicdec_tpu_torch.engine import attention_impls as timpls
from magicdec_tpu_torch.models import llama as tllama
from magicdec_tpu_torch.models.config import ModelArgs as TArgs

torch.backends.cuda.matmul.allow_tf32 = False

CFG_KW = dict(block_size=512, vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
              dim=64, intermediate_size=128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("extra", [{}, {"tie_word_embeddings": True},
                                   {"qkv_bias": True, "low_freq_factor": 1,
                                    "high_freq_factor": 4, "scaling_factor": 8,
                                    "original_max_position_embeddings": 64}])
def test_forward_logits_match_jax(extra):
    jc, tc = JArgs(**CFG_KW, **extra), TArgs(**CFG_KW, **extra)
    jp = jllama.init_params(jax.random.PRNGKey(0), jc, jnp.float32, scale=0.3)
    tp = tllama.params_from_numpy(_np_tree(jp), device="cpu")
    B, T, S = 2, 24, 64
    tokens = np.random.default_rng(1).integers(0, 256, size=(B, T)).astype(np.int32)
    shape = (jc.n_layer, B, S, jc.n_kv_head * jc.head_dim)
    lens = np.asarray([0, 5], np.int32)

    jimpl = jimpls.target_attn(jc, jnp.asarray(lens))
    jlog, (jk, jv) = jllama.forward(jp, jc, jnp.asarray(tokens), jimpl,
                                    (jnp.zeros(shape), jnp.zeros(shape)))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    timpl = timpls.target_attn(tc, torch.from_numpy(lens), T)
    tlog = tllama.forward(tp, tc, torch.from_numpy(tokens), timpl, (tk, tv))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)

    tk2, tv2 = torch.zeros(shape), torch.zeros(shape)
    timpl = timpls.target_attn(tc, torch.from_numpy(lens), T)
    last = tllama.forward(tp, tc, torch.from_numpy(tokens), timpl, (tk2, tv2),
                          last_only=True)
    torch.testing.assert_close(last, tlog[:, -1:], rtol=1e-6, atol=1e-6)


def test_split_qkv_is_kv_head_major():
    tc = TArgs(**CFG_KW)
    jc = JArgs(**CFG_KW)
    qkv = np.random.default_rng(2).standard_normal(
        (2, 3, (tc.n_head + 2 * tc.n_kv_head) * tc.head_dim)).astype(np.float32)
    for a, b in zip(tllama._split_qkv(torch.from_numpy(qkv), tc),
                    jllama._split_qkv(jnp.asarray(qkv), jc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_row_padding_keeps_rows_independent():
    """Rows computed at the padded row count do not depend on the batch."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((56, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    assert tllama._pad_rows(x[:8]).shape == (tllama.ROW_BUCKET, 64)
    full = tllama._pad_rows(x) @ w
    assert torch.equal((tllama._pad_rows(x[:8]) @ w)[:8], full[:8])
    assert torch.equal(tllama._matmul_f32(x[:8], w), full[:8])
    xb = x.to(torch.bfloat16)
    torch.testing.assert_close(tllama._matmul_f32(xb, w.to(torch.bfloat16)),
                               xb.float() @ w.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_init_params_shapes_and_seed():
    tc = TArgs(**CFG_KW)
    jp = jllama.init_params(jax.random.PRNGKey(0), JArgs(**CFG_KW))
    a = tllama.init_params(tc, torch.float32, seed=3, device="cpu")
    b = tllama.init_params(tc, torch.float32, seed=3, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        keys = [str(getattr(p, "key", p)) for p in path]
        t = a
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
    assert a["output"] is not None
    assert torch.equal(a["layers"]["wqkv"], b["layers"]["wqkv"])


def test_npz_loader_reads_bf16_checkpoint(tmp_path):
    jc = JArgs(**CFG_KW, tie_word_embeddings=True)
    jp = jllama.init_params(jax.random.PRNGKey(4), jc, jnp.bfloat16)
    path = str(tmp_path / "ckpt.npz")
    jstore.save_params(path, jp)
    tp = tstore.load_params(path)
    assert tp["output"] is None
    ref = tllama.params_from_numpy(_np_tree(jp), device="cpu")
    for name in ("tok_embeddings", "norm"):
        assert tp[name].dtype == torch.bfloat16
        assert torch.equal(tp[name], ref[name])
    for name, t in ref["layers"].items():
        assert torch.equal(tp["layers"][name], t), name
    f32 = tstore.load_params(path, dtype=torch.float32)
    np.testing.assert_array_equal(
        f32["layers"]["wqkv"].numpy(),
        np.asarray(jp["layers"]["wqkv"].astype(jnp.float32)))
