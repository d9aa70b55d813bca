"""The port's weight-only quantization (int8 and int4) against the JAX
package's, on the CPU.

Both packages get the same float32 weights (numpy, or JAX's init_params
carried over with params_from_numpy) and the same tokens; JAX matmuls run at
"highest" precision (conftest.py), TF32 is off in torch. Codes must be
equal and scales within one ulp (both divide the same f32 values and round
half to even). The int4 products sum exact f32 products in other orders
(the port the kernel's per-group formula, the JAX package's CPU path the
dequantized weight), so they are held to an f32 tolerance; int8 runs the
same dequantize-then-matmul in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine import attention_impls as jimpls
from magicdec_tpu.engine.spec import (generate_autoregressive as j_ar,
                                      generate_selfspec as j_spec)
from magicdec_tpu.models import llama as jllama
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.ops.pallas import int4_matmul as jim
from magicdec_tpu.quant import int8 as jq
from magicdec_tpu_torch.engine import attention_impls as timpls
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive as t_ar,
                                            generate_selfspec as t_spec)
from magicdec_tpu_torch.models import llama as tllama
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.ops import int4_matmul as tim
from magicdec_tpu_torch.quant import int8 as tq

torch.backends.cuda.matmul.allow_tf32 = False

JC, TC = JArgs.from_name("test-tiny"), TArgs.from_name("test-tiny")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _w(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_scales(port, ref):
    np.testing.assert_array_max_ulp(port.numpy(), np.asarray(ref), maxulp=1)


def test_quantizers_give_the_jax_codes():
    w = _w(0, 2, 256, 96)
    j8, t8 = jq.quantize_int8(jnp.asarray(w), (-2,)), tq.quantize_int8(
        torch.from_numpy(w), (-2,))
    np.testing.assert_array_equal(t8["q"].numpy(), np.asarray(j8["q"]))
    _assert_scales(t8["s"], j8["s"])
    for axis in (-2, -1):
        j4 = jq.quantize_int4(jnp.asarray(w), in_axis=axis, group_size=32)
        t4 = tq.quantize_int4(torch.from_numpy(w), in_axis=axis, group_size=32)
        np.testing.assert_array_equal(t4.q4.numpy(), np.asarray(j4.q4))
        _assert_scales(t4.s4, j4.s4)
        np.testing.assert_array_equal(
            tq.dequantize_int4(t4, torch.float32).numpy(),
            np.asarray(jq.dequantize_int4(j4, jnp.float32)))
    wc = _w(1, 2, 256, 4, 48)
    jc = jq.quantize_int4_cols(jnp.asarray(wc), in_axis=-3)
    tc = tq.quantize_int4_cols(torch.from_numpy(wc), in_axis=-3)
    np.testing.assert_array_equal(tc.q4.numpy(), np.asarray(jc.q4))
    _assert_scales(tc.s4, jc.s4)
    assert tc.out_shape == tuple(jc.out_shape) == (4, 48)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_matches_jax(mode):
    jp = jllama.init_params(jax.random.PRNGKey(0), JC, jnp.float32, scale=0.3)
    tp = tllama.params_from_numpy(_np(jp), device="cpu")
    jl = jq.quantize_params(jp, mode)["layers"]
    tl = tq.quantize_params(tp, mode)["layers"]
    # params_from_numpy carries JAX's quantized tree over as the port's
    carried = tllama.params_from_numpy(_np(jl), device="cpu")
    for name in tq._QUANT_SPECS:
        for t in (tl[name], carried[name]):
            if mode == "int8":
                np.testing.assert_array_equal(t["qT"].numpy(),
                                              np.asarray(jl[name]["qT"]))
                _assert_scales(t["s"], jl[name]["s"])
            else:
                assert isinstance(t, tq.Int4ColWeight)
                np.testing.assert_array_equal(t.q4.numpy(),
                                              np.asarray(jl[name].q4))
                _assert_scales(t.s4, jl[name].s4)
                assert t.out_shape == tuple(jl[name].out_shape)
        assert torch.equal(tl["attn_norm"], tp["layers"]["attn_norm"])


def test_dequantize_int8_reads_the_stored_form():
    """The JAX dequantize_int8 reads only {"q", "s"}; the port's also reads
    quantize_params' transposed, folded {"qT", "s"} back to [L, K, *out]."""
    jp = jllama.init_params(jax.random.PRNGKey(1), JC, jnp.float32, scale=0.3)
    tp = tllama.params_from_numpy(_np(jp), device="cpu")
    stored = tq.quantize_params(tp, "int8")["layers"]
    for name, axis in tq._QUANT_SPECS.items():
        ref = jq.dequantize_int8(
            jq.quantize_int8(jp["layers"][name], (axis,)), jnp.float32)
        got = tq.dequantize_int8(stored[name], torch.float32)
        assert tuple(got.shape) == tuple(tp["layers"][name].shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_qmatmul_matches_jax():
    x = _w(2, 3, 5, 256)
    w = _w(3, 2, 256, 4, 48)          # a stacked [L, K, 2, I]-like weight
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    # int8, stored folded: one layer's qT
    jl = jq.quantize_params({"layers": {"w_gate_up": jnp.asarray(w),
                                        "wqkv": jnp.zeros((2, 256, 8)),
                                        "wo": jnp.zeros((2, 256, 8)),
                                        "w_down": jnp.zeros((2, 256, 8))}},
                            "int8")["layers"]["w_gate_up"]
    tl = tq.quantize_params({"layers": {"w_gate_up": torch.from_numpy(w),
                                        "wqkv": torch.zeros(2, 256, 8),
                                        "wo": torch.zeros(2, 256, 8),
                                        "w_down": torch.zeros(2, 256, 8)}},
                            "int8")["layers"]["w_gate_up"]
    j = jq.qmatmul(jx, {k: v[1] for k, v in jl.items()})
    t = tq.qmatmul(tx, {k: v[1] for k, v in tl.items()})
    assert tuple(t.shape) == (3, 5, 4, 48)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="one layer"):
        tq.qmatmul(tx, tl)
    # int4 column pairs (the kernel's function here; JAX dequantizes first)
    jc = jq.quantize_int4_cols(jnp.asarray(w), in_axis=-3)
    tc = tq.quantize_int4_cols(torch.from_numpy(w), in_axis=-3)
    j = jq.qmatmul(jx, jq.Int4ColWeight(jc.q4[0], jc.s4[0], jc.out_shape))
    t = tq.qmatmul(tx, tc[0])
    assert tuple(t.shape) == (3, 5, 4, 48)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-4)
    # signed int4 along K
    w2 = _w(4, 256, 96)
    j = jq.qmatmul(jx, jq.quantize_int4(jnp.asarray(w2), -2, 64))
    t = tq.qmatmul(tx, tq.quantize_int4(torch.from_numpy(w2), -2, 64))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M,K,N,n_block,k_block", [(16, 256, 512, 128, 128),
                                                   (8, 256, 2 * 2816, 512, 256)])
def test_int4_matmul_plain_matches_the_jax_kernel(M, K, N, n_block, k_block):
    """The plain version against the TPU kernel in interpret mode, bf16 x.
    Both sum the same exact products in f32 in other orders and round once
    to bf16, so they agree within one bf16 step (2^-7 of the output) plus
    the f32 sums' error; N/2 = 2816 is the shape whose n_block the TPU
    kernel must clamp."""
    w = _w(5, K, N)
    x = _w(6, M, K)
    q4, s4 = jim.pack_int4_cols(jnp.asarray(w), group_size=128)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jim.int4_matmul(jx, q4, s4, group_size=128,
                                     n_block=n_block, k_block=k_block,
                                     interpret=True), np.float32)
    tq4, ts4 = tim.pack_int4_cols(torch.from_numpy(w))
    np.testing.assert_array_equal(tq4.numpy(), np.asarray(q4))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = tim.int4_matmul(tx, tq4, ts4).float().numpy()
    _, limit = tim.int4_matmul_plain_f32_and_limit(tx, tq4, ts4)
    assert np.all(np.abs(got - ref) <= 2.0 * limit.numpy())


def _forward(cfg_j, cfg_t, jp, tp, tokens):
    B, T = tokens.shape
    shape = (cfg_j.n_layer, B, 64, cfg_j.n_kv_head * cfg_j.head_dim)
    lens = np.asarray([0, 5], np.int32)
    jlog, _ = jllama.forward(jp, cfg_j, jnp.asarray(tokens),
                             jimpls.target_attn(cfg_j, jnp.asarray(lens)),
                             (jnp.zeros(shape), jnp.zeros(shape)))
    tlog = tllama.forward(tp, cfg_t, torch.from_numpy(tokens),
                          timpls.target_attn(cfg_t, torch.from_numpy(lens), T),
                          (torch.zeros(shape), torch.zeros(shape)))
    return tlog.numpy(), np.asarray(jlog)


@pytest.mark.parametrize("mode,tol", [("int8", 1e-4), ("int4", 1e-3)])
def test_quantized_forward_matches_jax(mode, tol):
    """Logits of JAX's quantized tree carried over. int8: both dequantize
    the weight and run an f32 matmul (1e-4, test_torch_model's tolerance).
    int4: the port sums per group (the kernel's function), the JAX CPU path
    multiplies the dequantized weight, f32 sums of other terms over two
    layers, so 1e-3."""
    jp = jllama.init_params(jax.random.PRNGKey(2), JC, jnp.float32, scale=0.3)
    jqp = jq.quantize_params(jp, mode)
    tqp = tllama.params_from_numpy(_np(jqp), device="cpu")
    tokens = np.random.default_rng(3).integers(0, JC.vocab_size, (2, 24)
                                               ).astype(np.int32)
    got, ref = _forward(JC, TC, jqp, tqp, tokens)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


B, P, NEW, GAMMA = 2, 128, 24, 3


@pytest.fixture(scope="module")
def int8_params():
    jp = jq.quantize_params(
        jllama.init_params(jax.random.PRNGKey(0), JC, jnp.float32, scale=0.3),
        "int8")
    prompt = np.random.default_rng(1).integers(0, JC.vocab_size, (B, P)
                                               ).astype(np.int32)
    return jp, tllama.params_from_numpy(_np(jp), device="cpu"), prompt


@pytest.mark.parametrize("extra", [8, 24])
def test_int8_streams_equal_jax(int8_params, extra):
    """tests/test_quant.py's int8 spec test in f32, each stream also equal
    to the JAX package's: AR, SnapKV at budgets 32 and P, two max_len; the
    speculative streams equal the AR stream and full budget accepts 1.0."""
    jp, tp, prompt = int8_params
    kw = dict(batch_size=B, max_len=P + NEW + GAMMA + extra, prefill_chunk=128)
    tkw = dict(kw, kv_dtype=torch.float32, device="cpu")
    jkw = dict(kw, kv_dtype=jnp.float32)
    ar, _ = t_ar(TEngine(TC, tp, **tkw), prompt, NEW)
    jar, _ = j_ar(JEngine(JC, jp, **jkw), jnp.asarray(prompt), NEW)
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))
    for budget in (32, P):
        out, counts, st = t_spec(TEngine(TC, tp, spec="snapkv",
                                         draft_budget=budget, **tkw),
                                 prompt, GAMMA, NEW)
        jout, jcounts, _ = j_spec(JEngine(JC, jp, spec="snapkv",
                                          draft_budget=budget, **jkw),
                                  jnp.asarray(prompt), GAMMA, NEW)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(out[:, :NEW].numpy(), ar.numpy())
        if budget == P:
            assert st.acceptance_rate == 1.0, st


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_lossless_and_full_budget_exact(dtype):
    """Inside the port: int4 SnapKV streams equal the int4 AR stream, and
    full budget accepts exactly 1.0 (the int4 product's rows do not depend on
    the row count). The Engine builds from quantized params: its KV dtype is
    bf16 unless given."""
    params = tq.quantize_params(
        tllama.init_params(TC, dtype, scale=0.3, seed=4, device="cpu"), "int4")
    prompt = np.random.default_rng(5).integers(0, TC.vocab_size, (B, P))
    kw = dict(batch_size=B, max_len=P + NEW + GAMMA + 8, prefill_chunk=128,
              kv_dtype=dtype, device="cpu")
    ar, _ = t_ar(TEngine(TC, params, **kw), prompt, NEW)
    for budget in (32, P):
        out, _, st = t_spec(TEngine(TC, params, spec="snapkv",
                                    draft_budget=budget, **kw),
                            prompt, GAMMA, NEW)
        np.testing.assert_array_equal(out[:, :NEW].numpy(), ar.numpy())
        if budget == P:
            assert st.acceptance_rate == 1.0, st
    assert TEngine(TC, params, batch_size=1, max_len=128,
                   device="cpu").kv_dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_longspec_takes_a_quantized_draft(mode):
    """Two-model SD with the target's own weights quantized as the draft:
    the Engine builds from the quantized params unchanged and the stream is
    the plain target's AR stream (invariant 1)."""
    from magicdec_tpu_torch.engine.longspec import LongSpecEngine

    params = tllama.init_params(TC, torch.float32, scale=0.3, seed=8,
                                device="cpu")
    prompt = np.random.default_rng(9).integers(0, TC.vocab_size, (B, P))
    kw = dict(batch_size=B, max_len=P + NEW + GAMMA + 16, prefill_chunk=128,
              device="cpu")
    ar, _ = t_ar(TEngine(TC, params, **kw), prompt, NEW)
    draft = TEngine(TC, tq.quantize_params(params, mode),
                    kv_dtype=torch.float32, **kw)
    out, counts, _ = LongSpecEngine(TEngine(TC, params, **kw), draft).generate(
        prompt, GAMMA, NEW)
    assert int(counts.min()) >= NEW
    np.testing.assert_array_equal(out[:, :NEW].numpy(), ar.numpy())
