"""The port's fused decode block against the JAX package's, on the CPU.

The plain versions (what the wrappers run on CPU tensors) are held against
the TPU kernels in interpret mode at tests/test_fused_block.py's shapes, on
the same numpy inputs, within the per-element limit of
fused_block.fused_*_plain_f32_and_limit (f32 sums in other orders; in
bfloat16 a sum landing near a rounding point may round to the neighbouring
value), doubled for two sides that each sum and round, and in bfloat16 with
the mean error within MEAN_LIMIT. A decode forward of the
port with fused=True is held against JAX's forward(fused=True), whose two
kernels are patched into interpret mode (no JAX file changes).
"""

import functools
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine import attention_impls as jimpls
from magicdec_tpu.models import llama as jllama
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.ops.pallas import fused_block as jfb
from magicdec_tpu_torch.engine import attention_impls as timpls
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive as t_ar,
                                            generate_selfspec as t_spec)
from magicdec_tpu_torch.models import llama as tllama
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.ops import fused_block as tfb
from magicdec_tpu_torch.quant.int8 import quantize_params

torch.backends.cuda.matmul.allow_tf32 = False

D, HqD, I, O, M = 256, 256, 704, 512, 24
EPS = 1e-5
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(dtype, seed=0, m=M):
    """x, ctx, wo, norms, w_gate_up, w_down, wqkv, bqkv as torch tensors of
    dtype (numpy-seeded; norms not all ones)."""
    rng = np.random.default_rng(seed)

    def mk(*shape, s=0.3):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(dtype)

    return dict(x=mk(m, D, s=1.0), ctx=mk(m, HqD, s=1.0), wo=mk(HqD, D),
                n1=1.0 + mk(D, s=0.1), n2=1.0 + mk(D, s=0.1),
                gu=mk(D, 2, I), wd=mk(I, D), wqkv=mk(D, O), b=mk(O))


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(_JDT[t.dtype])


def _hold(got, ref, limit, dtype):
    err = (got.float() - ref).abs()
    assert bool((err <= 2 * limit).all()), float((err / limit).max())
    if dtype == torch.bfloat16:
        assert float(err.mean()) <= tfb.MEAN_LIMIT * float(ref.abs().mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_match_the_jax_kernels(dtype):
    t = _inputs(dtype)
    for bias in (None, t["b"]):
        ref = jfb.fused_qkv(_j(t["x"]), _j(t["n1"]), _j(t["wqkv"]),
                            None if bias is None else _j(bias), eps=EPS,
                            interpret=True)
        got = tfb.fused_qkv(t["x"], t["n1"], t["wqkv"], bias, EPS)
        _, limit = tfb.fused_qkv_plain_f32_and_limit(t["x"], t["n1"],
                                                     t["wqkv"], bias, EPS)
        _hold(got, torch.from_numpy(np.array(ref, np.float32)), limit,
              dtype)
    ref = jfb.fused_post_attn(_j(t["x"]), _j(t["ctx"]), _j(t["wo"]),
                              _j(t["n2"]), _j(t["gu"]), _j(t["wd"]), eps=EPS,
                              interpret=True)
    args = (t["x"], t["ctx"], t["wo"], t["n2"], t["gu"], t["wd"], EPS)
    _, limit = tfb.fused_post_attn_plain_f32_and_limit(*args)
    _hold(tfb.fused_post_attn(*args),
          torch.from_numpy(np.array(ref, np.float32)), limit, dtype)


def test_plain_rows_do_not_depend_on_the_row_count():
    """A row gets the same bits alone (M = 1) and among M = 56 rows."""
    t = _inputs(torch.bfloat16, seed=1, m=56)
    full = tfb.fused_qkv(t["x"], t["n1"], t["wqkv"], t["b"], EPS)
    post = tfb.fused_post_attn(t["x"], t["ctx"], t["wo"], t["n2"], t["gu"],
                               t["wd"], EPS)
    for r in (0, 17, 55):
        one = slice(r, r + 1)
        assert torch.equal(tfb.fused_qkv(t["x"][one], t["n1"], t["wqkv"],
                                         t["b"], EPS), full[one])
        assert torch.equal(tfb.fused_post_attn(
            t["x"][one], t["ctx"][one], t["wo"], t["n2"], t["gu"], t["wd"],
            EPS), post[one])


CFG_KW = dict(block_size=512, vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
              dim=128, intermediate_size=256)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_fused_decode_forward_matches_jax(monkeypatch, qkv_bias):
    """One decode forward (T = 3 tokens over 5 and 40 cached) with fused=True
    in both packages, f32: logits and the written K/V within 1e-4."""
    for name in ("fused_qkv", "fused_post_attn"):
        monkeypatch.setattr(jfb, name, functools.partial(getattr(jfb, name),
                                                         interpret=True))
    jc = JArgs(**CFG_KW, qkv_bias=qkv_bias)
    tc = TArgs(**CFG_KW, qkv_bias=qkv_bias)
    jp = jllama.init_params(jax.random.PRNGKey(0), jc, jnp.float32, scale=0.3)
    tp = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    B, T = 2, 3
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, (B, T)).astype(np.int32)
    shape = (jc.n_layer, B, 64, jc.n_kv_head * jc.head_dim)
    cache = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    lens = np.asarray([5, 40], np.int32)
    jlog, (jk, jv) = jllama.forward(
        jp, jc, jnp.asarray(tokens), jimpls.target_attn(jc, jnp.asarray(lens)),
        (jnp.asarray(cache), jnp.asarray(cache)), fused=True)
    tk, tv = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
    tlog = tllama.forward(tp, tc, torch.from_numpy(tokens),
                          timpls.target_attn(tc, torch.from_numpy(lens), T),
                          (tk, tv), fused=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)


def test_fused_selfspec_lossless_and_full_budget_exact_bf16(monkeypatch):
    """Inside the port, with the fused switch forced on for T <= 32 (as
    "auto" does on a card): SnapKV streams at budgets 32 and P equal the AR
    stream and full budget accepts exactly 1.0 in bf16, since the fused
    rows do not depend on the row count. The fused block must have run."""
    calls = []
    monkeypatch.setattr(tllama, "_fused_auto",
                        lambda params, config, x, T, fused:
                        calls.append(T) or T <= 32)
    cfg = TArgs.from_name("test-tiny")
    params = tllama.init_params(cfg, torch.bfloat16, scale=0.3, seed=6,
                                device="cpu")
    B, P, NEW, GAMMA = 2, 128, 24, 3
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))
    kw = dict(batch_size=B, max_len=P + NEW + GAMMA + 8, prefill_chunk=128,
              device="cpu")
    ar, _ = t_ar(TEngine(cfg, params, **kw), prompt, NEW)
    for budget in (32, P):
        out, _, st = t_spec(TEngine(cfg, params, spec="snapkv",
                                    draft_budget=budget, **kw),
                            prompt, GAMMA, NEW)
        np.testing.assert_array_equal(out[:, :NEW].numpy(), ar.numpy())
        if budget == P:
            assert st.acceptance_rate == 1.0, st
    assert 1 in calls and GAMMA + 1 in calls and 128 in calls


def test_fused_switch():
    """"auto" is the default; it routes a forward fused on a CUDA device at
    T <= 32 with plain weights and no tp mesh, and leaves CPU tensors,
    quantized weights, T > 32 and a tp mesh unfused; "off" leaves every
    forward unfused; an explicit value wins, and fused=True with quantized
    weights or on a tp mesh raises; only "auto" and "off" are modes. (The
    CUDA device is a stand-in here: the route reads only x.is_cuda.)"""
    from types import SimpleNamespace

    from magicdec_tpu_torch.parallel.sharding import Mesh

    assert tllama._FUSED_MODE == "auto"
    cfg = TArgs.from_name("test-tiny")
    params = tllama.init_params(cfg, seed=1, device="cpu")
    q8 = quantize_params(params, "int8")
    tp = cfg.replace()
    tp.mesh = Mesh(tp=2, rank=0, backend="gloo", device=torch.device("cpu"))
    x = torch.zeros(64, cfg.dim)
    card = SimpleNamespace(is_cuda=True)
    auto = tllama._fused_auto
    assert auto(params, cfg, card, 1, None)
    assert auto(params, cfg, card, 32, None)
    assert not auto(params, cfg, x, 1, None)          # a CPU tensor
    assert not auto(q8, cfg, card, 1, None)           # quantized weights
    assert not auto(params, cfg, card, 33, None)      # T > 32 (prefill)
    assert not auto(params, tp, card, 1, None)        # a tp mesh
    assert auto(params, cfg, x, 1, True)
    assert not auto(params, cfg, card, 1, False)
    tllama.set_fused_mode("off")
    try:
        assert not auto(params, cfg, card, 1, None)
        assert auto(params, cfg, card, 1, True)
    finally:
        tllama.set_fused_mode("auto")
    with pytest.raises(ValueError, match="plain weights"):
        auto(q8, cfg, x, 1, True)
    with pytest.raises(ValueError, match="tensor-parallel mesh"):
        auto(params, tp, card, 1, True)
    with pytest.raises(ValueError, match="auto or off"):
        tllama.set_fused_mode("on")


def _kernels(source: str) -> dict:
    """{name: body} of every __global__ function of a CUDA source."""
    out = {}
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s*)?(\w+)\s*\(", source):
        start = source.index("{", m.end())
        depth, i = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(source[i], 0)
            i += 1
            if depth == 0:
                break
        out[m.group(1)] = source[start:i]
    return out


def test_product_kernels_are_named_as_gemms():
    """The benchmark's gemm_roofline readers count the device time of the
    operations whose names hold a substring of
    portbench/data/gemm_kernels.json. Every kernel of csrc/fused_block.cu
    that runs a weight product (a wgmma stage or the f32 CUDA-core stage)
    carries such a substring, so the products the fused block runs on the
    card stay within the readers' time; ssq_kernel, a norm's reduction,
    carries none."""
    root = Path(__file__).resolve().parents[1]
    patterns = json.loads((root / "portbench" / "data" / "gemm_kernels.json")
                          .read_text())["name_contains"]
    kernels = _kernels((root / "magicdec_tpu_torch" / "csrc"
                        / "fused_block.cu").read_text())
    products = {n for n, body in kernels.items()
                if "_mma(" in body or "stage_f32(" in body}
    assert "block_gemm_kernel" in products and "ssq_kernel" in kernels
    for name in products:
        assert any(p in name for p in patterns), name
    assert not any(p in "ssq_kernel" for p in patterns)
