"""The port's Engine on the CPU against the JAX Engine: token streams.

The config, weights and prompts of tests/test_selfspec.py (prefill_chunk
32), carried over with params_from_numpy. float32, JAX matmuls at "highest"
precision (conftest.py), TF32 off in torch. The greedy streams must be
equal token for token, and the port must hold the repo's two invariants on
its own: speculative streams equal the AR stream, and full-budget SnapKV
accepts exactly 1.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.spec import (generate_autoregressive as j_ar,
                                      generate_selfspec as j_spec)
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive as t_ar,
                                            generate_selfspec as t_spec)
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False

CFG_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=4,
              n_kv_head=2, dim=64, intermediate_size=128)
JCFG, TCFG = JArgs(**CFG_KW), TArgs(**CFG_KW)
B, PREFIX, MAX_NEW = 2, 64, 24
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
    out, stats = t_ar(eng, prompt, MAX_NEW)
    assert stats.generated_tokens == B * MAX_NEW
    return out.numpy()


def test_autoregressive_stream_equals_jax(jparams, prompt, ar_tokens):
    ref, _ = j_ar(JEngine(JCFG, jparams, **ENGINE_KW), jnp.asarray(prompt),
                  MAX_NEW)
    np.testing.assert_array_equal(ar_tokens, np.asarray(ref))


def test_autoregressive_step_api_equals_generate(tparams, prompt, ar_tokens):
    eng = TEngine(TCFG, tparams, device="cpu", **ENGINE_KW)
    tok = eng.encode(prompt)
    out = [tok]
    for _ in range(MAX_NEW - 1):
        tok = eng.inference(tok)
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), ar_tokens)


def _port_spec(tparams, prompt, budget, window, gamma):
    eng = TEngine(TCFG, tparams, spec="snapkv", draft_budget=budget,
                  window_size=window, device="cpu", **ENGINE_KW)
    out, counts, stats = t_spec(eng, prompt, gamma=gamma,
                                max_new_tokens=MAX_NEW)
    return out.numpy(), counts.numpy(), stats


@pytest.mark.parametrize("budget,window,gamma", [(32, 8, 3), (PREFIX, 16, 1),
                                                 (PREFIX, 16, 3)])
def test_snapkv_stream_equals_jax_and_ar(jparams, tparams, prompt, ar_tokens,
                                         budget, window, gamma):
    out, counts, stats = _port_spec(tparams, prompt, budget, window, gamma)
    jeng = JEngine(JCFG, jparams, spec="snapkv", draft_budget=budget,
                   window_size=window, **ENGINE_KW)
    jout, jcounts, jstats = j_spec(jeng, jnp.asarray(prompt), gamma=gamma,
                                   max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert stats.rounds == jstats.rounds
    assert stats.total_accepted_drafts == jstats.total_accepted_drafts
    for b in range(B):                      # invariant 1: lossless
        n = min(counts[b], MAX_NEW)
        assert n > 0
        np.testing.assert_array_equal(out[b, :n], ar_tokens[b, :n])
    if budget == PREFIX:                    # invariant 2: exactly 1.0
        assert stats.acceptance_rate == 1.0, stats


def test_snapkv_draft_and_verify_api(tparams, prompt, ar_tokens):
    """One round through the decode-side API at full budget: gamma
    speculate() steps, the draft rewound to the round start, a dual-write
    verify(), and a length rollback."""
    gamma = 3
    eng = TEngine(TCFG, tparams, spec="snapkv", draft_budget=PREFIX,
                  window_size=16, device="cpu", **ENGINE_KW)
    tok = eng.encode(prompt)
    eng.begin_spec_round()
    start = eng.draft.lengths.clone()
    buf = [tok]
    for _ in range(gamma):
        buf.append(eng.speculate(buf[-1]))
    buffer = torch.cat(buf, 1)
    eng.set_lengths(draft=start)
    target = eng.verify(buffer)
    # full budget: every drafted token is the target's own argmax
    assert torch.equal(target[:, :gamma], buffer[:, 1:])
    np.testing.assert_array_equal(buffer.numpy(), ar_tokens[:, :gamma + 1])
    assert eng.cache.lengths.tolist() == [PREFIX + gamma + 1] * B
    eng.rollback_target(2)
    eng.rollback_draft(2)
    assert eng.cache.lengths.tolist() == [PREFIX + gamma - 1] * B
    assert eng.draft.lengths.tolist() == [PREFIX + gamma - 1] * B


def test_engine_rejects_modes_not_ported(tparams):
    """Every speculation mode of the JAX package is ported; an unknown mode
    and a speculation mode without a draft budget are rejected."""
    with pytest.raises(ValueError, match="unknown spec mode"):
        TEngine(TCFG, tparams, spec="medusa", draft_budget=32,
                device="cpu", **ENGINE_KW)
    for spec in ("snapkv", "retro", "squeeze"):
        with pytest.raises(ValueError, match="draft_budget"):
            TEngine(TCFG, tparams, spec=spec, device="cpu", **ENGINE_KW)


def test_full_budget_draft_cache_holds_a_long_generation(tparams, prompt):
    """The draft cache is sized at encode from the target's free slots, so a
    generation longer than any fixed headroom (here 150 tokens past the
    budget) drops no draft append and full budget still accepts 1.0."""
    eng = TEngine(TCFG, tparams, spec="snapkv", draft_budget=PREFIX,
                  window_size=16, device="cpu", **ENGINE_KW)
    out, counts, stats = t_spec(eng, prompt, gamma=3, max_new_tokens=150)
    assert eng.draft.size == PREFIX + eng.max_len - PREFIX
    assert int(counts.min()) >= 150
    assert stats.acceptance_rate == 1.0, stats
    ar, _ = t_ar(TEngine(TCFG, tparams, device="cpu", **ENGINE_KW), prompt, 150)
    np.testing.assert_array_equal(out[:, :150].numpy(), ar.numpy())


# a head_dim-128 model (the attention kernels' larger build): 2 layers, 4/2
# heads, dim 512
CFG128_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=4,
                 n_kv_head=2, dim=512, intermediate_size=256)


def test_head_dim_128_snapkv_stream_equals_jax_and_ar(prompt):
    """At head_dim 128 the port's SnapKV stream equals the JAX package's
    token for token and equals the port's own AR stream (invariant 1)."""
    jcfg, tcfg = JArgs(**CFG128_KW), TArgs(**CFG128_KW)
    assert tcfg.head_dim == jcfg.head_dim == 128
    jp = j_init(jax.random.PRNGKey(1), jcfg, jnp.float32, scale=0.5)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ar, _ = t_ar(TEngine(tcfg, tp, device="cpu", **ENGINE_KW), prompt, MAX_NEW)
    spec_kw = dict(spec="snapkv", draft_budget=32, window_size=8, **ENGINE_KW)
    out, counts, stats = t_spec(TEngine(tcfg, tp, device="cpu", **spec_kw),
                                prompt, gamma=3, max_new_tokens=MAX_NEW)
    jout, jcounts, jstats = j_spec(JEngine(jcfg, jp, **spec_kw),
                                   jnp.asarray(prompt), gamma=3,
                                   max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert stats.rounds == jstats.rounds
    for b in range(B):
        n = min(int(counts[b]), MAX_NEW)
        assert n > 0
        np.testing.assert_array_equal(out[b, :n].numpy(), ar[b, :n].numpy())
