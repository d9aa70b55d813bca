"""The port's two-model speculative decoding on the CPU against the JAX
package: the five cases of tests/test_longspec.py, each also token for token
equal to the JAX LongSpecEngine's stream, with equal counts, rounds and
accepted drafts.

Invariants, as in the JAX tests: the emitted tokens are the target's own
greedy stream whatever the draft, and a self-draft (the target's weights)
over its full KV cache, or at a SnapKV budget that keeps every key, accepts
exactly 1.0. float32, JAX matmuls at "highest" precision (conftest.py),
TF32 off in torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.longspec import LongSpecEngine as JLongSpec
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.models.llama import init_params as j_init
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.longspec import LongSpecEngine as TLongSpec
from magicdec_tpu_torch.engine.spec import generate_autoregressive
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False

DRAFT_KW = dict(n_layer=1, dim=64, n_head=2, n_kv_head=1,
                intermediate_size=128)
JT, TT = JArgs.from_name("test-tiny"), TArgs.from_name("test-tiny")
JD, TD = JT.replace(**DRAFT_KW), TT.replace(**DRAFT_KW)
B, P, NEW, GAMMA = 2, 256, 24, 3


def _both(key, jcfg):
    jp = j_init(jax.random.PRNGKey(key), jcfg, jnp.float32, scale=0.3)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def setup():
    jt, tt = _both(0, JT)
    jd, td = _both(7, JD)
    prompt = np.random.default_rng(1).integers(
        0, JT.vocab_size, size=(B, P)).astype(np.int32)
    eng = TEngine(TT, tt, batch_size=B, max_len=P + NEW + 16,
                  prefill_chunk=128, device="cpu")
    base, _ = generate_autoregressive(eng, prompt, NEW)
    return dict(target=(jt, tt), draft=(jd, td), prompt=prompt,
                base=base.numpy())


def _engines(mk, tcfg, tparams, dcfg, dparams, spec, budget, **dev):
    target = mk(tcfg, tparams, batch_size=B, max_len=P + NEW + 16,
                prefill_chunk=128, **dev)
    draft = mk(dcfg, dparams, batch_size=B, max_len=P + NEW + GAMMA + 16,
               spec=spec, draft_budget=budget or 0, window_size=16,
               prefill_chunk=128, **dev)
    return target, draft


def _run(setup, self_draft, spec, budget):
    """The port's and the JAX package's streams for one case; returns the
    port's stats after checking both against each other and the AR stream."""
    jt, tt = setup["target"]
    jd, td = setup["target"] if self_draft else setup["draft"]
    jdc, tdc = (JT, TT) if self_draft else (JD, TD)
    prompt = setup["prompt"]
    t_eng = TLongSpec(*_engines(TEngine, TT, tt, tdc, td, spec, budget,
                                device="cpu"))
    out, counts, stats = t_eng.generate(prompt, GAMMA, NEW)
    out, counts = out.numpy(), counts.numpy()
    j_eng = JLongSpec(*_engines(JEngine, JT, jt, jdc, jd, spec, budget))
    jout, jcounts, jstats = j_eng.generate(jnp.asarray(prompt), GAMMA, NEW)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert stats.rounds == jstats.rounds
    assert stats.total_accepted_drafts == jstats.total_accepted_drafts
    n = min(int(counts.min()), NEW)
    np.testing.assert_array_equal(out[:, :n], setup["base"][:, :n])
    if spec is not None:     # the draft's full prefill cache was freed
        assert t_eng.draft.cache is None
    return stats


def test_self_draft_full_kv_accepts_everything(setup):
    assert _run(setup, True, None, None).acceptance_rate == 1.0


def test_small_draft_full_kv_lossless(setup):
    stats = _run(setup, False, None, None)
    assert 0.0 <= stats.acceptance_rate <= 1.0


def test_small_draft_snapkv_budget_lossless(setup):
    _run(setup, False, "snapkv", 128)


def test_small_draft_streaming_budget_lossless(setup):
    _run(setup, False, "streaming", 128)


def test_self_draft_snapkv_full_budget_accepts_everything(setup):
    """Compressed-mode plumbing: budget == prefix keeps every key, so a
    self-draft still accepts everything."""
    assert _run(setup, True, "snapkv", P).acceptance_rate == 1.0


def test_longspec_rejects_mismatched_engines(setup):
    _, tt = setup["target"]
    target = TEngine(TT, tt, batch_size=B, max_len=P + NEW + 16,
                     device="cpu")
    draft = TEngine(TT, tt, batch_size=B + 1, max_len=P + NEW + 16,
                    device="cpu")
    with pytest.raises(ValueError, match="batch"):
        TLongSpec(target, draft)
