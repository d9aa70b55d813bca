"""The port's SqueezedAttention path on the CPU against the JAX package.

The mass-threshold selection rule against the JAX function (exactly, on
tie-free data; where empty clusters tie at zero mass, the attended sets),
the live counts of the select function, and generate_selfspec(
spec="squeeze") token for token against the JAX package's and the port's
AR stream on the tail-covers path and on the fold path. float32, JAX
matmuls at "highest" precision (conftest.py). The model and sizes are those
of tests/test_squeeze.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.engine import retro as jretro
from magicdec_tpu.engine.squeeze import squeeze_select as j_select
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu_torch.engine import retro as tretro
from magicdec_tpu_torch.engine.squeeze import (squeeze_select,
                                               squeeze_select_fn)
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
# the model, prompt and AR fixtures and the stream check of the Retro tests
from test_torch_retro import (GAMMA, NEW, NEW_LONG, ar_tokens,  # noqa: F401
                              jparams, prompt, stream_vs_jax, tparams)

JCFG, TCFG = JArgs.from_name("test-tiny"), TArgs.from_name("test-tiny")


def _select_inputs(empty: bool):
    """tests/test_squeeze.py's oracle case (3 sequences, T=2, 8 clusters,
    max 4, threshold 0.12); with `empty`, five of one sequence's clusters
    have no members, so they tie at zero mass."""
    rng = np.random.default_rng(0)
    Bq, T, C = 3, 2, 8
    q = rng.normal(size=(Bq, T, JCFG.n_head, JCFG.head_dim)).astype(np.float32)
    cent = rng.normal(size=(Bq, C, JCFG.n_kv_head * JCFG.head_dim)).astype(
        np.float32)
    counts = rng.integers(1, 20, size=(Bq, C)).astype(np.float32)
    if empty:
        counts[1, 3:] = 0.0
    return q, cent, counts


@pytest.mark.parametrize("empty", [False, True])
def test_squeeze_select_matches_jax(empty):
    q, cent, counts = _select_inputs(empty)
    jt, jk = j_select(JCFG, jnp.asarray(q), jnp.asarray(cent),
                      jnp.asarray(counts), max_clusters=4, threshold=0.12)
    tt, tk = squeeze_select(TCFG, torch.from_numpy(q), torch.from_numpy(cent),
                            torch.from_numpy(counts), max_clusters=4,
                            threshold=0.12)
    jt, jk, tt, tk = np.asarray(jt), np.asarray(jk), tt.numpy(), tk.numpy()
    assert tt.dtype == np.int32 and tk.dtype == bool
    for b in range(3):
        # the attended clusters: a zero-mass tie may pick other indices
        assert set(tt[b][tk[b]]) == set(jt[b][jk[b]])
    if not empty:
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tk, jk)
        assert tk[:, 0].all() and not tk.all()
    else:
        assert tk[1].sum() <= 3


def test_squeeze_select_fn_reads_the_live_counts():
    """The select function reads counts when it runs, so an index fold
    (which advances counts in place) changes the next round's mass."""
    q, cent, counts = _select_inputs(False)
    tq = torch.from_numpy(q)
    cent_l = torch.from_numpy(cent)[None]                 # one layer
    live = torch.from_numpy(counts)[None].clone()
    select = squeeze_select_fn(TCFG, cent_l, live, max_clusters=4,
                               threshold=0.12)
    before = select(tq, 0)
    live[0, :, 2] += 500.0
    after = select(tq, 0)
    want = squeeze_select(TCFG, tq, cent_l[0], live[0], max_clusters=4,
                          threshold=0.12)
    for a, w in zip(after, want):
        assert torch.equal(a, w)
    assert not torch.equal(before[0], after[0])
    assert bool((after[0][:, 0] == 2).all())


@pytest.mark.parametrize("path", ["tail_covers", "fold"])
def test_squeeze_stream_equals_jax_and_ar(jparams, tparams, prompt, ar_tokens,
                                          monkeypatch, path):
    """tests/test_squeeze.py's settings (threshold 0.005) on the
    tail-covers path, and on the fold path with TAIL_COVERS_MAX lowered to 0
    in both packages (the mass then uses counts the fold advanced)."""
    if path == "fold":
        monkeypatch.setattr(jretro, "TAIL_COVERS_MAX", 0)
        monkeypatch.setattr(tretro, "TAIL_COVERS_MAX", 0)
        jax.clear_caches()      # a cached trace may hold the other constant
    new, latest_k = (NEW, 64) if path == "tail_covers" else (NEW_LONG, 32)
    eng, stats = stream_vs_jax("squeeze", jparams, tparams, prompt, ar_tokens,
                               new, latest_k, squeeze_threshold=0.005)
    assert 0.0 <= stats.acceptance_rate <= 1.0
    assert stats.rounds >= new // (GAMMA + 1)
    if path == "fold":
        jax.clear_caches()
        assert stats.compactions >= 1
