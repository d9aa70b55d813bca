"""The port's data parallelism (dp=2 x tp=2), sub-mesh and multi-host mesh
on the CPU against the JAX package.

One gloo world of four CPU ranks, started as two emulated hosts of two
ranks (parallel/launch.run_world with local_size=2, so its mesh is
make_multihost_mesh(2): dp over the hosts), runs tests/torch_tp_scenarios.
run_dp in every rank; the tests here assert on what the ranks return. The
model, sizes and settings are those of tests/test_sharding.py and
tests/test_torch_sharding.py: n_layer=2, n_head=8, n_kv_head=4, dim=128,
vocab 512, float32, B=4, P=64, 16 new tokens, prefill chunks of 32. Every
stream of the whole batch must equal the JAX package's single-device
stream token for token (tests/test_sharding.py holds those equal to its
dp=2 x tp=4 mesh's), on every rank; each rank's stream is gathered from
the two dp blocks of two rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.cache import KVCache as JKVCache
from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.spec import generate_selfspec as j_spec
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.parallel import sharding as jshard
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import generate_selfspec as t_spec
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy
from magicdec_tpu_torch.parallel.launch import run_world
# the model, prompt, cases and JAX streams of the tp=2 tests
from test_torch_sharding import (B, CASES, CFG_KW, ENGINE_KW, GAMMA, NEW,
                                 _jax_stream, _np_tree, cache_np,  # noqa: F401
                                 jparams, prompt)

import torch_tp_scenarios

torch.backends.cuda.matmul.allow_tf32 = False

WORLD, DP, TP, LOCAL = 4, 2, 2, 2
# CASES and a StreamingLLM draft whose window compacts (a 64-slot cache
# compacting past 56), so the compaction flag is taken over the dp ranks
DP_CASES = dict(CASES, streaming_compact=dict(
    spec="streaming", draft_budget=48, sink_size=4, draft_headroom=16))


@pytest.fixture(scope="module")
def world(jparams, prompt, cache_np, tmp_path_factory):
    """The four ranks' results, in rank order."""
    return run_world(
        torch_tp_scenarios.run_dp, tp=TP, backend="gloo",
        devices=["cpu"] * WORLD, local_size=LOCAL,
        args=(CFG_KW, _np_tree(jparams), prompt),
        kwargs=dict(new=NEW, gamma=GAMMA, engine_kw=ENGINE_KW,
                    cases=DP_CASES, cache_np=cache_np),
        rendezvous_dir=str(tmp_path_factory.mktemp("rendezvous")),
        timeout_s=300)


_JAX_RUNS = {}


def _jax_run(name, jparams, prompt):
    """The JAX package's single-device (stream, counts, rounds, accepted
    drafts) of run `name` (AR and longspec: counts, rounds and accepted
    None), computed once for the module's tests."""
    if name not in _JAX_RUNS:
        if name in DP_CASES:
            eng = JEngine(JArgs(**CFG_KW), jparams, **ENGINE_KW,
                          **DP_CASES[name])
            out, counts, stats = j_spec(eng, jnp.asarray(prompt), gamma=GAMMA,
                                        max_new_tokens=NEW)
            _JAX_RUNS[name] = (np.asarray(out), np.asarray(counts),
                               stats.rounds, stats.total_accepted_drafts)
        else:
            _JAX_RUNS[name] = (*_jax_stream(name, jparams, prompt), None,
                               None)
    return _JAX_RUNS[name]


def test_mesh_layouts(world):
    """Rank r of a dp x tp grid has dp index r // tp and tp index r % tp
    (JAX's reshape(dp, tp)); the sub-mesh is ranks 0-1; the multi-host
    mesh's dp index is the host (rank // LOCAL); with one rank a host,
    each host's first rank."""
    for r, res in enumerate(world):
        lay = res["layout"]
        assert lay["grid"] == (DP, r // TP, TP, r % TP)
        assert lay["multihost"] == (WORLD // LOCAL, r // LOCAL, TP, r % LOCAL)
        assert lay["sub"] == ((1, 0, TP, r) if r < TP else None)
        assert lay["hosts"] == ((WORLD // LOCAL, r // LOCAL, 1, 0)
                                if r % LOCAL == 0 else None)


def test_cache_shards_equal_jax_blocks_on_the_grid(world, cache_np):
    """shard_cache on the dp=2 x tp=2 grid gives each rank the block the
    JAX package's cache_pspec gives its device: B/dp rows (of the lengths
    too) and (Hkv/tp)*D columns."""
    mesh = jshard.make_mesh(dp=DP, tp=TP)
    jc = jshard.shard_cache(JKVCache(*(jnp.asarray(x) for x in cache_np)),
                            mesh)
    for r, res in enumerate(world):
        dev = mesh.devices[r // TP, r % TP]
        for name in ("k", "v", "lengths"):
            (shard,) = [s for s in getattr(jc, name).addressable_shards
                        if s.device == dev]
            np.testing.assert_array_equal(res["cache_shard"][name],
                                          np.asarray(shard.data))


@pytest.mark.parametrize("name", ["ar"] + list(DP_CASES) + ["longspec"])
def test_dp_tp_stream_equals_jax_single_device(world, jparams, prompt, name):
    """The dp=2 x tp=2 grid: the gathered stream and counts equal the JAX
    package's single-device ones on all four ranks, and each speculative
    stream is the AR stream (invariant 1)."""
    ref, ref_counts, _, _ = _jax_run(name, jparams, prompt)
    for res in world:
        np.testing.assert_array_equal(res[name]["out"], ref)
        if ref_counts is not None:
            np.testing.assert_array_equal(res[name]["counts"], ref_counts)
    if name != "ar":
        ar = world[0]["ar"]["out"]
        for b in range(B):
            n = min(int(world[0][name]["counts"][b]), NEW)
            np.testing.assert_array_equal(world[0][name]["out"][b, :n],
                                          ar[b, :n])


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_tp_spec_stats_equal_jax(world, jparams, prompt, name):
    """Every rank runs the rounds of the whole batch: rounds and accepted
    drafts equal the JAX package's single-device stats, and the
    compactions the port's single-device run's (the JAX stats do not count
    them)."""
    _, _, rounds, accepted = _jax_run(name, jparams, prompt)
    single = TEngine(TArgs(**CFG_KW), params_from_numpy(
        _np_tree(jparams), device="cpu"), device="cpu", **ENGINE_KW,
        **DP_CASES[name])
    _, _, stats = t_spec(single, prompt, GAMMA, NEW)
    assert (stats.rounds, stats.total_accepted_drafts) == (rounds, accepted)
    for res in world:
        got = res[name]
        assert (got["rounds"], got["accepted"], got["compactions"]) == (
            rounds, accepted, stats.compactions)
    if name == "streaming_compact":
        assert stats.compactions >= 1


def test_longspec_full_acceptance_and_draft_rows(world):
    """The asymmetric longspec on the grid: the self-draft, replicated over
    tp, holds the rank's B/dp rows and accepts exactly 1.0."""
    for res in world:
        assert res["longspec"]["acceptance"] == 1.0
        assert res["longspec"]["draft_rows"] == B // DP


@pytest.mark.parametrize("name", ["multihost_ar", "multihost_snapkv",
                                  "sub_ar", "hosts_ar"])
def test_other_meshes_equal_jax_single_device(world, jparams, prompt, name):
    """The multi-host mesh (two emulated hosts, tp=2 a host), the sub-mesh
    of ranks 0-1 and the tp=1 host mesh (dp over the hosts alone) give the
    JAX package's single-device streams; ranks outside a mesh return
    None."""
    ref = _jax_run("snapkv" if name.endswith("snapkv") else "ar", jparams,
                   prompt)[0]
    ranks = {"sub_ar": range(TP), "hosts_ar": range(0, WORLD, LOCAL)}.get(
        name, range(WORLD))
    for r, res in enumerate(world):
        if r in ranks:
            np.testing.assert_array_equal(res[name]["out"], ref)
        else:
            assert res[name] is None
