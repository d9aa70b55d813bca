"""The port's tensor parallelism on the CPU against the JAX package.

One gloo world of tp=2 CPU ranks (parallel/launch.run_world, one per
module) runs every scenario of tests/torch_tp_scenarios.py, a module the
ranks import without JAX, and returns its results; the tests here assert on
them. The model, sizes and settings are those of tests/test_sharding.py:
n_layer=2, n_head=8, n_kv_head=4, dim=128, vocab 512, float32, B=4, P=64,
16 new tokens, prefill chunks of 32. JAX runs in this process at "highest"
precision (conftest.py), TF32 is off in torch. The port's tp=2 streams must
equal the JAX package's single-device streams token for token (which
tests/test_sharding.py holds equal to its mesh streams), and every rank
must return the same ones. The world also runs GliDe (linear and a (2, 2)
tree) and int8 and int4 weights (a model of dim 256, whose row-parallel
shards hold whole 128-row int4 groups) against the JAX package's
single-device streams: the JAX package runs GliDe on a mesh through dense
GSPMD, and its param_pspecs would cut a quantized leaf along the wrong axis,
so its single-device streams are the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.cache import KVCache as JKVCache
from magicdec_tpu.engine import attention_impls as jimpls
from magicdec_tpu.engine import glide_engine as jge
from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.longspec import LongSpecEngine as JLongSpec
from magicdec_tpu.engine.spec import (generate_autoregressive as j_ar,
                                      generate_selfspec as j_spec)
from magicdec_tpu.models import glide as jglide
from magicdec_tpu.models import llama as jllama
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.parallel import sharding as jshard
from magicdec_tpu.quant import int8 as jq
from magicdec_tpu_torch.engine import attention_impls as timpls
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine import offload
from magicdec_tpu_torch.engine.retro import _tail_attend
from magicdec_tpu_torch.models import llama as tllama
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy
from magicdec_tpu_torch.ops import flash_decode as tfd
from magicdec_tpu_torch.ops.gemm_softmax import (centroid_scores,
                                                 centroid_scores_sharded)
from magicdec_tpu_torch.ops.page_gather import (page_gather,
                                                page_gather_sharded,
                                                page_gather_single,
                                                page_gather_single_sharded)
from magicdec_tpu_torch.parallel import collectives, sharding
from magicdec_tpu_torch.parallel.launch import run_world
from magicdec_tpu_torch.quant.int8 import (Int4ColWeight, dequantize_int8,
                                           quantize_params)

import torch_tp_scenarios

torch.backends.cuda.matmul.allow_tf32 = False

TP = 2
CFG_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=8,
              n_kv_head=4, dim=128, intermediate_size=256)
PAD_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=6,
              n_kv_head=3, dim=192, intermediate_size=256)
B, P, NEW, GAMMA = 4, 64, 16, 2
ENGINE_KW = dict(batch_size=B, max_len=128, prefill_chunk=32)
# the self-speculation runs; snapkv_full's budget is the whole prefix
CASES = {
    "snapkv": dict(spec="snapkv", draft_budget=32, window_size=8),
    "snapkv_full": dict(spec="snapkv", draft_budget=P, window_size=8),
    "streaming": dict(spec="streaming", draft_budget=48, sink_size=4),
    "quest": dict(spec="quest", draft_budget=48, latest_k=16, quest_page=16),
    "retro": dict(spec="retro", draft_budget=48, latest_k=16, retro_cap=16),
    "squeeze": dict(spec="squeeze", draft_budget=48, latest_k=16,
                    retro_cap=16),
}
# RetroInfer's fold path: enough tokens for the tail to compact
FOLD_NEW = 40
# the quantized runs' model: wo's K (256) and w_down's (512) cut in two
# keep whole 128-row int4 groups
QUANT_KW = dict(block_size=512, vocab_size=512, n_layer=2, n_head=8,
                n_kv_head=4, dim=256, intermediate_size=512)
QUANT_BUDGETS = (32, P)
# first-step logits against JAX's mesh run: the two sides sum the
# row-parallel partials in other orders (f32 rounding, ~1e-7 relative)
LOGIT_REL = 1e-5


def _jparams(kw, seed):
    return jllama.init_params(jax.random.PRNGKey(seed), JArgs(**kw),
                              jnp.float32, scale=0.5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return _jparams(CFG_KW, 0)


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(3).integers(
        0, CFG_KW["vocab_size"], size=(B, P)).astype(np.int32)


@pytest.fixture(scope="module")
def padded_inputs():
    params = _jparams(PAD_KW, 1)
    prompt = np.random.default_rng(5).integers(
        0, PAD_KW["vocab_size"], size=(B, P)).astype(np.int32)
    return params, prompt


@pytest.fixture(scope="module")
def cache_np():
    rng = np.random.default_rng(11)
    shape = (2, B, 128, CFG_KW["n_kv_head"] * 16)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            np.asarray([64, 70, 3, 128], np.int32))


@pytest.fixture(scope="module")
def jglide_params():
    return jglide.init_glide_params(jax.random.PRNGKey(5), JArgs(**CFG_KW),
                                    scale=0.3)


def _portable(tree):
    """A JAX params tree as numpy for the ranks, which must not import the
    JAX package: its Int4ColWeight becomes the port's, holding numpy arrays
    (llama.params_from_numpy reads either)."""
    if isinstance(tree, jq.Int4ColWeight):
        return Int4ColWeight(np.asarray(tree.q4), np.asarray(tree.s4),
                             tuple(tree.out_shape))
    if isinstance(tree, dict):
        return {k: _portable(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


@pytest.fixture(scope="module")
def quant_inputs():
    """The quantized model's whole JAX params per mode and its prompt."""
    base = jllama.init_params(jax.random.PRNGKey(6), JArgs(**QUANT_KW),
                              jnp.float32, scale=0.3)
    prompt = np.random.default_rng(7).integers(
        0, QUANT_KW["vocab_size"], size=(B, P)).astype(np.int32)
    return {m: jq.quantize_params(base, m) for m in ("int8", "int4")}, prompt


@pytest.fixture(scope="module")
def world(jparams, prompt, padded_inputs, cache_np, jglide_params,
          quant_inputs, tmp_path_factory):
    """Both ranks' results of every scenario, in rank order."""
    pparams, pprompt = padded_inputs
    qparams, qprompt = quant_inputs
    quant = (QUANT_KW, {m: _portable(p) for m, p in qparams.items()}, qprompt,
             QUANT_BUDGETS)
    return run_world(
        torch_tp_scenarios.run, tp=TP, backend="gloo", devices=["cpu"] * TP,
        args=(CFG_KW, _np_tree(jparams), prompt),
        kwargs=dict(new=NEW, gamma=GAMMA, engine_kw=ENGINE_KW, cases=CASES,
                    padded=(PAD_KW, _np_tree(pparams), pprompt),
                    cache_np=cache_np, fold_new=FOLD_NEW,
                    glide_np=_portable(jglide_params), quant=quant),
        rendezvous_dir=str(tmp_path_factory.mktemp("rendezvous")),
        timeout_s=300)


def _jax_stream(name, jparams, prompt):
    cfg = JArgs(**CFG_KW)
    if name == "ar":
        out, _ = j_ar(JEngine(cfg, jparams, **ENGINE_KW), jnp.asarray(prompt),
                      NEW)
        return np.asarray(out), None
    if name == "longspec":
        out, counts, _ = JLongSpec(
            JEngine(cfg, jparams, **ENGINE_KW),
            JEngine(cfg, jparams, **ENGINE_KW)).generate(
                jnp.asarray(prompt), gamma=GAMMA, max_new_tokens=NEW)
        return np.asarray(out), np.asarray(counts)
    out, counts, _ = j_spec(JEngine(cfg, jparams, **ENGINE_KW, **CASES[name]),
                            jnp.asarray(prompt), gamma=GAMMA,
                            max_new_tokens=NEW)
    return np.asarray(out), np.asarray(counts)


@pytest.mark.parametrize("name", ["ar"] + list(CASES) + ["longspec"])
def test_tp_stream_equals_jax_single_device(world, jparams, prompt, name):
    ref, ref_counts = _jax_stream(name, jparams, prompt)
    for res in world:
        got = res[name]
        np.testing.assert_array_equal(got["out"], ref)
        if ref_counts is not None:
            np.testing.assert_array_equal(got["counts"], ref_counts)
    if name != "ar":        # invariant 1 inside the port: lossless
        ar = world[0]["ar"]["out"]
        for b in range(B):
            n = min(int(world[0][name]["counts"][b]), NEW)
            np.testing.assert_array_equal(world[0][name]["out"][b, :n],
                                          ar[b, :n])


def test_full_budget_accepts_exactly_one(world):
    for res in world:
        assert res["snapkv_full"]["acceptance"] == 1.0
        assert res["longspec"]["acceptance"] == 1.0     # the self-draft


def test_longspec_draft_is_replicated(world):
    for res in world:
        assert res["longspec"]["draft_heads"] == CFG_KW["n_kv_head"]
        assert res["longspec"]["target_heads"] == CFG_KW["n_kv_head"] // TP


def test_longspec_verifies_rank0s_draft_tokens(world):
    """Rank 1's replicated draft is skewed, rank 0's is the self-draft: with
    rank 0's tokens broadcast, both ranks verify the self-draft's tokens, so
    both accept exactly 1.0 and emit the AR stream."""
    ar = world[0]["ar"]["out"]
    for res in world:
        got = res["longspec_skewed"]
        assert got["acceptance"] == 1.0
        for b in range(B):
            n = min(int(got["counts"][b]), NEW)
            np.testing.assert_array_equal(got["out"][b, :n], ar[b, :n])


@pytest.mark.parametrize("snapkv", [False, True], ids=["ar", "snapkv"])
def test_first_step_logits_agree_with_jax_mesh(world, jparams, prompt, snapkv):
    cfg = JArgs(**CFG_KW)
    mesh = jshard.make_mesh(dp=1, tp=TP)
    kw = CASES["snapkv"] if snapkv else {}
    eng = JEngine(cfg, jparams, mesh=mesh, **ENGINE_KW, **kw)
    tok = eng.encode(jnp.asarray(prompt))
    if snapkv:
        impl = jimpls.snapkv_draft_attn(cfg, eng.cache.lengths,
                                        eng.draft.lengths, mesh=mesh)
        caches = (eng.draft.k, eng.draft.v)
    else:
        impl = jimpls.target_attn(cfg, eng.cache.lengths, mesh=mesh)
        caches = (eng.cache.k, eng.cache.v)
    logits, _ = jllama.forward(eng.params, cfg, tok, impl, caches,
                               fused=False)
    ref = np.asarray(logits)[:, 0]
    key = "snapkv_logits" if snapkv else "ar_logits"
    for res in world:
        err = np.abs(res[key] - ref).max()
        assert err <= LOGIT_REL * np.abs(ref).max(), err
    np.testing.assert_array_equal(world[0][key], world[1][key])


@pytest.mark.parametrize("branching", [None, (2, 2)],
                         ids=["linear", "tree_2_2"])
def test_tp_glide_equals_jax_single_device(world, jparams, jglide_params,
                                           prompt, branching):
    """GliDe under tp=2 (the block cut as a target layer, the own cache on
    the rank's heads): the stream, counts, rounds and accepted drafts equal
    the JAX package's single-device GlideEngine's, on both ranks, and the
    stream is the tp AR stream (exact in float32 for the tree too)."""
    name = "glide_linear" if branching is None else "glide_tree"
    jtree = None if branching is None else jge.SpecTree(branching)
    eng = jge.GlideEngine(JEngine(JArgs(**CFG_KW), jparams, **ENGINE_KW),
                          jglide_params)
    jout, jcounts, jstats = eng.generate(jnp.asarray(prompt), NEW,
                                         gamma=GAMMA, tree=jtree)
    ar = world[0]["ar"]["out"]
    for res in world:
        got = res[name]
        np.testing.assert_array_equal(got["out"], np.asarray(jout))
        np.testing.assert_array_equal(got["counts"], np.asarray(jcounts))
        assert (got["rounds"], got["accepted"]) == (
            jstats.rounds, jstats.total_accepted_drafts)
        assert got["own_heads"] == CFG_KW["n_kv_head"] // TP
        assert got["lengths_equal"]
        n = min(int(got["counts"].min()), NEW)
        np.testing.assert_array_equal(got["out"][:, :n], ar[:, :n])


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_tp_quantized_streams_equal_jax_single_device(world, quant_inputs,
                                                      mode):
    """int8 and int4 weights cut for tp=2 in their stored layouts: AR and
    SnapKV (budget 32 and the whole prefix) equal the JAX package's
    single-device quantized streams on both ranks, with float32 caches; the
    SnapKV streams are the tp AR stream and full budget accepts 1.0."""
    qparams, qprompt = quant_inputs
    cfg = JArgs(**QUANT_KW)
    kw = dict(ENGINE_KW, kv_dtype=jnp.float32)
    jar, _ = j_ar(JEngine(cfg, qparams[mode], **kw), jnp.asarray(qprompt),
                  NEW)
    for res in world:
        np.testing.assert_array_equal(res[f"{mode}_ar"]["out"],
                                      np.asarray(jar))
    for budget in QUANT_BUDGETS:
        jout, jcounts, _ = j_spec(
            JEngine(cfg, qparams[mode], spec="snapkv", draft_budget=budget,
                    window_size=8, **kw),
            jnp.asarray(qprompt), gamma=GAMMA, max_new_tokens=NEW)
        for res in world:
            got = res[f"{mode}_snapkv_{budget}"]
            np.testing.assert_array_equal(got["out"], np.asarray(jout))
            np.testing.assert_array_equal(got["counts"], np.asarray(jcounts))
            np.testing.assert_array_equal(got["out"][:, :NEW],
                                          res[f"{mode}_ar"]["out"])
            if budget == P:
                assert got["acceptance"] == 1.0


def _dequantized(w) -> torch.Tensor:
    """A stored quantized layer weight as float32 in its [L, K, *out]
    layout: the int8 dict through dequantize_int8, an Int4ColWeight from
    its biased nibbles (n low, n + N/2 high) and its group scales."""
    if isinstance(w, dict):
        return dequantize_int8(w, torch.float32)
    qu = w.q4.view(torch.uint8)
    codes = torch.cat([qu & 0xF, qu >> 4], dim=-1).float() - 8.0
    L, K, N = codes.shape
    groups = w.s4.shape[1]
    wf = (codes.reshape(L, groups, K // groups, N) * w.s4[:, :, None]
          ).reshape(L, K, N)
    return wf.reshape(L, K, *w.out_shape)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_shards_dequantize_to_the_whole_weights_blocks(
        quant_inputs, mode):
    """Each rank's shard of each quantized leaf, dequantized, equals the
    rank's block of the whole dequantized weight: the output block of a
    column-parallel leaf (wqkv; w_gate_up's gate and up blocks), the K block
    of a row-parallel one (wo, w_down)."""
    qparams, _ = quant_inputs
    whole = params_from_numpy(_portable(qparams[mode]), device="cpu")
    cfg = TArgs(**QUANT_KW)
    cuts = {"wqkv": -1, "w_gate_up": -1, "wo": 1, "w_down": 1}
    for r in range(TP):
        shard = sharding.shard_params(whole, _cpu_mesh(r), cfg)["layers"]
        for name, axis in cuts.items():
            full = _dequantized(whole["layers"][name])
            n = full.shape[axis] // TP
            want = full.narrow(axis, r * n, n)
            got = _dequantized(shard[name])
            assert type(shard[name]) is type(whole["layers"][name])
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def _jax_block(x, mesh, rank):
    """The block of a JAX array that the mesh's tp rank `rank` holds."""
    dev = mesh.devices[0, rank]
    (shard,) = [s for s in x.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def test_param_and_cache_shards_equal_jax_blocks(world, jparams, cache_np):
    mesh = jshard.make_mesh(dp=1, tp=TP)
    jp = jshard.shard_params(jparams, mesh, JArgs(**CFG_KW))
    jc = jshard.shard_cache(JKVCache(*(jnp.asarray(x) for x in cache_np)),
                            mesh)
    for res in world:
        r = res["rank"]
        got = res["shards"]
        for name in ("tok_embeddings", "norm", "output"):
            np.testing.assert_array_equal(got[name], _jax_block(jp[name],
                                                                mesh, r))
        for name, w in jp["layers"].items():
            np.testing.assert_array_equal(got["layers"][name],
                                          _jax_block(w, mesh, r))
        for name in ("k", "v", "lengths"):
            np.testing.assert_array_equal(res["cache_shard"][name],
                                          _jax_block(getattr(jc, name), mesh, r))
    assert world[0]["shards"]["layers"]["wqkv"].shape[-1] == (
        (8 + 2 * 4) * 16 // TP)


def test_kmeans_slots_equal_across_ranks_and_single_device(world, jparams,
                                                           prompt):
    eng = TEngine(TArgs(**CFG_KW), params_from_numpy(_np_tree(jparams),
                                                     device="cpu"),
                  device="cpu", **ENGINE_KW, **CASES["retro"])
    eng.encode(prompt)
    single = eng.spec_index[1].numpy()
    for res in world:
        np.testing.assert_array_equal(res["retro"]["cluster_slots"], single)


def test_retro_fold_keeps_the_ranks_index_equal(world):
    """On the fold path each compaction assigns the aged rows by distances
    all-reduced over the ranks: the ranks' cluster slots stay equal, and
    the stream stays the AR stream."""
    fold = [res["retro_fold"] for res in world]
    assert fold[0]["compactions"] >= 1
    np.testing.assert_array_equal(fold[0]["cluster_slots"],
                                  fold[1]["cluster_slots"])
    np.testing.assert_array_equal(fold[0]["out"], fold[1]["out"])
    ar = world[0]["ar"]["out"]
    for b in range(B):
        n = min(int(fold[0]["counts"][b]), NEW)
        np.testing.assert_array_equal(fold[0]["out"][b, :n], ar[b, :n])


def test_pad_model_for_tp_equals_jax_and_keeps_the_stream(world,
                                                          padded_inputs):
    params, prompt = padded_inputs
    jpad, jcfg = jshard.pad_model_for_tp(params, JArgs(**PAD_KW), TP)
    tpad, tcfg = sharding.pad_model_for_tp(
        params_from_numpy(_np_tree(params), device="cpu"), TArgs(**PAD_KW), TP)
    assert (tcfg.n_kv_head, tcfg.n_head, tcfg.head_dim) == (
        jcfg.n_kv_head, jcfg.n_head, jcfg.head_dim) == (4, 8, 32)
    for name, w in jpad["layers"].items():
        np.testing.assert_array_equal(tpad["layers"][name].numpy(),
                                      np.asarray(w))
    ref, _ = j_ar(JEngine(JArgs(**PAD_KW), params, **ENGINE_KW),
                  jnp.asarray(prompt), NEW)
    for res in world:
        np.testing.assert_array_equal(res["padded_ar"], np.asarray(ref))


def _cpu_mesh(rank=0, tp=TP):
    """A rank's Mesh without a process group: enough for what makes no
    collective (shard_params, local_config, the per-shard forms)."""
    return sharding.Mesh(tp=tp, rank=rank, backend="gloo",
                         device=torch.device("cpu"))


def test_refusals(jparams, tmp_path):
    """What stays refused: a mesh larger than the world, a batch that does
    not divide dp, an int4 row-parallel shard that would split a 128-row
    scale group, offload on a mesh and the fused block under tp (as the
    JAX package: its offload takes no mesh, its fused_for_mesh keeps the
    block off), and KV heads that do not divide tp (pad_model_for_tp)."""
    import torch.distributed as dist

    tparams = params_from_numpy(_np_tree(jparams), device="cpu")
    cfg = TArgs(**CFG_KW)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs dp\\*tp ranks"):
            sharding.make_mesh(dp=2, tp=TP, device="cpu")
    finally:
        dist.destroy_process_group()
    dp_mesh = sharding.Mesh(tp=1, rank=0, backend="gloo",
                            device=torch.device("cpu"), dp=2)
    with pytest.raises(ValueError, match="does not divide dp=2"):
        TEngine(cfg, tparams, mesh=dp_mesh, **dict(ENGINE_KW, batch_size=3))
    with pytest.raises(ValueError, match="does not divide dp=2"):
        sharding.shard_tokens(torch.zeros((3, 4)), dp_mesh)
    with pytest.raises(ValueError, match="128-row scale group"):
        sharding.shard_params(quantize_params(tparams, "int4"), _cpu_mesh(),
                              cfg)
    local = sharding.local_config(cfg, _cpu_mesh())
    with pytest.raises(NotImplementedError, match="tensor-parallel mesh"):
        offload.offload_prefill(tparams, local, None, np.zeros((B, P)),
                                n_clusters=4, cap=16, tail_keep=16,
                                device="cpu")
    with pytest.raises(ValueError, match="fused decode block"):
        tllama.run_layers(tparams, local, torch.zeros((64, cfg.dim)), None,
                          (), 1, 1, fused=True)
    uneven = TArgs(**PAD_KW)
    pparams = params_from_numpy(_np_tree(_jparams(PAD_KW, 1)), device="cpu")
    with pytest.raises(ValueError, match="pad_model_for_tp"):
        TEngine(uneven, pparams, mesh=_cpu_mesh(), **ENGINE_KW)


def test_collectives_at_tp1_return_their_input():
    x = torch.arange(6.0).reshape(2, 3)
    for mesh in (None, _cpu_mesh(tp=1)):
        assert collectives.all_reduce_tp(x, mesh) is x
        assert collectives.all_gather_tp(x, mesh) is x
        assert collectives.broadcast_tp(x, mesh) is x


@pytest.mark.parametrize("tp", [2, 3])
def test_collectives_in_a_cpu_world(tp, tmp_path):
    """Every rank gets the same sum, in rank order above tp=2 (the ranks'
    values differ in magnitude, so another order gives other float32
    bits), only the reduced rows change; the gather concatenates in rank
    order; the broadcast is rank 0's."""
    res = run_world(torch_tp_scenarios.collectives, tp=tp, backend="gloo",
                    devices=["cpu"] * tp, rendezvous_dir=str(tmp_path),
                    timeout_s=120)
    parts = [torch_tp_scenarios._rank_values(r) for r in range(tp)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    for r in res:
        np.testing.assert_array_equal(r["reduce"][:5], total.numpy())
        np.testing.assert_array_equal(r["reduce"][5:], -1.0)
        np.testing.assert_array_equal(r["gather"],
                                      torch.cat(parts, dim=1).numpy())
        np.testing.assert_array_equal(r["bcast"], 0.0)


def _shards(t, tp, axis):
    return [c.contiguous() for c in torch.chunk(t, tp, dim=axis)]


def test_sharded_forms_concatenate_to_the_whole_on_the_cpu():
    """Each per-shard form on each rank's contiguous shard (its plain
    version on the CPU) gives the whole tensor's output's block; the
    partition they run on is checked once, by local_config: whole GQA
    groups, head_dim kept."""
    rng = np.random.default_rng(2)
    L, Bk, S, Hkv, G, D, T = 2, 2, 256, 4, 2, 16, 3
    q = torch.from_numpy(rng.standard_normal((Bk, T, Hkv * G, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((L, Bk, S, Hkv * D))
                             .astype(np.float32)) for _ in range(2))
    valid = torch.tensor([[100, 101, 102], [7, 8, 9]], dtype=torch.int32)
    qs, ks, vs = _shards(q, TP, 2), _shards(k, TP, 3), _shards(v, TP, 3)

    def cat(fn, axis):
        return torch.cat([fn(r) for r in range(TP)], dim=axis)

    whole = tfd.flash_decode_stacked(q, k, v, 1, valid)
    got = cat(lambda r: timpls._flash_stacked(
        qs[r], ks[r], vs[r], 1, valid, _cpu_mesh(r)), 2)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    cfg = TArgs(**CFG_KW)
    local = sharding.local_config(cfg, _cpu_mesh())
    assert (local.n_head, local.n_kv_head, local.head_dim, local.mesh.tp) == (
        cfg.n_head // TP, cfg.n_kv_head // TP, cfg.head_dim, TP)
    assert local.n_kv_head * local.head_dim * TP == cfg.n_kv_head * cfg.head_dim

    ctx, m_, l_ = tfd.flash_decode_stacked(q, k, v, 1, valid,
                                           return_lse=True)
    for i, part in enumerate((ctx, m_, l_)):
        got = cat(lambda r: timpls.flash_stacked_lse(
            qs[r], ks[r], vs[r], 1, valid, mesh=_cpu_mesh(r))[i], 2)
        torch.testing.assert_close(got, part, rtol=0, atol=0)

    q32 = torch.from_numpy(rng.standard_normal((Bk, 32, Hkv * G, D))
                           .astype(np.float32))
    val32 = torch.from_numpy(np.stack([np.arange(33, 65), np.arange(1, 33)])
                             .astype(np.int32))
    whole = tfd.flash_prefill(q32, k, v, 0, val32, s_cap=128)
    got = cat(lambda r: timpls._flash_prefill_dispatch(
        _shards(q32, TP, 2)[r], ks[r], vs[r], 0, val32, _cpu_mesh(r),
        s_cap=128), 2)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)

    a, lo = torch.zeros_like(valid), torch.full_like(valid, 5)
    whole = tfd.flash_decode_intervals(q, k[0], v[0], a + 4, lo, valid)
    got = cat(lambda r: timpls._flash_intervals(
        qs[r], ks[r][0], vs[r][0], a + 4, lo, valid, _cpu_mesh(r)), 2)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)

    cm = torch.from_numpy((rng.random((L, Bk, 1, S)) < 0.7).astype(np.int32))
    q1, q1s = q[:, :1].contiguous(), _shards(q[:, :1], TP, 2)
    ns, hi = torch.full((Bk, 1), 96, dtype=torch.int32), valid[:, :1]
    whole = tfd.flash_decode_stacked_masked(q1, k, v, 1, cm, ns, ns, hi)
    got = cat(lambda r: _tail_attend(q1s[r], ks[r], vs[r], cm, 1, ns, hi,
                                     _cpu_mesh(r)), 2)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)

    pages = torch.tensor([[3, 0, 15], [7, 7, 1]], dtype=torch.int32)
    whole = page_gather(k, v, 1, pages, 16)
    got = [cat(lambda r: page_gather_sharded(
        ks[r], vs[r], 1, pages, 16, mesh=_cpu_mesh(r))[i], 3)
           for i in range(2)]
    for g, w in zip(got, whole):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    whole = page_gather_single(k, 1, pages, 16)
    got = cat(lambda r: page_gather_single_sharded(
        ks[r], 1, pages, 16, mesh=_cpu_mesh(r)), 3)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)

    cent = torch.from_numpy(rng.standard_normal((Bk, Hkv, 9, D)).astype(np.float32))
    whole = centroid_scores(q, cent)
    cs = _shards(cent, TP, 1)
    got = cat(lambda r: centroid_scores_sharded(
        qs[r], cs[r], mesh=_cpu_mesh(r)), 1)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
