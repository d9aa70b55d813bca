"""The scenarios that tests/test_torch_sharding.py runs in each rank of a
tp=2 gloo world of CPU processes, and tests/test_torch_sharding_dp.py in
each rank of a four-rank world (two emulated hosts of two ranks: dp=2 x
tp=2) (parallel/launch.run_world). This module imports torch and the port
only: the spawned ranks import it by name, and they must not load JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine import retro
from magicdec_tpu_torch.engine.backend import Engine
from magicdec_tpu_torch.engine.glide_engine import GlideEngine, SpecTree
from magicdec_tpu_torch.engine.longspec import LongSpecEngine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                            generate_selfspec)
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.parallel import sharding


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return None if tree is None else tree.cpu().numpy()


@torch.inference_mode()
def _first_logits(eng: Engine, prompt, snapkv: bool) -> np.ndarray:
    """The logits [B, V] of the step after encode: the next AR step, or
    SnapKV's first draft step over the budget cache."""
    tok = eng.encode(prompt)
    cfg = eng.config
    if snapkv:
        impl = impls.snapkv_draft_attn(cfg, eng.cache.lengths,
                                       eng.draft.lengths, 1)
        caches = (eng.draft.k, eng.draft.v)
    else:
        impl = impls.target_attn(cfg, eng.cache.lengths, 1)
        caches = (eng.cache.k, eng.cache.v)
    return llama.forward(eng.params, cfg, tok, impl, caches)[:, 0].numpy()


def _stats(out, counts, stats) -> dict:
    return dict(out=out.numpy(), counts=counts.numpy(),
                acceptance=stats.acceptance_rate, rounds=stats.rounds,
                accepted=stats.total_accepted_drafts,
                compactions=stats.compactions)


def _spec(eng: Engine, prompt, gamma: int, new: int) -> dict:
    return _stats(*generate_selfspec(eng, prompt, gamma, new))


def _ar(eng: Engine, prompt, new: int) -> dict:
    out, stats = generate_autoregressive(eng, prompt, new)
    return dict(out=out.numpy(), generated=stats.generated_tokens,
                rounds=stats.rounds)


def run(mesh, cfg_kw: dict, params_np: dict, prompt: np.ndarray, *,
        new: int, gamma: int, engine_kw: dict, cases: dict,
        padded: tuple, cache_np: tuple, fold_new: int, glide_np: dict,
        quant: tuple) -> dict:
    """Every scenario on this rank; returns numpy results. cases: name ->
    Engine keyword arguments of a self-speculation run. padded: (cfg_kw,
    params_np, prompt) of a model whose KV heads do not divide tp.
    cache_np: (k, v, lengths) of a cache to cut with shard_cache.
    fold_new: the new tokens of RetroInfer's fold path (TAIL_COVERS_MAX
    lowered to 0, so the aged tail rows join the cluster index). glide_np:
    a GliDe block's whole params, run linear and as a (2, 2) tree.
    quant: (cfg_kw, {mode: the whole quantized params}, prompt, budgets)
    of a model whose row-parallel shards hold whole int4 groups; each mode
    runs AR and SnapKV at each budget with float32 caches."""
    torch.set_num_threads(1)
    cfg = ModelArgs(**cfg_kw)
    params = llama.params_from_numpy(params_np, device="cpu")
    res = {"rank": mesh.rank}

    res["shards"] = _np(sharding.shard_params(params, mesh, cfg))
    k, v, lengths = (torch.from_numpy(x) for x in cache_np)
    res["cache_shard"] = _np(vars(sharding.shard_cache(
        KVCache(k, v, lengths), mesh)))

    def engine(**kw):
        return Engine(cfg, params, mesh=mesh, **{**engine_kw, **kw})

    res["ar"] = _ar(engine(), prompt, new)
    res["ar_logits"] = _first_logits(engine(), prompt, snapkv=False)
    snap = cases["snapkv"]
    res["snapkv_logits"] = _first_logits(engine(**snap), prompt, snapkv=True)
    for name, kw in cases.items():
        eng = engine(**kw)
        res[name] = _spec(eng, prompt, gamma, new)
        if kw["spec"] == "retro":
            res[name]["cluster_slots"] = eng.spec_index[1].numpy()

    retro.TAIL_COVERS_MAX, covers = 0, retro.TAIL_COVERS_MAX
    try:
        eng = engine(**cases["retro"])
        res["retro_fold"] = _spec(eng, prompt, gamma, fold_new)
        res["retro_fold"]["cluster_slots"] = eng.spec_index[1].numpy()
    finally:
        retro.TAIL_COVERS_MAX = covers

    # the asymmetric longspec: target sharded, the self-draft replicated
    draft = Engine(cfg, params, mesh=mesh, replicate_tp=True, **engine_kw)
    out, counts, stats = LongSpecEngine(engine(), draft).generate(
        prompt, gamma, new)
    res["longspec"] = dict(out=out.numpy(), counts=counts.numpy(),
                           acceptance=stats.acceptance_rate,
                           draft_heads=draft.config.n_kv_head,
                           target_heads=engine().config.n_kv_head)

    # a replicated draft whose output layer differs on every rank but 0:
    # rank 0's drafted tokens, broadcast, are what every rank verifies
    noise = torch.randn(params["output"].shape,
                        generator=torch.Generator().manual_seed(9))
    skewed = dict(params, output=params["output"] + 0.5 * mesh.rank * noise)
    draft = Engine(cfg, skewed, mesh=mesh, replicate_tp=True, **engine_kw)
    out, counts, stats = LongSpecEngine(engine(), draft).generate(
        prompt, gamma, new)
    res["longspec_skewed"] = dict(out=out.numpy(), counts=counts.numpy(),
                                  acceptance=stats.acceptance_rate)

    gp = llama.params_from_numpy(glide_np, device="cpu")
    for name, branching in (("glide_linear", None), ("glide_tree", (2, 2))):
        eng = GlideEngine(engine(), gp)
        res[name] = _stats(*eng.generate(
            prompt, new, gamma=gamma,
            tree=None if branching is None else SpecTree(branching)))
        res[name]["own_heads"] = eng.own_k.shape[-1] // cfg.head_dim
        res[name]["lengths_equal"] = bool(
            torch.equal(eng.own_len, eng.target.cache.lengths))

    qcfg_kw, quant_np, qprompt, budgets = quant
    qcfg = ModelArgs(**qcfg_kw)
    for mode, qnp in quant_np.items():
        qparams = llama.params_from_numpy(qnp, device="cpu")
        kw = dict(engine_kw, kv_dtype=torch.float32)
        res[f"{mode}_ar"] = _ar(Engine(qcfg, qparams, mesh=mesh, **kw),
                                qprompt, new)
        for budget in budgets:
            res[f"{mode}_snapkv_{budget}"] = _spec(
                Engine(qcfg, qparams, mesh=mesh, spec="snapkv",
                       draft_budget=budget, window_size=8, **kw),
                qprompt, gamma, new)

    pcfg_kw, pparams_np, pprompt = padded
    pcfg = ModelArgs(**pcfg_kw)
    pparams, pcfg = sharding.pad_model_for_tp(
        llama.params_from_numpy(pparams_np, device="cpu"), pcfg, mesh.tp)
    out, _ = generate_autoregressive(
        Engine(pcfg, pparams, mesh=mesh, **engine_kw), pprompt, new)
    res["padded_ar"] = out.numpy()
    return res


def _rank_values(rank: int) -> torch.Tensor:
    """Rank r's [5, 7] float32 values, of magnitude 10^r, so a float32 sum
    over the ranks depends on its order."""
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn((5, 7), generator=g) * 10.0 ** rank


def collectives(mesh) -> dict:
    """all_reduce_tp of every rank's values on the leading rows of a
    buffer (in place), all_gather_tp along columns and broadcast_tp of the
    rank's number."""
    from magicdec_tpu_torch.parallel.collectives import (all_gather_tp,
                                                         all_reduce_tp,
                                                         broadcast_tp)
    torch.set_num_threads(1)
    x = _rank_values(mesh.rank)
    buf = torch.cat([x, torch.full((2, 7), -1.0)])
    all_reduce_tp(buf[:5], mesh)
    return dict(reduce=buf.numpy(),
                gather=all_gather_tp(x, mesh, dim=1).numpy(),
                bcast=broadcast_tp(torch.full((3,), float(mesh.rank)),
                                   mesh).numpy())


def _layout(mesh) -> tuple | None:
    return None if mesh is None else (mesh.dp, mesh.dp_rank, mesh.tp,
                                      mesh.rank)


def run_dp(mesh, cfg_kw: dict, params_np: dict, prompt: np.ndarray, *,
           new: int, gamma: int, engine_kw: dict, cases: dict,
           cache_np: tuple) -> dict:
    """The four-rank world's scenarios. mesh: make_multihost_mesh(2) on two
    emulated hosts of two ranks (run_world's local_size=2): dp is the host
    index. Besides it every rank builds make_mesh(dp=2, tp=2) (the grid,
    on which it also cuts the cache of cache_np with shard_cache),
    the sub-mesh make_mesh(dp=1, tp=2) over the first two ranks, and
    make_multihost_mesh(1) (dp over the hosts, tp=1: each host's first
    rank); a rank outside a mesh gets None and runs nothing on it. On the
    grid: AR, each self-speculation case and the asymmetric longspec; on
    the multi-host mesh AR and SnapKV; on the sub-mesh and on the tp=1
    host mesh AR. Returns numpy results, every stream the whole batch's."""
    torch.set_num_threads(1)
    cfg = ModelArgs(**cfg_kw)
    params = llama.params_from_numpy(params_np, device="cpu")
    dev = mesh.device
    grid = sharding.make_mesh(dp=2, tp=2, device=dev)
    sub = sharding.make_mesh(dp=1, tp=2, device=dev)
    hosts = sharding.make_multihost_mesh(1, device=dev)
    res = {"layout": {name: _layout(m) for name, m in (
        ("multihost", mesh), ("grid", grid), ("sub", sub),
        ("hosts", hosts))}}
    k, v, lengths = (torch.from_numpy(x) for x in cache_np)
    res["cache_shard"] = _np(vars(sharding.shard_cache(
        KVCache(k, v, lengths), grid)))

    def engine(m, **kw):
        return Engine(cfg, params, mesh=m, **{**engine_kw, **kw})

    res["ar"] = _ar(engine(grid), prompt, new)
    for name, kw in cases.items():
        res[name] = _spec(engine(grid, **kw), prompt, gamma, new)
    draft = engine(grid, replicate_tp=True)
    res["longspec"] = _stats(*LongSpecEngine(engine(grid), draft).generate(
        prompt, gamma, new))
    res["longspec"]["draft_rows"] = draft.local_batch

    res["multihost_ar"] = _ar(engine(mesh), prompt, new)
    res["multihost_snapkv"] = _spec(engine(mesh, **cases["snapkv"]), prompt,
                                    gamma, new)
    for name, m in (("sub_ar", sub), ("hosts_ar", hosts)):
        res[name] = None if m is None else _ar(engine(m), prompt, new)
    return res
