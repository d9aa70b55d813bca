"""The scenarios that tests/test_torch_sharding.py runs in each rank of a
tp=2 gloo world of CPU processes (parallel/launch.run_world). This module
imports torch and the port only: the spawned ranks import it by name, and
they must not load JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.engine import retro
from magicdec_tpu_torch.engine.backend import Engine
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


def _spec(eng: Engine, prompt, gamma: int, new: int) -> dict:
    out, counts, stats = generate_selfspec(eng, prompt, gamma, new)
    return dict(out=out.numpy(), counts=counts.numpy(),
                acceptance=stats.acceptance_rate, rounds=stats.rounds,
                compactions=stats.compactions)


def run(mesh, cfg_kw: dict, params_np: dict, prompt: np.ndarray, *,
        new: int, gamma: int, engine_kw: dict, cases: dict,
        padded: tuple, cache_np: tuple, fold_new: int) -> dict:
    """Every scenario on this rank; returns numpy results. cases: name ->
    Engine keyword arguments of a self-speculation run. padded: (cfg_kw,
    params_np, prompt) of a model whose KV heads do not divide tp.
    cache_np: (k, v, lengths) of a cache to cut with shard_cache.
    fold_new: the new tokens of RetroInfer's fold path (TAIL_COVERS_MAX
    lowered to 0, so the aged tail rows join the cluster index)."""
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

    out, stats = generate_autoregressive(engine(), prompt, new)
    res["ar"] = dict(out=out.numpy(), generated=stats.generated_tokens)
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
