"""Tensor parallelism over torch.distributed: the mesh, the param and cache
shards, the padding of uneven KV heads (port of
magicdec_tpu/parallel/sharding.py).

Explicit SPMD, where the JAX package has GSPMD: one process per tp rank,
each holding only its own shard, and the port's code calls the collectives
itself (parallel/collectives.py). The partition is the JAX package's
param_pspecs:
  wqkv  [L, D, Hkv*(G+2)*Dh]  contiguous KV-head-major columns, so a rank
                              owns whole GQA groups (bqkv: the same columns)
  wo    [L, Hq*Dh, D]         rows (row-parallel: its product is all-reduced)
  w_gate_up [L, D, 2, I]      the last axis
  w_down    [L, I, D]         rows (row-parallel)
  tok_embeddings [V, D]       vocab rows (vocab-parallel lookup, all-reduced)
  output [D, V]               vocab columns (the logits are all-gathered)
  norms                       replicated
and the packed caches [L, B, S, Hkv*D] hold the rank's (Hkv/tp)*D columns:
whole KV heads, so every attention kernel runs on its shard unchanged. A
rank runs its layers with local_config: n_head/tp and n_kv_head/tp heads,
head_dim explicit, and the mesh on the config (ModelArgs.mesh), which the
model and the drafts read to place their collectives. local_config checks
the partition once, so the per-shard kernel forms launch on what they are
given.

Left out (ROADMAP A14b): dp > 1, sub-meshes of a larger world, multi-host
meshes, quantized weights under tp (C3), GliDe and SqueezedAttention under
tp, the fused decode block under tp.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.quant.int8 import is_quantized


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a tensor-parallel mesh: its tp rank and size, the
    tp process group, the backend and the rank's device. dp is 1."""
    tp: int
    rank: int
    backend: str
    device: torch.device
    group: Any = None
    dp: int = 1


def make_mesh(dp: int = 1, tp: int | None = None, backend: str | None = None,
              device=None) -> Mesh:
    """The tp mesh of this process, built after
    torch.distributed.init_process_group (parallel/launch.run_world does
    both). tp defaults to the world size and must equal it; backend, if
    given, must be the world's (nccl for one process a card, gloo for
    several ranks on one card or CPU ranks): it is never switched. device
    defaults to the current CUDA device (resolve_device)."""
    if dp != 1:
        raise NotImplementedError(
            f"dp={dp}: data parallelism is not ported (ROADMAP A14b, dp > 1: "
            f"the per-round decisions would have to be taken over all dp "
            f"ranks)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first (see parallel/launch.py)")
    world = dist.get_world_size()
    tp = world if tp is None else tp
    if tp != world:
        raise ValueError(f"tp={tp} in a world of {world} ranks: the tp group "
                         f"is the whole world (sub-meshes are not ported: "
                         f"ROADMAP A14b)")
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"backend {backend!r} asked for, but the process "
                         f"group runs {actual!r}")
    device = resolve_device(device)
    if actual == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    return Mesh(tp=tp, rank=dist.get_rank(), backend=actual, device=device,
                group=dist.group.WORLD)


def validate_tp(config: ModelArgs, tp: int):
    """Raise unless every sharded axis divides by tp. KV heads that do not
    (the reference gives remainder heads to the first ranks, Engine/tp.py:
    36-52) need pad_model_for_tp first."""
    if config.n_kv_head % tp:
        raise ValueError(
            f"n_kv_head={config.n_kv_head} does not divide tp={tp}; pad the "
            f"model with sharding.pad_model_for_tp(params, config, tp) first")
    for name in ("intermediate_size", "vocab_size", "dim"):
        if getattr(config, name) % tp:
            raise ValueError(f"{name}={getattr(config, name)} does not divide "
                             f"tp={tp}")


def local_config(config: ModelArgs, mesh: Mesh) -> ModelArgs:
    """The config a tp rank runs its layers with: its n_head/tp and
    n_kv_head/tp heads (whole GQA groups; head_dim kept explicit), its
    intermediate_size/tp, and the mesh. dim and vocab_size stay the
    model's: the hidden state is replicated and the logits are gathered."""
    validate_tp(config, mesh.tp)
    local = dataclasses.replace(
        config, n_head=config.n_head // mesh.tp,
        n_kv_head=config.n_kv_head // mesh.tp,
        intermediate_size=config.intermediate_size // mesh.tp)
    local.mesh = mesh
    return local


def pad_model_for_tp(params, config: ModelArgs, tp: int):
    """Zero-pad the attention heads so n_kv_head divides tp; returns
    (padded_params, padded_config), or the inputs when it divides already.

    Whole zero-weight KV-head groups (G q-heads + k + v) are appended: their
    wqkv/bqkv columns are zero (q = k = v = 0; softmax over zero logits
    attends a zero V) and their wo rows are zero, so the logits do not
    change; they cost their share of attention work and cache, the price of
    even shards. head_dim stays explicit (ModelArgs.replace would re-derive
    it from dim // n_head)."""
    Hkv, Hq, Dh = config.n_kv_head, config.n_head, config.head_dim
    if Hkv % tp == 0:
        return params, config
    G = Hq // Hkv
    new_kv = -(-Hkv // tp) * tp
    pad_kv = new_kv - Hkv
    new_cfg = dataclasses.replace(config, n_kv_head=new_kv,
                                  n_head=new_kv * G, head_dim=Dh)
    layers = dict(params["layers"])
    cols = pad_kv * (G + 2) * Dh
    layers["wqkv"] = F.pad(layers["wqkv"], (0, cols))
    if "bqkv" in layers:
        layers["bqkv"] = F.pad(layers["bqkv"], (0, cols))
    # wo rows are q-head-major; the new q heads sit at the end
    layers["wo"] = F.pad(layers["wo"], (0, 0, 0, pad_kv * G * Dh))
    out = dict(params)
    out["layers"] = layers
    return out, new_cfg


def param_axes(config: ModelArgs) -> dict:
    """The axis each param leaf is cut along (None: replicated): the JAX
    package's param_pspecs as axis indices."""
    layers = {"attn_norm": None, "wqkv": 2, "wo": 1, "ffn_norm": None,
              "w_gate_up": 3, "w_down": 1}
    if config.qkv_bias:
        layers["bqkv"] = 1
    return {"tok_embeddings": 0, "layers": layers, "norm": None,
            "output": None if config.tie_word_embeddings else 1}


def _full_sizes(config: ModelArgs) -> dict:
    """The model's size of each cut axis."""
    qkv = (config.n_head + 2 * config.n_kv_head) * config.head_dim
    return {"wqkv": qkv, "bqkv": qkv, "wo": config.n_head * config.head_dim,
            "w_gate_up": config.intermediate_size,
            "w_down": config.intermediate_size,
            "tok_embeddings": config.vocab_size, "output": config.vocab_size}


def _cut(x: torch.Tensor, axis: int, full: int, mesh: Mesh,
         name: str) -> torch.Tensor:
    """The rank's contiguous block of x along `axis` on the mesh's device;
    x may be the whole leaf or already the rank's block."""
    n = full // mesh.tp
    if x.shape[axis] == full:
        x = x.narrow(axis, mesh.rank * n, n)
    elif x.shape[axis] != n:
        raise ValueError(f"{name} {tuple(x.shape)}: axis {axis} is neither "
                         f"the model's {full} nor a tp shard's {n}")
    return x.to(mesh.device).contiguous()


def shard_params(params, mesh: Mesh, config: ModelArgs,
                 replicate_tp: bool = False):
    """This rank's params: each leaf cut along param_axes into its
    contiguous tp block (a leaf that is already the block, as
    init_sharded_params makes it, is kept), on the mesh's device.
    replicate_tp keeps every leaf whole and as it is (the asymmetric-TP
    draft, the JAX package's replicated_param_pspecs; Engine checks that it
    lies on the mesh's device). Quantized weights are refused unless
    replicated: the specs describe the plain [L, K, out] layout and would
    cut an int8 qT along its contraction axis (ROADMAP C3)."""
    if replicate_tp:
        return params
    quantized = [k for k, w in params["layers"].items() if is_quantized(w)]
    if quantized:
        raise ValueError(
            f"quantized weights {quantized} under tensor parallelism are not "
            f"ported (ROADMAP C3, A14b: their own partition specs); shard "
            f"plain weights, or replicate a quantized draft with "
            f"replicate_tp=True")
    validate_tp(config, mesh.tp)
    axes, full = param_axes(config), _full_sizes(config)

    def leaf(name, x, axis):
        if x is None or axis is None or mesh.tp == 1:
            return None if x is None else x.to(mesh.device)
        return _cut(x, axis, full[name], mesh, name)

    out = {k: leaf(k, params[k], axes[k])
           for k in ("tok_embeddings", "norm", "output")}
    out["layers"] = {k: leaf(k, w, axes["layers"][k])
                     for k, w in params["layers"].items()}
    return out


def shard_cache(cache, mesh: Mesh):
    """A KVCache or DraftKVCache cut to the rank's (Hkv/tp)*D columns of
    the packed [L, B, S, Hkv*D] k/v (whole KV heads), on the mesh's device;
    the int32 length vectors are replicated. (Engine makes its caches at
    the local config's width; this cuts an existing one.)"""
    def cut(name, t):
        if name in ("k", "v") and mesh.tp > 1:
            return _cut(t, 3, t.shape[3], mesh, "cache")
        return t.to(mesh.device)

    return type(cache)(**{f.name: cut(f.name, getattr(cache, f.name))
                          for f in dataclasses.fields(cache)})


def init_sharded_params(config: ModelArgs, mesh: Mesh, dtype=torch.float32,
                        scale: float = 0.02, seed: int = 0):
    """This rank's block of llama.init_params(config, dtype, scale, seed,
    mesh.device), made a layer at a time: each rank draws the same random
    stream and keeps only its slice, so no rank ever holds the whole model
    (one layer of a stacked weight, or the embedding or output table, at
    most)."""
    from magicdec_tpu_torch.models import llama

    validate_tp(config, mesh.tp)
    axes, full = param_axes(config), _full_sizes(config)
    layer_axes = axes["layers"]
    out = {"layers": {}}
    for name, layer, t in llama.init_pieces(config, dtype, scale, seed,
                                            mesh.device):
        if layer is None:
            axis = axes.get(name, layer_axes.get(name))
            if axis is not None and t is not None and mesh.tp > 1:
                t = _cut(t, axis, full[name], mesh, name)
            (out["layers"] if name in layer_axes else out)[name] = t
            continue
        # one layer of a stacked leaf: cut along its axis less the L axis
        axis = layer_axes[name]
        if axis is not None and mesh.tp > 1:
            t = _cut(t, axis - 1, full[name], mesh, name)
        if layer == 0:
            out["layers"][name] = torch.empty((config.n_layer, *t.shape),
                                              dtype=t.dtype, device=t.device)
        out["layers"][name][layer] = t
    return out

