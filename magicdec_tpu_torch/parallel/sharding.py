"""Tensor and data parallelism over torch.distributed: the mesh, the param
and cache shards, the padding of uneven KV heads (port of
magicdec_tpu/parallel/sharding.py).

Explicit SPMD, where the JAX package has GSPMD: one process per rank of a
dp x tp mesh, each holding only its own shard, and the port's code calls
the collectives itself (parallel/collectives.py). Rank r of the mesh's
ranks has dp index r // tp and tp index r % tp, as the JAX package's
reshape(dp, tp) of the device list; a mesh may take only the first dp*tp
ranks of a larger world (a sub-mesh: the other ranks get None), and
make_multihost_mesh runs dp over hosts and tp over each host's first ranks.

tp cuts the weights as the JAX package's param_pspecs:
  wqkv  [L, D, Hkv*(G+2)*Dh]  contiguous KV-head-major columns, so a rank
                              owns whole GQA groups (bqkv: the same columns)
  wo    [L, Hq*Dh, D]         rows (row-parallel: its product is all-reduced)
  w_gate_up [L, D, 2, I]      the last axis
  w_down    [L, I, D]         rows (row-parallel)
  tok_embeddings [V, D]       vocab rows (vocab-parallel lookup, all-reduced)
  output [D, V]               vocab columns (the logits are all-gathered)
  norms                       replicated
and the packed caches [L, B, S, Hkv*D] hold the rank's (Hkv/tp)*D columns:
whole KV heads, so every attention kernel runs on its shard unchanged.
Quantized weights (quant/int8.py) are cut along the same output or
contraction axes in their stored layouts (_shard_int8, _shard_int4). dp
cuts the batch: a rank's caches hold its contiguous block of B/dp rows
(shard_tokens), every per-round decision of a generation is reduced over
the dp ranks, and the finished streams are gathered (engine/spec.py).

A rank runs its layers with local_config: n_head/tp and n_kv_head/tp heads,
head_dim explicit, and the mesh on the config (ModelArgs.mesh), which the
model and the drafts read to place their collectives. local_config checks
the partition once, so the per-shard kernel forms launch on what they are
given.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.quant.int8 import Int4ColWeight, Int4Weight


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a dp x tp mesh: its tp index (`rank`) and size,
    the tp process group (the ranks of its dp index), the backend, the
    rank's device, and its dp index and size with the dp process group (the
    ranks of its tp index). A group of one rank is None unless it is the
    whole world: the collectives of a size-1 axis make no call."""
    tp: int
    rank: int
    backend: str
    device: torch.device
    group: Any = None
    dp: int = 1
    dp_rank: int = 0
    dp_group: Any = None


def _group(ranks: list[int], world: int):
    """The process group of `ranks`. Every rank of the world calls this for
    every group of a mesh, in the same order (torch.distributed.new_group
    asks that), including the groups it is not in."""
    if ranks == list(range(world)):
        return dist.group.WORLD
    return dist.new_group(ranks) if len(ranks) > 1 else None


def _mesh_of(grid: list[list[int]], backend: str | None,
             device) -> Mesh | None:
    """The mesh whose dp index d and tp index t are the world's rank
    grid[d][t]; None on a rank outside the grid."""
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"backend {backend!r} asked for, but the process "
                         f"group runs {actual!r}")
    world, me = dist.get_world_size(), dist.get_rank()
    dp, tp = len(grid), len(grid[0])
    tp_groups = [_group(row, world) for row in grid]
    dp_groups = [_group(list(col), world) for col in zip(*grid)]
    where = [(d, t) for d in range(dp) for t in range(tp) if grid[d][t] == me]
    if not where:
        return None
    (d, t), = where
    device = resolve_device(device)
    if actual == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    return Mesh(tp=tp, rank=t, backend=actual, device=device,
                group=tp_groups[d], dp=dp, dp_rank=d, dp_group=dp_groups[t])


def make_mesh(dp: int = 1, tp: int | None = None, backend: str | None = None,
              device=None) -> Mesh | None:
    """This process's view of a dp x tp mesh over the first dp*tp ranks of
    the world, built after torch.distributed.init_process_group
    (parallel/launch.run_world does both). Every rank of the world calls
    it; a rank past the first dp*tp (a sub-mesh) gets None and takes no
    part. tp defaults to world // dp. backend, if given, must be the
    world's (nccl for one process a card, gloo for several ranks on one
    card or CPU ranks): it is never switched. device defaults to the
    current CUDA device (resolve_device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first (see parallel/launch.py)")
    world = dist.get_world_size()
    tp = world // dp if tp is None else tp
    if dp < 1 or tp < 1 or dp * tp > world:
        raise ValueError(f"a dp={dp} x tp={tp} mesh needs dp*tp ranks, and "
                         f"the world has {world}")
    grid = [[d * tp + t for t in range(tp)] for d in range(dp)]
    return _mesh_of(grid, backend, device)


def make_multihost_mesh(tp_per_host: int | None = None,
                        backend: str | None = None,
                        device=None) -> Mesh | None:
    """dp over hosts, tp over each host's first tp_per_host ranks (default:
    all of them), as the JAX package's make_multihost_mesh. The hosts are
    read from torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE (a host's ranks
    are consecutive in the world, as torchrun numbers them); a rank past
    its host's first tp_per_host gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh needs torch.distributed."
                           "init_process_group first")
    try:
        local = int(os.environ["LOCAL_WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
    except KeyError as e:
        raise RuntimeError(f"make_multihost_mesh reads torchrun's {e.args[0]}"
                           f" (run_world sets it with local_size)") from None
    world, me = dist.get_world_size(), dist.get_rank()
    if world % local or me % local != local_rank:
        raise ValueError(f"rank {me} of {world} with LOCAL_RANK {local_rank} "
                         f"and LOCAL_WORLD_SIZE {local}: a host's ranks must "
                         f"be consecutive")
    tp = tp_per_host or local
    if not 1 <= tp <= local:
        raise ValueError(f"tp_per_host={tp} on hosts of {local} ranks")
    grid = [[h * local + t for t in range(tp)] for h in range(world // local)]
    return _mesh_of(grid, backend, device)


def shard_tokens(tokens: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The rank's contiguous block of B/dp rows of a [B, ...] batch (the
    JAX package's shard_tokens: batch over dp); the batch itself off-mesh
    or at dp == 1."""
    if mesh is None or mesh.dp == 1:
        return tokens
    B = tokens.shape[0]
    if B % mesh.dp:
        raise ValueError(f"batch {B} does not divide dp={mesh.dp}")
    n = B // mesh.dp
    return tokens[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


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


# how tp cuts each layer weight's product: "col" its output columns, "row"
# its contraction rows (the product is then all-reduced)
_LAYER_CUTS = {"wqkv": "col", "bqkv": "col", "wo": "row", "w_gate_up": "col",
               "w_down": "row"}


def _narrow(x: torch.Tensor, axis: int, full: int, mesh: Mesh,
            name: str) -> torch.Tensor:
    """The rank's contiguous block of the whole leaf x along `axis`."""
    if x.shape[axis] != full:
        raise ValueError(f"{name} {tuple(x.shape)}: axis {axis} is not the "
                         f"model's {full} (a quantized leaf is cut whole)")
    n = full // mesh.tp
    return x.narrow(axis, mesh.rank * n, n)


def _shard_int8(w: dict, name: str, full: int, mesh: Mesh) -> dict:
    """quantize_params' int8 {"qT": [L, prod(out), K], "s": [L, 1, *out]}
    cut for tp: a column-parallel leaf keeps the rows of qT and the scales
    of its output block (w_gate_up's folded out axis (2, I) gives two
    blocks, the gate's and the up's), a row-parallel one the columns of qT
    (its K block) and every scale (a scale spans all of K)."""
    qT, s = w["qT"], w["s"]
    L, _, K = qT.shape
    if _LAYER_CUTS[name] == "row":
        qT = _narrow(qT, 2, full, mesh, name)
    else:
        out = s.shape[2:]
        q = _narrow(qT.reshape(L, *out, K), len(out), full, mesh, name)
        qT = q.reshape(L, -1, K)
        s = _narrow(s, s.dim() - 1, full, mesh, name)
    return {"qT": qT.to(mesh.device).contiguous(),
            "s": s.to(mesh.device).contiguous()}


def _shard_int4(w: Int4ColWeight, name: str, full: int,
                mesh: Mesh) -> Int4ColWeight:
    """An Int4ColWeight (q4 [L, K, N/2] pairing columns n and n + N/2,
    s4 [L, K/g, N]) cut for tp. A row-parallel leaf keeps its K block of
    q4 and s4, whole scale groups, and refuses a K/tp that is not a
    multiple of the group. A column-parallel leaf keeps its output block
    (w_gate_up's gate and up blocks), repacked in the same layout at the
    block's width: its nibbles pair the block's columns n and n + N/(2 tp),
    not the whole weight's, and the codes and scales are the whole
    weight's (quantization is per column and group), so the shard
    dequantizes to the whole weight's block."""
    q4, s4 = w.q4, w.s4
    L, K = q4.shape[:2]
    groups = s4.shape[1]
    if _LAYER_CUTS[name] == "row":
        g, n = K // groups, full // mesh.tp
        if n % g:
            raise ValueError(
                f"{name}: an int4 row-parallel shard holds K/tp = {n} rows "
                f"at tp={mesh.tp}, not a multiple of the {g}-row scale group")
        q4 = _narrow(q4, 1, full, mesh, name)
        s4 = s4.narrow(1, mesh.rank * n // g, n // g)
        return Int4ColWeight(q4.to(mesh.device).contiguous(),
                             s4.to(mesh.device).contiguous(), w.out_shape)
    out = tuple(w.out_shape)
    qu = q4.view(torch.uint8)
    codes = torch.cat([qu & 0xF, qu >> 4], dim=-1).reshape(L, K, *out)
    codes = _narrow(codes, codes.dim() - 1, full, mesh, name).reshape(L, K, -1)
    half = codes.shape[-1] // 2
    q4 = ((codes[..., half:] << 4) | codes[..., :half]).view(torch.int8)
    s4 = _narrow(s4.reshape(L, groups, *out), 1 + len(out), full, mesh,
                 name).reshape(L, groups, -1)
    return Int4ColWeight(q4.to(mesh.device).contiguous(),
                         s4.to(mesh.device).contiguous(),
                         (*out[:-1], out[-1] // mesh.tp))


def _to_device(w, device):
    """A layer weight, plain or quantized, on `device`."""
    if isinstance(w, dict):
        return {k: v.to(device) for k, v in w.items()}
    if isinstance(w, Int4ColWeight):
        return Int4ColWeight(w.q4.to(device), w.s4.to(device), w.out_shape)
    return w.to(device)


def shard_params(params, mesh: Mesh, config: ModelArgs,
                 replicate_tp: bool = False):
    """This rank's params: each leaf cut along param_axes into its
    contiguous tp block (a plain leaf that is already the block, as
    init_sharded_params makes it, is kept), on the mesh's device; quantized
    layer weights (int8 dicts and Int4ColWeight) are cut whole in their
    stored layouts (_shard_int8, _shard_int4). replicate_tp keeps every
    leaf whole and as it is (the asymmetric-TP draft, the JAX package's
    replicated_param_pspecs; Engine checks that it lies on the mesh's
    device). The weights are the same on every dp rank."""
    if replicate_tp:
        return params
    validate_tp(config, mesh.tp)
    axes, full = param_axes(config), _full_sizes(config)

    def leaf(name, x, axis):
        if x is None:
            return None
        if isinstance(x, Int4Weight):
            raise ValueError(f"{name}: the nibble-pair Int4Weight has no tp "
                             f"cut; quantize with quantize_params(params, "
                             f"'int4') (Int4ColWeight)")
        if axis is None or mesh.tp == 1:
            return _to_device(x, mesh.device)
        if isinstance(x, dict):
            return _shard_int8(x, name, full[name], mesh)
        if isinstance(x, Int4ColWeight):
            return _shard_int4(x, name, full[name], mesh)
        return _cut(x, axis, full[name], mesh, name)

    out = {k: leaf(k, params[k], axes[k])
           for k in ("tok_embeddings", "norm", "output")}
    out["layers"] = {k: leaf(k, w, axes["layers"][k])
                     for k, w in params["layers"].items()}
    return out


# the axis each GliDe block leaf is cut along (None: replicated), as a
# target layer's: wqkv by whole KV-head groups, wq_cross by the q heads of
# those groups, the output projections and w_down by rows (row-parallel),
# w_gate_up by its last axis
GLIDE_AXES = {"self_norm": None, "wqkv": 1, "wo": 0, "cross_norm": None,
              "wq_cross": 1, "wo_cross": 0, "ffn_norm": None, "w_gate_up": 2,
              "w_down": 0}


def shard_glide_params(glide, mesh: Mesh, config: ModelArgs):
    """This rank's block of a GliDe draft block (models/glide.py) for a
    target sharded over tp (config: the whole target model's), on the
    mesh's device. The rank's own cache then holds its KV heads, and its
    cross-attention q heads read the rank's shard of the target's last
    layer as they are."""
    validate_tp(config, mesh.tp)
    full = _full_sizes(config)
    sizes = dict(wqkv=full["wqkv"], wo=full["wo"], wq_cross=full["wo"],
                 wo_cross=full["wo"], w_gate_up=full["w_gate_up"],
                 w_down=full["w_down"])
    return {k: (w.to(mesh.device) if GLIDE_AXES[k] is None or mesh.tp == 1
                else _cut(w, GLIDE_AXES[k], sizes[k], mesh, k))
            for k, w in glide.items()}


def shard_cache(cache, mesh: Mesh):
    """A KVCache or DraftKVCache cut to the rank's block: the (Hkv/tp)*D
    columns of the packed [L, B, S, Hkv*D] k/v (whole KV heads) and, under
    dp, its B/dp rows of k/v and of the int32 length vectors, on the mesh's
    device (the JAX package's cache_pspec: batch over dp, heads over tp).
    (Engine makes its caches at the rank's width and rows; this cuts an
    existing one.)"""
    def cut(name, t):
        rows = 1 if name in ("k", "v") else 0
        if mesh.dp > 1:
            n = t.shape[rows] // mesh.dp
            t = t.narrow(rows, mesh.dp_rank * n, n)
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

