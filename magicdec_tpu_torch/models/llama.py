"""Llama/Qwen/Yi/Mistral decoder core (port of magicdec_tpu/models/llama.py).

Plain functions over a params dict in the JAX package's layout: weights are
[in, out], layers are stacked on a leading axis, wqkv columns are
KV-head-major ([q-heads of kv-group 0 | k0 | v0 | q-heads of group 1 | ...])
and gate/up are stacked as [L, D, 2, I]. The layer scan becomes a Python
loop over layers.

attn_impl contract (as in the JAX package):
    attn_impl(q, k, v, caches: tuple[Tensor, ...], l: int) -> ctx [B, T, Hq*Dh]
with q [B,T,Hq,Dh], k/v [B,T,Hkv,Dh] pre-rope; the impl owns rope and
writes its caches in place.

Row-count-independent numerics: the hidden state runs through the layers
as [M, dim] rows, M = row_bucket(B, T) with the pad rows zero. A GEMM
library picks its algorithm from the shape, and PyTorch splits a row
reduction (the RMSNorm mean) by the number of rows, and both round
differently for different shapes. The AR and draft steps (B or 2B rows),
the verify (B*(gamma+1) rows) and the GliDe tree verify (B*n_nodes rows)
must produce bit-identical rows for the speculative stream to be the AR
stream and the full-budget acceptance to be exactly 1.0, so every forward
of at most DECODE_ROWS_PER_SEQ tokens a sequence runs every row-wise
operation at one shape fixed by the batch alone: B * DECODE_ROWS_PER_SEQ
rows rounded up to ROW_BUCKET. The AR baseline is a generation of its own,
so a bucket sized by one generation's largest forward could not hold its
rows to a speculative run's. On an H100 (cuBLAS of CUDA 12.8) the w_down
product gives a row other bits at M=8 than inside M=56, and M=16 rows
padded to 64 other bits than inside 80 rows padded to 128 (chip_smoke.py
gemm_rows, which also times the padding).

The four weight products of a block run through quant/int8.py qmatmul, so
a layer weight may be plain or quantized (quantize_params: int8, or int4
through the int4_matmul kernel); the quantized paths keep the padded rows.
By default (set_fused_mode("auto")) every forward of T <= 32 tokens with
plain weights on a CUDA device and no tensor-parallel mesh runs the
products and their norms, residuals and SwiGLU in ops/fused_block.py's
kernels instead, whose rows do not depend on the row count, so the token
rows run unpadded through the layers and only the unembedding keeps the
padded rows. The fused block rounds at the TPU kernels' points, not at the
unfused path's, so a stream is compared with streams of its own route.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from magicdec_tpu_torch.checkpoint.store import tensor_from_numpy
from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops.fused_block import fused_post_attn, fused_qkv
from magicdec_tpu_torch.ops.norms import rms_norm
from magicdec_tpu_torch.parallel.collectives import (all_gather_tp,
                                                     all_reduce_tp)
from magicdec_tpu_torch.quant.int8 import Int4ColWeight, is_quantized, qmatmul

Params = dict[str, Any]
AttnImpl = Callable

ROW_BUCKET = 64
# the most tokens a sequence feeds one decode-phase forward: gamma + 1 of a
# verify, the nodes of a GliDe tree verify (tree (4,2,2): 29); the fused
# decode block serves the same forwards (T <= 32)
DECODE_ROWS_PER_SEQ = 32


def init_pieces(config: ModelArgs, dtype=torch.float32, scale: float = 0.02,
                seed: int = 0, device=None):
    """init_params's weights in the order they are drawn from one seeded
    torch.Generator on `device`: (leaf name, layer, tensor), a stacked
    weight one layer at a time (layer None for a whole leaf: the embedding,
    the norms, the output, None when tied). parallel/sharding's
    init_sharded_params keeps each rank's slice of the same stream."""
    device = resolve_device(device)
    c = config
    L, D, I = c.n_layer, c.dim, c.intermediate_size
    Dh, Hq, Hkv = c.head_dim, c.n_head, c.n_kv_head
    qkv_out = (Hq + 2 * Hkv) * Dh
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    yield "tok_embeddings", None, rnd(c.vocab_size, D)
    for name, shape in (("wqkv", (D, qkv_out)), ("wo", (Hq * Dh, D)),
                        ("w_gate_up", (D, 2, I)), ("w_down", (I, D))):
        for l in range(L):
            yield name, l, rnd(*shape)
    for name, shape in (("attn_norm", (L, D)), ("ffn_norm", (L, D)),
                        ("norm", (D,))):
        yield name, None, torch.ones(shape, dtype=dtype, device=device)
    yield "output", None, (None if c.tie_word_embeddings
                           else rnd(D, c.vocab_size))
    if c.qkv_bias:
        for l in range(L):
            yield "bqkv", l, rnd(qkv_out)


def init_params(config: ModelArgs, dtype=torch.float32, scale: float = 0.02,
                seed: int = 0, device=None) -> Params:
    """Random-normal params from a seeded torch.Generator on `device` (for
    tests and runs without checkpoints), drawn by init_pieces."""
    params: Params = {"layers": {}}
    for name, layer, t in init_pieces(config, dtype, scale, seed, device):
        if layer is None:
            top = name in ("tok_embeddings", "norm", "output")
            (params if top else params["layers"])[name] = t
            continue
        if layer == 0:
            params["layers"][name] = torch.empty(
                (config.n_layer, *t.shape), dtype=t.dtype, device=t.device)
        params["layers"][name][layer] = t
    return params


def params_from_numpy(tree, device=None) -> Params:
    """The JAX params pytree as numpy arrays (same keys and layout, `output`
    None when tied; bfloat16 leaves as ml_dtypes arrays) -> the port's params
    on `device`. Quantized weights carry over: int8's {"qT", "s"} dicts as
    dicts, and an int4 Int4ColWeight (recognised by its q4, s4 and
    out_shape) as the port's Int4ColWeight."""
    device = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("q4", "s4", "out_shape")):
        return Int4ColWeight(params_from_numpy(tree.q4, device),
                             params_from_numpy(tree.s4, device),
                             tuple(tree.out_shape))
    return tensor_from_numpy(np.asarray(tree)).to(device)


def row_bucket(B: int, T: int) -> int:
    """The padded row count of a forward of B sequences x T tokens: for
    T <= DECODE_ROWS_PER_SEQ (every decode-phase forward: AR, draft, verify,
    tree verify) B * DECODE_ROWS_PER_SEQ rounded up to ROW_BUCKET, whatever
    T is, so all of them run one shape; for a prefill chunk B*T rounded up
    to ROW_BUCKET."""
    rows = B * max(T, DECODE_ROWS_PER_SEQ)
    return -(-rows // ROW_BUCKET) * ROW_BUCKET


def _pad_rows(x2: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """[M, K] -> [rows, K] (rows None: M rounded up to ROW_BUCKET), pad rows
    zero."""
    if rows is None:
        rows = -(-x2.shape[0] // ROW_BUCKET) * ROW_BUCKET
    pad = rows - x2.shape[0]
    return F.pad(x2, (0, 0, 0, pad)) if pad else x2


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] at a row count padded to ROW_BUCKET, with a
    float32 result from operands in their storage dtype (bf16 products
    accumulated and returned in f32, as the JAX package's
    preferred_element_type=float32; the logits are never rounded to bf16)."""
    x2 = x.reshape(-1, x.shape[-1])
    xp = _pad_rows(x2)
    if xp.dtype == torch.float32:
        # f32 rows against bf16 weights (a GliDe block training in f32
        # against a bf16 target: train.glide_loss) promote the weights to
        # f32, as jnp.dot does; a no-op for f32 weights
        y = xp @ w.float()
    elif xp.is_cuda:
        y = torch.mm(xp, w, out_dtype=torch.float32)
    else:   # the CPU build has no kernel for mm's out_dtype variant
        y = xp.float() @ w.float()
    return y[:x2.shape[0]].reshape(*x.shape[:-1], w.shape[-1])


def _split_qkv(qkv: torch.Tensor, config: ModelArgs):
    """Split KV-head-major fused qkv [B, T, Hkv*(G+2)*Dh] into q/k/v views.

    Global q-head index = kv_head * G + g, matching HF's head order.
    """
    B, T = qkv.shape[:2]
    Dh, Hq, Hkv = config.head_dim, config.n_head, config.n_kv_head
    G = Hq // Hkv
    grouped = qkv.reshape(B, T, Hkv, (G + 2) * Dh)
    q = grouped[..., :G * Dh].reshape(B, T, Hq, Dh)
    k = grouped[..., G * Dh:(G + 1) * Dh]
    v = grouped[..., (G + 1) * Dh:]
    return q, k, v


def _layer(w, l: int):
    """Layer l of a stacked weight, plain or quantized."""
    if isinstance(w, dict):
        return {k: v[l] for k, v in w.items()}
    return w[l]


def _block(x: torch.Tensor, params: Params, config: ModelArgs,
           attn_impl: AttnImpl, caches: tuple, l: int, B: int, T: int,
           fused: bool = False) -> torch.Tensor:
    """One decoder block at layer l: pre-norm attention + pre-norm SwiGLU.
    x: [Mp, dim] padded rows, the first B*T of them the tokens. With fused,
    x is the B*T token rows unpadded and the weight products run through
    the fused decode block (ops/fused_block.py), whose rows do not depend
    on the row count."""
    lp = params["layers"]
    bqkv = lp["bqkv"][l] if "bqkv" in lp else None
    if fused:
        qkv = fused_qkv(x, lp["attn_norm"][l], lp["wqkv"][l], bqkv,
                        config.norm_eps)
        q, k, v = _split_qkv(qkv.reshape(B, T, -1), config)
        ctx = attn_impl(q, k, v, caches, l)
        return fused_post_attn(x, ctx.reshape(B * T, -1), lp["wo"][l],
                               lp["ffn_norm"][l], lp["w_gate_up"][l],
                               lp["w_down"][l], config.norm_eps)

    h = rms_norm(x, lp["attn_norm"][l], config.norm_eps)
    qkv = qmatmul(h, _layer(lp["wqkv"], l))
    if bqkv is not None:
        qkv = qkv + bqkv
    q, k, v = _split_qkv(qkv[:B * T].reshape(B, T, -1), config)
    ctx = attn_impl(q, k, v, caches, l)
    o = qmatmul(_pad_rows(ctx.reshape(B * T, -1), x.shape[0]),
                _layer(lp["wo"], l))
    x = x + _reduce_rows(o, B * T, config)

    h = rms_norm(x, lp["ffn_norm"][l], config.norm_eps)
    gate_up = qmatmul(h, _layer(lp["w_gate_up"], l))
    act = F.silu(gate_up[:, 0]) * gate_up[:, 1]
    return x + _reduce_rows(qmatmul(act, _layer(lp["w_down"], l)), B * T,
                            config)


def _reduce_rows(y: torch.Tensor, rows: int, config: ModelArgs):
    """A row-parallel product's partial sums [Mp, dim] all-reduced over the
    tp ranks (a no-op off-mesh). Only the `rows` token rows travel: the pad
    rows of every rank's partial are zero (zero rows stay zero through the
    norms and products), so their sum is too."""
    all_reduce_tp(y[:rows], config.mesh)
    return y


_FUSED_MODE = "auto"  # "auto" | "off": see set_fused_mode


def set_fused_mode(mode: str):
    """Process-wide switch of the fused decode block: "auto" (the default)
    routes every forward of T <= DECODE_ROWS_PER_SEQ tokens with plain
    weights on a CUDA device and no tensor-parallel mesh through fused_qkv
    and fused_post_attn (AR, draft and verify steps; prefill chunks keep
    the unfused path); "off" keeps the unfused path everywhere."""
    global _FUSED_MODE
    if mode not in ("auto", "off"):
        raise ValueError(f"fused mode {mode!r}: auto or off")
    _FUSED_MODE = mode


def _fused_auto(params: Params, config: ModelArgs, x: torch.Tensor, T: int,
                fused: bool | None) -> bool:
    """Resolve the fused switch from what the forward observes: an explicit
    value wins (True with quantized weights or on a tp mesh raises); "auto"
    means a CUDA device, T <= DECODE_ROWS_PER_SEQ, plain weights and no tp
    mesh. Off under tensor parallelism, as the JAX package's
    fused_for_mesh: the fused kernels take whole weights and hold no
    collective."""
    quantized = is_quantized(params["layers"]["wqkv"])
    tp = config.mesh is not None and config.mesh.tp > 1
    if fused is not None:
        if fused and quantized:
            raise ValueError("the fused decode block takes plain weights, "
                             "not quantized ones")
        if fused and tp:
            raise ValueError("the fused decode block does not run on a "
                             "tensor-parallel mesh: its kernels take whole "
                             "weights and hold no collective (the JAX "
                             "package's fused_for_mesh keeps it off too)")
        return fused
    return (_FUSED_MODE == "auto" and x.is_cuda
            and T <= DECODE_ROWS_PER_SEQ and not quantized and not tp)


def run_layers(params: Params, config: ModelArgs, x: torch.Tensor,
               attn_impl: AttnImpl, caches: tuple, B: int, T: int,
               fused: bool | None = None,
               remat: bool = False) -> torch.Tensor:
    """The decoder stack over padded rows x [Mp, dim]; caches are the full
    stacked [L, ...] tensors, which attn_impl writes in place at layer l.
    fused: see _fused_auto. The fused block runs the B*T token rows
    unpadded; they are padded to Mp again for the unembedding.

    remat=True checkpoints each layer (training, as the JAX package's
    jax.checkpoint over the scan): a layer keeps only its input for the
    backward pass and recomputes its activations, the attention logits
    among them, there. It changes no value: remat=False runs the layers as
    they are."""
    use_fused = _fused_auto(params, config, x, T, fused)
    rows = x.shape[0]
    if use_fused:
        x = x[:B * T]
    for l in range(config.n_layer):
        if remat:
            x = checkpoint(_block, x, params, config, attn_impl, caches, l, B,
                           T, use_fused, use_reentrant=False)
        else:
            x = _block(x, params, config, attn_impl, caches, l, B, T,
                       use_fused)
    return _pad_rows(x, rows) if use_fused else x


def embed(params: Params, config: ModelArgs, ids: torch.Tensor) -> torch.Tensor:
    """Token ids [N] -> embeddings [N, dim]. Under a tp mesh the table is
    vocab-parallel (the rank's contiguous block of V/tp rows): each rank
    looks up the ids in its block, zeros the others and the ranks'
    results are all-reduced, which is exact (one nonzero term a token)."""
    emb = params["tok_embeddings"]
    mesh = config.mesh
    if mesh is None or mesh.tp == 1:
        return F.embedding(ids.long(), emb)
    n = emb.shape[0]
    local = ids.long() - mesh.rank * n
    hit = ((local >= 0) & (local < n)).to(emb.dtype)[:, None]
    x = F.embedding(local.clamp(0, n - 1), emb) * hit
    return all_reduce_tp(x, mesh)


def unembed(params: Params, config: ModelArgs, x: torch.Tensor) -> torch.Tensor:
    """Final norm + lm_head; logits in float32. x's rows are padded to a
    multiple of ROW_BUCKET, which keeps row_bucket's count as it is. Under a
    tp mesh these are the rank's vocab columns (forward gathers them)."""
    x = rms_norm(x, params["norm"], config.norm_eps)
    w_out = (params["tok_embeddings"].t() if config.tie_word_embeddings
             else params["output"])
    return _matmul_f32(x, w_out)


def forward(params: Params, config: ModelArgs, tokens: torch.Tensor,
            attn_impl: AttnImpl, caches: tuple, last_only: bool = False,
            fused: bool | None = None, remat: bool = False) -> torch.Tensor:
    """tokens [B, T] -> logits float32 [B, T, V] ([B, 1, V] with last_only);
    the caches are written in place. fused: the fused decode block switch
    (None = auto; see _fused_auto); remat: checkpoint each layer (see
    run_layers). Under a tp mesh (config.mesh) every rank returns the same
    full logits: the vocab columns are gathered in rank order, so every
    rank takes the same argmax."""
    B, T = tokens.shape
    x = _pad_rows(embed(params, config, tokens.reshape(-1)), row_bucket(B, T))
    x = run_layers(params, config, x, attn_impl, caches, B, T, fused, remat)
    if last_only:
        x = _pad_rows(x[:B * T].reshape(B, T, -1)[:, -1], row_bucket(B, 1))
        T = 1
    logits = unembed(params, config, x)[:B * T]
    return all_gather_tp(logits, config.mesh, dim=1).reshape(B, T, -1)
