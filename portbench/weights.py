"""The benchmark's own weights and prompts, drawn on the device from --seed.

Weights follow the program's params layout (magicdec_tpu_torch/models/
llama.py): products stored [in, out] and stacked over layers, wqkv columns
KV-head-major ([q heads of KV head 0 | k0 | v0 | q heads of KV head 1 ...]),
gate and up stacked as [L, D, 2, I], the qkv bias as [L, qkv_out]. They are
drawn here and not by the program's init_params, so the yardstick does not
move when the program does: one normal_ call per leaf, in the served dtype,
at the config's initializer_range (HF's init) with unit norm weights.
"""

from __future__ import annotations

import hashlib

import torch

from portbench.layout import Sizes


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed for (seed, *tags): every job, leaf and sample
    draws from its own stream, whatever the size of --seed."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def shapes(s: Sizes) -> dict:
    """Leaf name -> shape, in the order the leaves are drawn."""
    out = {"tok_embeddings": (s.vocab, s.dim),
           "wqkv": (s.n_layer, s.dim, s.qkv_out),
           "wo": (s.n_layer, s.n_head * s.head_dim, s.dim),
           "w_gate_up": (s.n_layer, s.dim, 2, s.intermediate),
           "w_down": (s.n_layer, s.intermediate, s.dim)}
    if not s.tied:
        out["output"] = (s.dim, s.vocab)
    if s.qkv_bias:
        out["bqkv"] = (s.n_layer, s.qkv_out)
    return out


LAYER_LEAVES = ("wqkv", "wo", "w_gate_up", "w_down", "bqkv", "attn_norm",
                "ffn_norm")


def make(s: Sizes, seed: int, device, dtype=torch.bfloat16,
         std: float = 0.02, bias_std: float = 0.02) -> dict:
    """The params dict for seed, every leaf drawn in place on `device`."""
    params = {"layers": {}}
    for name, shape in shapes(s).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        (params["layers"] if name in LAYER_LEAVES else params)[name] = t
    params["layers"]["attn_norm"] = torch.ones((s.n_layer, s.dim), dtype=dtype,
                                               device=device)
    params["layers"]["ffn_norm"] = torch.ones_like(
        params["layers"]["attn_norm"])
    params["norm"] = torch.ones(s.dim, dtype=dtype, device=device)
    params["output"] = params.get("output")
    redraw(params, s, seed, std, bias_std)
    return params


def redraw(params: dict, s: Sizes, seed: int, std: float = 0.02,
           bias_std: float = 0.02) -> None:
    """Draw every random leaf of params again, in place, for seed."""
    for name in shapes(s):
        fill(params["layers"][name] if name in LAYER_LEAVES else params[name],
             name, seed, std, bias_std)


def fill(t: torch.Tensor, name: str, seed: int, std: float = 0.02,
         bias_std: float = 0.02) -> None:
    """Draw the whole leaf `name` into t, in place: one normal_ call from
    its own generator on t's device. A leaf drawn alone (world.rank_params)
    is bit for bit the leaf that make draws."""
    gen = torch.Generator(device=t.device).manual_seed(
        derive(seed, "weights", name))
    t.normal_(0.0, bias_std if name == "bqkv" else std, generator=gen)


def prompts(seed: int, job: int, batch: int, length: int, vocab: int,
            device) -> torch.Tensor:
    """Job `job`'s prompts [batch, length] int32: ids uniform over the
    vocabulary, from their own stream of the seed."""
    gen = torch.Generator(device=device).manual_seed(
        derive(seed, "prompts", job))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)
