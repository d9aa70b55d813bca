"""HF checkpoint -> the port's params (port of
magicdec_tpu/checkpoint/convert_hf.py).

The same mapping as the JAX package's: weights in [in, out] layout, q/k/v
fused KV-head-major, gate/up stacked as [D, 2, I], layer weights stacked on
a leading axis, no rotary permutation (the port uses HF's half-split rope),
`output` None with tied embeddings. Where the JAX package converts the whole
state dict to float32 numpy first, the port converts one tensor at a time on
its way to the device; every leaf still goes through float32 before its
cast, so it equals the JAX package's bit for bit.

Safetensors files are read by a reader of this module (`read_safetensors`),
not by the `safetensors` package, which the card's machine lacks.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelArgs
from .store import tensor_from_numpy

# safetensors dtype tag -> (dtype the bytes are read as, dtype of the tensor):
# the weight dtypes of HF checkpoints; bfloat16 is read as int16 and viewed,
# as store.tensor_from_numpy does
_ST_DTYPES = {
    "F32": (torch.float32, torch.float32),
    "F16": (torch.float16, torch.float16),
    "BF16": (torch.int16, torch.bfloat16),
}


def read_safetensors(path) -> dict[str, torch.Tensor]:
    """The tensors of one safetensors file as CPU tensors over a private
    memory map of it (nothing is read until a tensor is used; writing a
    tensor never reaches the file).

    The format: an 8-byte little-endian header length, a JSON header of
    {name: {"dtype", "shape", "data_offsets": [begin, end]}} (and an
    optional "__metadata__" entry), then the raw little-endian bytes, the
    offsets counted from the end of the header."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes past the file's end")
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, which this reader does "
                             f"not read (known: {sorted(_ST_DTYPES)})")
        raw, dtype = _ST_DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=raw).element_size()
        if not 0 <= begin <= end <= size - base or end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{[begin, end]} that do not hold its shape "
                             f"{shape} of {info['dtype']}")
        if count == 0:
            t = torch.empty(shape, dtype=raw)
        else:
            t = torch.frombuffer(buf, dtype=raw, count=count,
                                 offset=base + begin).reshape(shape)
        out[name] = t.view(dtype) if dtype != raw else t
    return out


def params_from_hf_state_dict(state_dict, config: ModelArgs, dtype=None,
                              device=None):
    """Convert an HF LlamaForCausalLM-style state dict (tensors, or numpy
    arrays) into the port's params on `device` (None: the current CUDA
    device; raises without one), in `dtype` (None: float32)."""
    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype

    def get(name):
        t = state_dict[name]
        if not isinstance(t, torch.Tensor):
            t = tensor_from_numpy(np.asarray(t))
        # a copy: a leaf never shares memory with the caller's tensor or
        # with a file's memory map
        return t.to(device, torch.float32, copy=True)

    L = config.n_layer
    Dh, Hq, Hkv = config.head_dim, config.n_head, config.n_kv_head
    G = Hq // Hkv

    def stack(per_layer):
        """[L, ...] in dtype, one layer converted at a time."""
        out = None
        for i in range(L):
            w = per_layer(i)
            if out is None:
                out = torch.empty((L, *w.shape), dtype=dtype, device=device)
            out[i] = w.to(dtype)
        return out

    def qkv(i, kind):
        """q/k/v fused KV-HEAD-MAJOR: [qs of group 0 | k0 | v0 | qs of 1 |
        ...], so a tp shard never splits a GQA group."""
        p = f"model.layers.{i}.self_attn."
        q, k, v = (get(f"{p}{n}_proj.{kind}") for n in "qkv")
        if kind == "weight":
            D = q.shape[1]
            fused = torch.cat([q.t().reshape(D, Hkv, G * Dh),
                               k.t().reshape(D, Hkv, Dh),
                               v.t().reshape(D, Hkv, Dh)], dim=2)
            return fused.reshape(D, Hkv * (G + 2) * Dh)
        return torch.cat([q.reshape(Hkv, G * Dh), k.reshape(Hkv, Dh),
                          v.reshape(Hkv, Dh)], dim=1).reshape(-1)

    def gate_up(i):
        p = f"model.layers.{i}.mlp."
        return torch.stack([get(p + "gate_proj.weight").t(),
                            get(p + "up_proj.weight").t()], dim=1)  # [D, 2, I]

    def plain(fmt, transpose=False):
        def one(i):
            w = get(fmt.format(i=i))
            return w.t() if transpose else w
        return one

    layers = {
        "attn_norm": stack(plain("model.layers.{i}.input_layernorm.weight")),
        "wqkv": stack(lambda i: qkv(i, "weight")),
        "wo": stack(plain("model.layers.{i}.self_attn.o_proj.weight", True)),
        "ffn_norm": stack(plain(
            "model.layers.{i}.post_attention_layernorm.weight")),
        "w_gate_up": stack(gate_up),
        "w_down": stack(plain("model.layers.{i}.mlp.down_proj.weight", True)),
    }
    if config.qkv_bias:
        layers["bqkv"] = stack(lambda i: qkv(i, "bias"))
    return {
        "tok_embeddings": get("model.embed_tokens.weight").to(dtype),
        "layers": layers,
        "norm": get("model.norm.weight").to(dtype),
        "output": (None if config.tie_word_embeddings
                   else get("lm_head.weight").t().contiguous().to(dtype)),
    }


def load_hf_checkpoint(checkpoint_dir, config: ModelArgs | None = None,
                       dtype=torch.bfloat16, device=None):
    """Load an HF model directory and convert it: a single
    model.safetensors, or model.safetensors.index.json with its weight_map
    shards, else pytorch_model*.bin. The config comes from the directory's
    name when none is given. Returns (params on `device`, config)."""
    device = resolve_device(device)
    d = Path(checkpoint_dir)
    if config is None:
        config = ModelArgs.from_name(d.name)

    state_dict = {}
    st_index = d / "model.safetensors.index.json"
    single = d / "model.safetensors"
    if st_index.exists() or single.exists():
        files = ([single] if single.exists() else
                 sorted({d / f for f in
                         json.loads(st_index.read_text())["weight_map"].values()}))
        for f in files:
            state_dict.update(read_safetensors(f))
    else:
        bins = sorted(d.glob("pytorch_model*.bin"))
        if not bins:
            raise FileNotFoundError(f"no safetensors or .bin weights in {d}")
        for f in bins:
            state_dict.update(torch.load(str(f), map_location="cpu",
                                         weights_only=True, mmap=True))
    return params_from_hf_state_dict(state_dict, config, dtype=dtype,
                                     device=device), config
