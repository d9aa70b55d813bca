"""Weight-only quantization: int8 per channel and int4 per group of K rows
(port of magicdec_tpu/quant/int8.py).

A quantized weight replaces a plain one in the params dict and keeps its
leading layer axis; the model's layer loop slices it per layer and
`qmatmul` runs the product:
  * int8, as quantize_params stores it: {"qT": [L, prod(out), K] int8,
    "s": float32 scales in the weight's keepdims shape ([L, 1, O],
    [L, 1, 2, I], [L, 1, D])}. qmatmul dequantizes the weight element-wise
    (q * s, rounded to x's dtype) before a plain matmul. The scale is never
    applied to the output: an output epilogue rounds differently at the
    draft's and the verify's row counts and breaks the full-budget
    acceptance of exactly 1.0 (tests/test_quant.py in the JAX package).
  * int4, as quantize_params stores it: an Int4ColWeight, the column-pair
    biased nibbles of ops/int4_matmul.py, which qmatmul runs through the
    int4_matmul kernel (its plain version on the CPU).
  * Int4Weight: signed nibbles packed in K pairs along in_axis, dequantized
    before the product.
Embeddings, norms and the output head stay in their dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from magicdec_tpu_torch.ops.int4_matmul import int4_matmul, pack_int4_cols


@dataclass
class Int4Weight:
    """Nibble-packed signed int4 weight. in_axis is negative (it names the
    same contraction axis with or without the leading layer axis); q4 packs
    K pairs along it (even index in the low nibble), s4 holds one scale per
    group of group_size rows along it."""
    q4: torch.Tensor
    s4: torch.Tensor
    in_axis: int
    group_size: int


@dataclass
class Int4ColWeight:
    """The int4_matmul layout: q4 [(L,) K, N/2] int8, s4 [(L,) K/g, N]
    float32; out_shape the product's trailing shape ((2, I) for the stacked
    gate/up weight, whose [D, 2, I] folds to [D, 2I])."""
    q4: torch.Tensor
    s4: torch.Tensor
    out_shape: tuple

    def __getitem__(self, layer: int) -> "Int4ColWeight":
        return Int4ColWeight(self.q4[layer], self.s4[layer], self.out_shape)


def quantize_int8(w: torch.Tensor, reduce_axes: tuple) -> dict:
    """Symmetric int8 with scales over `reduce_axes` (the contraction axes),
    kept with size 1 so they broadcast against the weight."""
    wf = w.float()
    absmax = wf.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -128, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize_int8(qw: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight of an int8 dict, in its unfolded [..., K, *out] layout;
    reads both quantize_int8's {"q", "s"} and quantize_params' folded
    {"qT", "s"}."""
    s = qw["s"]
    if "qT" not in qw:
        return (qw["q"].float() * s).to(dtype)
    qT = qw["qT"]
    lead = qT.shape[:-2]
    out = s.shape[len(lead) + 1:]
    q = qT.transpose(-1, -2).reshape(*lead, qT.shape[-1], *out)
    return (q.float() * s).to(dtype)


def quantize_int4(w: torch.Tensor, in_axis: int,
                  group_size: int = 128) -> Int4Weight:
    """Group-wise symmetric int4 along the contraction axis `in_axis`
    (negative); nibble pairs packed into one int8 along that axis (even
    index in the low nibble)."""
    if in_axis >= 0:
        raise ValueError("in_axis must be negative (layer-axis agnostic)")
    K = w.shape[in_axis]
    if K % group_size or group_size % 2:
        raise ValueError(f"K={K} must be a multiple of the even group size "
                         f"{group_size}")
    wf = torch.movedim(w.float(), in_axis, -2)                # [..., K, out]
    lead, out = wf.shape[:-2], wf.shape[-1]
    grouped = wf.reshape(*lead, K // group_size, group_size, out)
    absmax = grouped.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 7.0               # [..., G, 1, out]
    q = torch.clamp(torch.round(grouped / scale), -8, 7).to(torch.int32)
    q = q.reshape(*lead, K, out)
    packed = ((q[..., 1::2, :] & 0xF) << 4) | (q[..., 0::2, :] & 0xF)
    packed = torch.movedim(packed.to(torch.uint8).view(torch.int8), -2,
                           in_axis)
    scale = torch.movedim(scale.squeeze(-2), -2, in_axis)     # groups on in_axis
    return Int4Weight(q4=packed.contiguous(), s4=scale.contiguous(),
                      in_axis=in_axis, group_size=group_size)


def dequantize_int4(qw: Int4Weight, dtype=torch.bfloat16) -> torch.Tensor:
    in_axis, g = qw.in_axis, qw.group_size
    packed = torch.movedim(qw.q4, in_axis, -2).to(torch.int32)
    s4 = torch.movedim(qw.s4, in_axis, -2)
    lead, K2, out = packed.shape[:-2], packed.shape[-2], packed.shape[-1]
    lo = ((packed & 0xF) ^ 8) - 8                             # sign-extend
    hi = packed >> 4                                          # arithmetic
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * K2, out).float()
    grouped = q.reshape(*lead, 2 * K2 // g, g, out)
    wf = (grouped * s4[..., :, None, :]).reshape(*lead, 2 * K2, out)
    return torch.movedim(wf, -2, in_axis).to(dtype)


def quantize_int4_cols(w: torch.Tensor, in_axis: int,
                       group_size: int = 128) -> Int4ColWeight:
    """Layer-stacked weight [L, ..in/out..] -> Int4ColWeight (the kernel's
    layout). in_axis negative; the axes after it fold into one output."""
    lead = w.shape[:w.dim() + in_axis]
    K = w.shape[in_axis]
    out_shape = tuple(w.shape[w.dim() + in_axis + 1:])
    q4, s4 = pack_int4_cols(w.reshape(*lead, K, -1), group_size=group_size)
    return Int4ColWeight(q4=q4.contiguous(), s4=s4.contiguous(),
                         out_shape=out_shape)


_QUANT_SPECS = {  # weight name -> contraction axis, negative (layer-agnostic)
    "wqkv": -2,        # [L, D, O]
    "wo": -2,          # [L, HqD, D]
    "w_gate_up": -3,   # [L, D, 2, I]
    "w_down": -2,      # [L, I, D]
}


def quantize_params(params: dict, mode: str = "int8") -> dict:
    """Quantize the layer matmul weights of a params dict ("int8" or
    "int4"); embeddings, norms and the output head are kept. int8 is stored
    transposed and folded, {"qT": [L, prod(out), K], "s": keepdims scale},
    as in the JAX package; int4 as Int4ColWeight."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantization mode {mode!r}: int8 or int4")
    out = dict(params)
    layers = dict(params["layers"])
    for name, axis in _QUANT_SPECS.items():
        w = layers[name]
        if mode == "int8":
            qw = quantize_int8(w, reduce_axes=(axis,))
            q = qw["q"]
            lead = q.shape[:q.dim() + axis]
            q = q.reshape(*lead, q.shape[q.dim() + axis], -1)
            layers[name] = {"qT": q.transpose(-1, -2).contiguous(),
                            "s": qw["s"]}
        else:
            layers[name] = quantize_int4_cols(w, in_axis=axis)
    out["layers"] = layers
    return out


def is_quantized(w) -> bool:
    """Whether a layer weight is one of the quantized forms above."""
    return isinstance(w, (dict, Int4Weight, Int4ColWeight))


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ one layer's weight [K, *out] -> [..., *out], for plain,
    int8 and int4 weights (the weight already sliced to its layer)."""
    if isinstance(w, dict):
        if "qT" not in w:
            raise ValueError("qmatmul takes int8 weights in quantize_params' "
                             "stored form {'qT', 's'}")
        qT = w["qT"]
        if qT.dim() != 2:
            raise ValueError(f"qT {tuple(qT.shape)}: qmatmul takes one "
                             f"layer's [N, K] weight (slice the layer first)")
        s = _strip_lead_ones(w["s"])
        # the scale multiplies the weight element-wise, before the product:
        # the product is then the plain one, whose rows do not depend on
        # the row count at the model's padded rows
        wd = (qT.float() * s.reshape(-1)[:, None]).to(x.dtype)
        y = x @ wd.t()
        return y.reshape(*y.shape[:-1], *s.shape) if s.dim() > 1 else y
    if isinstance(w, Int4ColWeight):
        y = int4_matmul(x.reshape(-1, x.shape[-1]), w.q4, w.s4)
        return y.reshape(*x.shape[:-1], *(w.out_shape or (y.shape[-1],)))
    if isinstance(w, Int4Weight):
        w = dequantize_int4(w, x.dtype)
    return _plain(x, w)


def _plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, *out] -> [..., *out]."""
    y = x @ w.reshape(w.shape[0], -1)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _strip_lead_ones(s: torch.Tensor) -> torch.Tensor:
    """Drop leading size-1 (contraction) axes so the per-output-channel scale
    aligns with the product's output by trailing broadcast."""
    while s.dim() > 1 and s.shape[0] == 1:
        s = s[0]
    return s
