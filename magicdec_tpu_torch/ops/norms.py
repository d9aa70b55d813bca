"""RMSNorm with fp32 accumulation (port of magicdec_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight: normalize in float32, cast back to
    the input dtype, then scale by the (possibly lower-precision) weight —
    HF LlamaRMSNorm numerics, as in the JAX package."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * weight
