"""Rotary position embeddings, HF half-split convention (port of
magicdec_tpu/ops/rope.py).

Plain rope, linear position interpolation (positions / scaling_factor) and
llama-3.1 frequency rescaling (factor applied to inv_freq bands). Positions
are per-token int tensors, so a ragged batch rotates each sequence at its own
cache length.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from magicdec_tpu_torch.models.config import ModelArgs


@functools.lru_cache(maxsize=64)
def _inv_freq_cached(head_dim: int, rope_base: float, use_llama31: bool,
                     factor: float, low: float | None, high: float | None,
                     orig_ctx: int | None) -> np.ndarray:
    inv_freq = 1.0 / (rope_base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if use_llama31:
        low_wavelen = orig_ctx / low
        high_wavelen = orig_ctx / high
        wavelen = 2.0 * math.pi / inv_freq
        # smooth interpolation between the scaled and unscaled bands
        smooth = (orig_ctx / wavelen - low) / (high - low)
        inv_freq = np.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            np.where(wavelen < high_wavelen, inv_freq,
                     (1.0 - smooth) * inv_freq / factor + smooth * inv_freq),
        ).astype(np.float32)
    inv_freq.flags.writeable = False   # shared by every caller of the cache
    return inv_freq


def rope_inv_freq(config: ModelArgs) -> np.ndarray:
    """Per-band inverse frequencies [head_dim//2] float32, llama-3.1 rescaling
    baked in."""
    return _inv_freq_cached(
        config.head_dim, config.rope_base, config.use_llama31_rope,
        float(config.scaling_factor), config.low_freq_factor,
        config.high_freq_factor, config.original_max_position_embeddings)


def rope_cos_sin(config: ModelArgs, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (float32) for integer positions of any shape ->
    [..., head_dim]."""
    inv_freq = torch.tensor(rope_inv_freq(config), device=positions.device)
    pos = positions.to(torch.float32)
    if not config.use_llama31_rope and config.scaling_factor != 1.0:
        pos = pos / config.scaling_factor  # linear position interpolation
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., T, H, D] with cos/sin [..., T, D] (broadcast over heads),
    in float32, cast back to x's dtype."""
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def rope(config: ModelArgs, x: torch.Tensor,
         positions: torch.Tensor) -> torch.Tensor:
    """Convenience: rotate x [B, T, H, D] at integer positions [B, T]."""
    cos, sin = rope_cos_sin(config, positions)
    return apply_rope(x, cos, sin)
