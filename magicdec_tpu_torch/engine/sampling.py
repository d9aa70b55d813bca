"""Token selection: greedy argmax and temperature/top-p sampling (port of
magicdec_tpu/engine/sampling.py). Random draws come from an explicit
torch.Generator, so they differ from jax.random's for the same seed."""

from __future__ import annotations

import torch


def argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy tokens, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the top-p nucleus (along the last axis); the best
    token is always kept."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
    cutoff_idx = torch.clamp(cutoff_idx, max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           temperature: float = 0.6, top_p: float = 0.9) -> torch.Tensor:
    """Temperature + nucleus sampling over the last axis -> int32 tokens of
    logits.shape[:-1]."""
    logits = logits / max(temperature, 1e-5)
    logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=generator)
    return tok.reshape(logits.shape[:-1]).to(torch.int32)
