"""Token selection: greedy argmax, temperature/top-p sampling, and the
categorical and uniform draws of the stochastic verifiers (port of
magicdec_tpu/engine/sampling.py and the jax.random calls of
engine/glide_engine.py). Random draws come from an explicit
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


def categorical(generator: torch.Generator, *, logits=None, probs=None,
                num_samples: int = 1) -> torch.Tensor:
    """num_samples i.i.d. draws (with replacement) from the categorical
    distribution over the last axis of logits (softmax) or of probs (rows of
    non-negative weights) -> int32 [..., num_samples]."""
    if (logits is None) == (probs is None):
        raise ValueError("give exactly one of logits and probs")
    p = torch.softmax(logits.float(), dim=-1) if probs is None else probs
    flat = p.reshape(-1, p.shape[-1])
    tok = torch.multinomial(flat, num_samples, replacement=True,
                            generator=generator)
    return tok.reshape(*p.shape[:-1], num_samples).to(torch.int32)


def uniform(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniform float32 draws in [0, 1) of `shape`."""
    return torch.rand(shape, generator=generator, device=device)


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
