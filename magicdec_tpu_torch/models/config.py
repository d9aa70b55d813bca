"""Model configuration table for the Llama/Qwen/Yi/Mistral decoder family.

PyTorch-port copy of magicdec_tpu/models/config.py: the same fields, the same
name -> config registry and the same fuzzy longest-substring lookup, so a
config name resolves to identical hyperparameters in both packages. The port
keeps its own copy (it imports nothing of the JAX package); the dataclass is
plain (not frozen), since nothing here needs it hashable.

Rope convention: HF "half-split" (rotate_half) layout. The rope variant
follows from the fields: plain, linear position interpolation, or llama-3.1
frequency scaling (see ops/rope.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


@dataclass
class ModelArgs:
    block_size: int = 2048
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    dim: int = 4096
    intermediate_size: Optional[int] = None
    n_kv_head: int = -1          # GQA KV heads (reference calls this n_local_heads)
    head_dim: int = -1           # -1 -> derived as dim // n_head; explicit for
                                 # padded-head TP configs (sharding.pad_model_for_tp)
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    # Rope scaling. scaling_factor==1.0 -> plain rope.
    # If the low/high freq factors are set -> llama-3.1 frequency scaling
    # (factor applied to inv_freq), otherwise linear position interpolation
    # (positions divided by scaling_factor).
    scaling_factor: float = 1.0
    low_freq_factor: Optional[float] = None
    high_freq_factor: Optional[float] = None
    original_max_position_embeddings: Optional[int] = None
    qkv_bias: bool = False       # Qwen2.5
    tie_word_embeddings: bool = False
    # not a field, so a config compares and prints as the JAX package's: the
    # tp mesh a rank's local config carries (parallel/sharding.local_config
    # sets it on the instance), which the model and the drafts read; None
    # off-mesh
    mesh = None

    def __post_init__(self):
        if self.n_kv_head == -1:
            self.n_kv_head = self.n_head
        if self.intermediate_size is None:
            hidden = int(2 * (4 * self.dim) / 3)
            self.intermediate_size = find_multiple(hidden, 256)
        if self.head_dim == -1:
            self.head_dim = self.dim // self.n_head

    @property
    def use_llama31_rope(self) -> bool:
        return self.low_freq_factor is not None and self.high_freq_factor is not None

    def replace(self, **kw) -> "ModelArgs":
        if ("dim" in kw or "n_head" in kw) and "head_dim" not in kw:
            kw["head_dim"] = -1          # re-derive from the new dim/n_head
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_name(cls, name: str) -> "ModelArgs":
        """Exact lookup, falling back to longest-substring fuzzy match.

        Mirrors the reference's lookup semantics (Engine/SnapKV/model.py:45-58)
        so checkpoint paths like `meta-llama/Llama-3.1-8B-Instruct` resolve.
        """
        if name in TRANSFORMER_CONFIGS:
            return cls(**TRANSFORMER_CONFIGS[name])
        matches = [k for k in TRANSFORMER_CONFIGS if k.lower() in str(name).lower()]
        if not matches:
            raise ValueError(f"no config matching {name!r}; known: {sorted(TRANSFORMER_CONFIGS)}")
        matches.sort(key=len, reverse=True)
        if len(matches) > 1 and len(matches[0]) == len(matches[1]):
            raise ValueError(f"ambiguous config for {name!r}: {matches[:2]}")
        return cls(**TRANSFORMER_CONFIGS[matches[0]])


_LLAMA31 = dict(rope_base=500000.0, scaling_factor=8, high_freq_factor=4,
                low_freq_factor=1, original_max_position_embeddings=8192,
                vocab_size=128256, block_size=131072)

# Architecture hyperparameters for the model families the reference supports
# (reference registry: Engine/SnapKV/model.py:61-81), plus tiny test configs.
TRANSFORMER_CONFIGS: dict[str, dict] = {
    "llama-2-7b": dict(block_size=4096, n_layer=32, n_head=32, dim=4096),
    "llama-2-7b-32k": dict(block_size=32768, n_layer=32, n_head=32, dim=4096,
                           vocab_size=32000, scaling_factor=8),
    "longchat-7b-v1.5-32k": dict(block_size=32768, n_layer=32, n_head=32, dim=4096,
                                 vocab_size=32000, scaling_factor=8),
    "llama-2-13b": dict(block_size=4096, n_layer=40, n_head=40, dim=5120),
    "llama-2-70b": dict(block_size=4096, n_layer=80, n_head=64, dim=8192,
                        n_kv_head=8, intermediate_size=28672),
    "llama-3-8b": dict(block_size=8192, n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                       intermediate_size=14336, vocab_size=128256, rope_base=500000.0),
    "llama-3-70b": dict(block_size=8192, n_layer=80, n_head=64, n_kv_head=8, dim=8192,
                        intermediate_size=28672, vocab_size=128256, rope_base=500000.0),
    "68m": dict(block_size=2048, n_layer=2, n_head=12, n_kv_head=12, dim=768,
                intermediate_size=3072, vocab_size=32000),
    "tinyllama": dict(block_size=2048, n_layer=22, n_head=32, n_kv_head=4, dim=2048,
                      intermediate_size=5632, vocab_size=32000),
    "llama-3.1-8b": dict(n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                         intermediate_size=14336, **_LLAMA31),
    "llama-3.1-70b": dict(n_layer=80, n_head=64, n_kv_head=8, dim=8192,
                          intermediate_size=28672, **_LLAMA31),
    "llama-3.2-1b": dict(n_layer=16, n_head=32, n_kv_head=8, dim=2048,
                         intermediate_size=8192, tie_word_embeddings=True,
                         **{**_LLAMA31, "scaling_factor": 32}),
    "llama-3.2-3b": dict(n_layer=28, n_head=24, n_kv_head=8, dim=3072,
                         intermediate_size=8192, tie_word_embeddings=True,
                         **{**_LLAMA31, "scaling_factor": 32}),
    "Qwen2.5-7b": dict(block_size=131072, n_layer=28, n_head=28, n_kv_head=4, dim=3584,
                       intermediate_size=18944, vocab_size=152064, rope_base=1000000.0,
                       qkv_bias=True, norm_eps=1e-6),
    "Qwen2.5-14b": dict(block_size=131072, n_layer=48, n_head=40, n_kv_head=8, dim=5120,
                        intermediate_size=13824, vocab_size=152064, rope_base=1000000.0,
                        qkv_bias=True, norm_eps=1e-6),
    "Qwen2.5-32b": dict(block_size=131072, n_layer=64, n_head=40, n_kv_head=8, dim=5120,
                        intermediate_size=27648, vocab_size=152064, rope_base=1000000.0,
                        qkv_bias=True, norm_eps=1e-6),
    "Yi-1.5-6b": dict(block_size=4096, n_layer=32, n_head=32, n_kv_head=4, dim=4096,
                      intermediate_size=11008, vocab_size=64000, rope_base=500000.0),
    "Yi-1.5-34b-32k": dict(block_size=32768, n_layer=60, n_head=56, n_kv_head=8, dim=7168,
                           intermediate_size=20480, vocab_size=64000, rope_base=500000.0),
    "Mistral-7B-v0.1": dict(n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                            intermediate_size=14336, vocab_size=32000),
    "Mistral-7B-v0.3": dict(n_layer=32, n_head=32, n_kv_head=8, dim=4096,
                            intermediate_size=14336, vocab_size=32768, rope_base=1000000.0),
    # Tiny configs for unit tests / CI (not in the reference).
    "test-tiny": dict(block_size=512, n_layer=2, n_head=4, n_kv_head=2, dim=128,
                      intermediate_size=256, vocab_size=256),
    "test-tiny-31": dict(n_layer=2, n_head=4, n_kv_head=2, dim=128,
                         intermediate_size=256, **{**_LLAMA31, "vocab_size": 256,
                                                   "block_size": 1024}),
}
