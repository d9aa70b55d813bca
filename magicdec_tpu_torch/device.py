"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no GPU
and no explicit device they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
