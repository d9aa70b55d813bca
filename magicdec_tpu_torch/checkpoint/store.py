"""Loader for the JAX package's npz checkpoint format (port of the reading
half of magicdec_tpu/checkpoint/store.py).

A checkpoint is a flat .npz of "/"-joined keys. Dtypes numpy lacks
(bfloat16) are stored as a uint16 bit view plus a `<key>@dtype` tag; they are
read back as torch tensors through an int16 view, without ml_dtypes.
"""

from __future__ import annotations

import numpy as np
import torch



def tensor_from_numpy(arr: np.ndarray, dtype_name: str | None = None
                      ) -> torch.Tensor:
    """numpy array -> CPU tensor. `dtype_name` names the real dtype of a
    16-bit bit view (the `@dtype` tag); a bfloat16 array of ml_dtypes is
    recognised by its own dtype name."""
    if (dtype_name or arr.dtype.name) == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_params(path: str, device=None, dtype=None) -> dict:
    """Load a checkpoint into the nested-dict params form its keys imply, on
    `device` (default CPU), optionally cast to `dtype`. Leaves the writer
    skipped (None, as `output` with tied embeddings) come back as None where
    the params layout expects them."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key.endswith("@dtype"):
                continue
            tag = key + "@dtype"
            name = str(data[tag]) if tag in data.files else None
            t = tensor_from_numpy(data[key], name).to(device)
            if dtype is not None:
                t = t.to(dtype)
            node = out
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = t
    if "tok_embeddings" in out:
        out.setdefault("output", None)
    return out
