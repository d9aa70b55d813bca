"""The JAX package's npz checkpoint format, read and written (port of
magicdec_tpu/checkpoint/store.py's save_params, load_params and
hf_download).

A checkpoint is a flat .npz of "/"-joined keys. Dtypes numpy lacks
(bfloat16) are stored as a uint16 bit view plus a `<key>@dtype` tag; they are
written and read back through an int16 view of the tensor, without
ml_dtypes. A file written here loads in the JAX package and the other way
round.
"""

from __future__ import annotations

import numpy as np
import torch

from magicdec_tpu_torch.checkpoint.download import snapshot_download


def flatten_params(tree, prefix: str = "") -> dict:
    """A params tree (dicts, lists or tuples of tensors) -> {"/"-joined path:
    tensor}, dict keys in sorted order as jax.tree_util walks them; None
    leaves (a tied `output`) are skipped."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def save_params(path: str, params) -> None:
    """Write a params tree as the JAX package's save_params does: one entry
    a leaf under its "/"-joined path, None leaves skipped, a bfloat16 leaf
    as its uint16 bit view plus a `<key>@dtype` tag "bfloat16"."""
    flat = {}
    for key, t in flatten_params(params).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
            flat[key + "@dtype"] = np.str_("bfloat16")
        else:
            flat[key] = t.numpy()
    np.savez(path, **flat)


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


def hf_download(repo_id: str, local_dir: str | None = None,
                token: str | None = None) -> str:
    """HF snapshot download wrapper (as the JAX package's store.hf_download:
    local_dir and token passed as given). Raises a clear error where
    huggingface_hub is missing."""
    return snapshot_download(repo_id, local_dir, token)
