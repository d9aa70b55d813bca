"""Checkpoint downloader (port of magicdec_tpu/checkpoint/download.py).

A thin huggingface_hub snapshot_download wrapper with token handling. It
needs the network; without huggingface_hub it raises with a clear message.
"""

from __future__ import annotations

import os


def snapshot_download(repo_id: str, local_dir: str | None,
                      token: str | None) -> str:
    """huggingface_hub.snapshot_download, or a RuntimeError that says what
    to do instead where huggingface_hub is missing."""
    try:
        from huggingface_hub import snapshot_download as download
    except ImportError as e:
        raise RuntimeError(
            "hf_download requires huggingface_hub (and the network); pass a "
            "local checkpoint directory to "
            "checkpoint.convert_hf.load_hf_checkpoint instead") from e
    return download(repo_id, local_dir=local_dir, token=token)


def hf_download(repo_id: str, local_dir: str | None = None,
                hf_token: str | None = None) -> str:
    """Download an HF checkpoint snapshot; returns the local directory,
    ready for checkpoint.convert_hf.load_hf_checkpoint."""
    local_dir = local_dir or os.path.join(
        "checkpoints", repo_id.replace("/", "--"))
    return snapshot_download(repo_id, local_dir,
                             hf_token or os.environ.get("HF_TOKEN"))
