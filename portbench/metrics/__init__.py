"""Metric readers, one file a metric: metrics/<name>.py defines
read(run) -> float | None (None: nothing to read in this run, and the
metric is left out of the line). Loaded by file name, so a name may hold
dots (`gemm_roofline.decode.py`)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

DIR = Path(__file__).resolve().parent


def reader(name: str):
    """The read function of metrics/<name>.py."""
    path = DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
