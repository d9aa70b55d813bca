"""Tracing and profiling utilities (port of magicdec_tpu/utils/profiling.py).

The reference times phases with torch.cuda.synchronize() + time.time()
buckets (tests/SnapKV/selfspec_benchmark.py:153-171); here the same
wall-clock buckets, a step timer, and torch.profiler traces in the Chrome
trace format (viewable in Perfetto or TensorBoard), where the JAX package
writes jax.profiler traces.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _tensors(tree):
    """The tensor leaves of a tensor or of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for the work that computes tree's tensors: a synchronize of
    each CUDA device one of them lies on (the CPU computes eagerly)."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of everything inside the context (CPU ops, and
    CUDA kernels where there is a GPU), written into log_dir on exit as a
    Chrome trace (`<worker>.<ms>.pt.trace.json`)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class PhaseClock:
    """Synchronized wall-clock buckets (draft/verify/loop in the reference)."""

    def __init__(self):
        self.buckets: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """Time the body into bucket `name`; sync_on (a tensor or a tree of
        tensors) is waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            block_until_ready(sync_on)
        self.buckets[name] = (self.buckets.get(name, 0.0)
                              + time.perf_counter() - t0)
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {k: {"total_s": round(v, 4),
                    "avg_ms": round(v / self.counts[k] * 1e3, 3)}
                for k, v in self.buckets.items()}


def step_cost_report(fn, *args, iters: int = 10, label: str = "step"):
    """Time fn(*args): one warm call, a sync, then iters calls and a sync on
    what the last one returned."""
    out = fn(*args)
    block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return {label: {"ms": round(dt * 1e3, 3)}}
