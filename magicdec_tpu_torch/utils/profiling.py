"""Tracing and profiling utilities (port of magicdec_tpu/utils/profiling.py).

The reference times phases with torch.cuda.synchronize() + time.time()
buckets (tests/SnapKV/selfspec_benchmark.py:153-171); here the same
wall-clock buckets, a step timer, and torch.profiler traces in the Chrome
trace format (viewable in Perfetto or TensorBoard), where the JAX package
writes jax.profiler traces.

Besides, a span recorder for the decode loops (engine/spec.py): spans
(name, start, end, parent, job, round or step index) kept in memory between
start() and stop(). Off, span() is one test of a module global and returns
a shared no-op context; on, it reads only the host clock, never a device
value, so the stream of work is the same either way. Its clock is
time.time_ns(), the Unix-epoch nanoseconds of torch.profiler's (kineto's)
event times, so spans and a trace taken alongside compare directly. One
thread records at a time.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

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


# --------------------------------------------------------------------------
# span recorder
# --------------------------------------------------------------------------

class Span(NamedTuple):
    """One recorded span; times in Unix-epoch ns (time.time_ns)."""
    name: str
    start_ns: int
    end_ns: int | None          # None: still open at stop()
    parent: int | None          # index of the enclosing span in the list
    job: int | None             # the enclosing `job` span's number
    index: int | None           # round or step index


_REC = None                     # the _Recording while on; read by every span()
_NO_SPAN = contextlib.nullcontext()


class _Recording:
    def __init__(self):
        self.spans = []         # [name, start, end, parent, job, index]
        self.open = []          # indices of the open spans, innermost last
        self.jobs = 0


class _Span:
    __slots__ = ("rec", "name", "index", "i")

    def __init__(self, rec, name, index):
        self.rec, self.name, self.index = rec, name, index

    def __enter__(self):
        rec = self.rec
        parent = rec.open[-1] if rec.open else None
        if self.name == "job":
            job, rec.jobs = rec.jobs, rec.jobs + 1
        else:
            job = None if parent is None else rec.spans[parent][4]
        self.i = len(rec.spans)
        rec.open.append(self.i)
        rec.spans.append([self.name, time.time_ns(), None, parent, job,
                          self.index])
        return self

    def __exit__(self, *exc):
        self.rec.spans[self.i][2] = time.time_ns()
        self.rec.open.remove(self.i)
        return False


def span(name: str, index: int | None = None):
    """A context that records a span `name` while the recorder is on (a
    `job` span starts a new job number, which its children carry), and the
    shared no-op context while it is off."""
    if _REC is None:
        return _NO_SPAN
    return _Span(_REC, name, index)


def start() -> None:
    """Start recording spans (nothing may be recording)."""
    global _REC
    if _REC is not None:
        raise RuntimeError("the span recorder is already on")
    _REC = _Recording()


def stop() -> list[Span]:
    """Stop recording; returns the spans in the order they started."""
    global _REC
    if _REC is None:
        raise RuntimeError("the span recorder is off")
    rec, _REC = _REC, None
    return [Span(*s) for s in rec.spans]
