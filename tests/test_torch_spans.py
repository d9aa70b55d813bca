"""The span recorder (utils/profiling.span, start, stop) and the spans of the
decode loops (engine/spec.py).

Off, a span is the shared no-op context and nothing is recorded; on, spans
nest with their parents, job numbers and indices, on the clock of
torch.profiler's events. On the tiny config the SnapKV and AR loops record
the spans their docstring lists, and their outputs and SpecStats do not
change with the recorder on. The `cuda` test holds the clock against the
card's trace of a synchronize.
"""

import dataclasses

import pytest
import torch

from magicdec_tpu_torch.engine.backend import Engine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                            generate_selfspec)
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.utils import profiling

B, PREFIX, GAMMA, NEW = 2, 64, 3, 12


def _record(fn):
    """fn()'s result and the spans recorded while it ran."""
    profiling.start()
    try:
        out = fn()
    finally:
        spans = profiling.stop()
    return out, spans


def _children(spans, i, name=None):
    return [s for s in spans if s.parent == i
            and (name is None or s.name == name)]


def test_off_records_nothing_and_returns_one_shared_context():
    assert profiling.span("round", 3) is profiling.span("verify")
    outer = profiling.span("job")
    with outer:
        (_, spans) = _record(lambda: None)      # nothing opened while on
    assert spans == []
    with pytest.raises(RuntimeError):
        profiling.stop()


def test_on_records_nesting_parents_jobs_and_indices():
    def work():
        with profiling.span("outside"):
            pass
        for _ in range(2):
            with profiling.span("job"):
                for r in range(2):
                    with profiling.span("round", r):
                        with profiling.span("draft.step", 0):
                            with profiling.span("forward"):
                                pass
                        with profiling.span("verify"):
                            pass

    _, spans = _record(work)
    assert [s.name for s in spans[:6]] == [
        "outside", "job", "round", "draft.step", "forward", "verify"]
    assert spans[0].parent is None and spans[0].job is None
    jobs = [i for i, s in enumerate(spans) if s.name == "job"]
    assert [spans[i].job for i in jobs] == [0, 1]
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert s.parent < i
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.job == p.job
    for j, i in enumerate(jobs):
        rounds = _children(spans, i, "round")
        assert [r.index for r in rounds] == [0, 1]
        assert all(r.job == j for r in rounds)
        for r in rounds:
            k = spans.index(r)
            step, verify = _children(spans, k)
            assert (step.name, step.index, verify.name) == (
                "draft.step", 0, "verify")
            assert [c.name for c in _children(spans, spans.index(step))] == [
                "forward"]


def test_recorder_refuses_a_second_start_and_leaves_open_spans_open():
    profiling.start()
    try:
        with pytest.raises(RuntimeError):
            profiling.start()
        ctx = profiling.span("job")
        ctx.__enter__()
    finally:
        spans = profiling.stop()
    ctx.__exit__(None, None, None)          # closes into the old recording
    assert [(s.name, s.end_ns) for s in spans] == [("job", None)]
    assert profiling.span("job") is profiling.span("x")


def test_span_contains_the_profilers_mm_event_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, spans = _record(lambda: [_mm(a) for _ in range(3)])
    mms = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(mms) == len(spans) == 3
    for (s, e), sp in zip(mms, spans):
        assert sp.start_ns <= s <= e <= sp.end_ns


def _mm(a):
    with profiling.span("mm"):
        return torch.mm(a, a)


# ---------------------------------------------------------------------------
# the decode loops on the tiny config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = ModelArgs.from_name("test-tiny")
    params = llama.init_params(cfg, scale=0.3, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (B, PREFIX),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    return cfg, params, prompt


def _run(tiny, entry):
    cfg, params, prompt = tiny
    kw = dict(batch_size=B, max_len=PREFIX + (GAMMA + 1) * (NEW + 1),
              prefill_chunk=32, device="cpu")
    if entry == "ar":
        out, stats = generate_autoregressive(Engine(cfg, params, **kw),
                                             prompt, NEW)
        return (out,), stats
    eng = Engine(cfg, params, spec=entry, draft_budget=32, window_size=8,
                 **({"sink_size": 4} if entry == "streaming" else {}), **kw)
    out, counts, stats = generate_selfspec(eng, prompt, GAMMA, NEW)
    return (out, counts), stats


def test_snapkv_loop_records_each_round(tiny):
    (_, stats), spans = _record(lambda: _run(tiny, "snapkv"))
    (job,) = [i for i, s in enumerate(spans) if s.name == "job"]
    assert spans[job].parent is None and spans[job].job == 0
    rounds = _children(spans, job, "round")
    assert stats.rounds > 1
    assert [r.index for r in rounds] == list(range(stats.rounds))
    # the read before the first round sits in the job itself
    assert len(_children(spans, job, "round_flags")) == 1
    for r in rounds:
        kids = _children(spans, spans.index(r))
        assert [k.name for k in kids] == (["draft.step"] * GAMMA + [
            "verify", "accept", "round_flags"])
        assert [k.index for k in kids[:GAMMA]] == list(range(GAMMA))
        for k in kids[:GAMMA + 1]:
            assert [c.name for c in _children(spans, spans.index(k))] == [
                "step_setup", "forward"]
    assert all(s.job == 0 for s in spans)


def test_ar_loop_records_each_step(tiny):
    (_, stats), spans = _record(lambda: _run(tiny, "ar"))
    (job,) = [i for i, s in enumerate(spans) if s.name == "job"]
    steps = _children(spans, job, "step")
    assert [s.index for s in steps] == list(range(1, NEW))
    assert len(spans) == 1 + 4 * (NEW - 1)
    for s in steps:
        assert [c.name for c in _children(spans, spans.index(s))] == [
            "step_setup", "forward", "update"]


@pytest.mark.parametrize("entry", ["snapkv", "streaming", "ar"])
def test_outputs_and_stats_do_not_change_with_the_recorder_on(tiny, entry):
    off_out, off_stats = _run(tiny, entry)
    (on_out, on_stats), spans = _record(lambda: _run(tiny, entry))
    assert spans
    for a, b in zip(off_out, on_out):
        assert torch.equal(a, b)
    off_stats.wall_time_s = on_stats.wall_time_s = 0.0
    assert dataclasses.asdict(off_stats) == dataclasses.asdict(on_stats)


@pytest.mark.cuda
def test_spans_share_the_cards_trace_clock_within_50_us():
    """A span around torch.cuda.synchronize() holds the trace's
    cudaDeviceSynchronize, and a clock read between two stream synchronizes
    lies between their runtime calls in the trace, the narrowest such
    bracket under 50 us: the clocks agree within it. (The span's own edges
    lie 60-190 us outside the call on the H100's host: the Python wrapper's
    work under the profiler, not the clock.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profiler's CUDA activity")
    import time

    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(4096, 4096, device="cuda") / 64.0
    stream = torch.cuda.current_stream()

    def busy():
        for _ in range(4):
            torch.mm(a, a)                  # keeps a synchronize waiting

    def work():
        reads = []
        for _ in range(10):
            busy()
            with profiling.span("synchronize"):
                torch.cuda.synchronize()
            busy()
            stream.synchronize()
            reads.append(time.time_ns())
            stream.synchronize()
        return reads

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work()                              # the profiler's first calls
        reads, spans = _record(work)
    calls = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in ("cudaDeviceSynchronize",
                                   "cudaStreamSynchronize"))
    assert len(spans) == len(reads) == 10
    for sp in spans:
        s, e, _ = min((c for c in calls if c[2] == "cudaDeviceSynchronize"),
                      key=lambda c: abs(c[0] - sp.start_ns))
        assert sp.start_ns <= s <= e <= sp.end_ns
    widths = []
    for t in reads:
        before = max(c[1] for c in calls if c[0] <= t)
        after = min(c[0] for c in calls if c[0] > t)
        assert before <= t <= after
        widths.append(after - before)
    assert min(widths) < 50_000, widths
