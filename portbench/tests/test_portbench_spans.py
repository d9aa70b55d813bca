"""portbench/spans.py: the program's spans against a device trace.

A synthetic traced part (kineto-like events with correlation ids, and the
recorder's spans: a job, one round of one draft step, a verify, an accept
and a flags read) holds an idle gap inside each kind of span and one
outside the job. The `cuda` test records a tiny SnapKV job on the card and
reads it the same way.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

from collections import namedtuple

import pytest

from portbench import spans as sp
from portbench.metrics import reader
from portbench.record import JobRecord, Run
from portbench.trace import reduce_events

# the recorder's record (magicdec_tpu_torch.utils.profiling.Span)
Span = namedtuple("Span", "name start_ns end_ns parent job index")

SPANS = [Span("job", 10, 990, None, 0, None),            # 0
         Span("round", 20, 980, 0, 0, 0),                # 1
         Span("draft.step", 30, 300, 1, 0, 0),           # 2
         Span("step_setup", 30, 80, 2, 0, None),         # 3
         Span("forward", 80, 280, 2, 0, None),           # 4
         Span("verify", 300, 700, 1, 0, None),           # 5
         Span("step_setup", 300, 350, 5, 0, None),       # 6
         Span("forward", 350, 690, 5, 0, None),          # 7
         Span("accept", 700, 800, 1, 0, None),           # 8
         Span("round_flags", 800, 970, 1, 0, None)]      # 9


class _Event:
    def __init__(self, name, device, start, duration, corr):
        self._n, self._d, self._s, self._u, self._c = (name, device, start,
                                                       duration, corr)

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c


# (launching host call at, device op [start, end), correlation id); None: no
# host call carries the id
LAUNCHES = [(None, "pre", 8, 9, 10),         # before the job: no launch
            (40, "rope", 100, 150, 1),       # draft step_setup
            (100, "gemm", 150, 250, 2),      # draft forward
            (320, "rope", 330, 340, 3),      # verify step_setup
            (400, "gemm", 420, 600, 4),      # verify forward
            (710, "cumprod", 720, 740, 5),   # accept
            (810, "Memcpy DtoH", 850, 860, 6),   # round_flags
            (None, "orphan", 880, 900, 7)]


def _events():
    ev = [_Event("cudaStreamIsCapturing", "CPU", 0, 5, 0),
          _Event("cudaDeviceSynchronize", "CPU", 960, 40, 9)]
    for at, name, s, e, corr in LAUNCHES:
        if at is not None:
            ev.append(_Event("cudaLaunchKernel", "CPU", at, 3, corr))
        ev.append(_Event(name, "CUDA", s, e - s, corr))
    return ev


def _job(**kw):
    base = dict(entry="selfspec", batch=2, prompt_len=256, new_tokens=4,
                chunk=128, gamma=1, budget=64, job_s=3.0, encode_s=1.0,
                counts=[3, 3])
    base.update(kw)
    return JobRecord(**base)


class _Cell:
    pass


def _run(with_spans=True):
    events = _events()
    t = reduce_events(events, "decode")
    t.job = _job()
    if with_spans:
        t.spans, t.launch_ns = SPANS, sp.launch_times(events)
    return Run(cell=_Cell(), jobs=[t.job], trace=t)


def test_launch_times_follow_correlation_ids_in_device_order():
    got = sp.launch_times(_events())
    assert got == [at for at, *_ in LAUNCHES]
    assert len(got) == len(reduce_events(_events(), "decode").device_ops)


def test_innermost_spans():
    assert sp.innermost(SPANS, [5, 50, 290, 380, 795, 870, 985, 995, None,
                                80]) == [None, 3, 2, 7, 8, 9, 0, None, None, 4]
    open_ = [Span("job", 10, None, None, 0, None),
             Span("round", 20, 30, 0, 0, 0)]
    assert sp.innermost(open_, [25, 30, 10**9]) == [1, 0, 0]


def test_window_and_gaps_hold_each_kind_of_span():
    t = _run().trace
    assert (t.start_ns, t.end_ns) == (0, 1000)
    assert t.idle_gaps() == [(0, 8), (9, 100), (250, 330), (340, 420),
                             (600, 720), (740, 850), (860, 880), (900, 1000)]
    got = sp.idle_seconds(t)
    want = {"forward": 80 + 120, "step_setup": 91,
            "driver": 80 + 110 + 20 + 100, "outside": 8}
    assert got == {k: pytest.approx(v * 1e-9) for k, v in want.items()}


def test_idle_readers_sum_to_device_idle_less_the_outside_part():
    run = _run()
    r = sp.READERS
    shares = [r["idle_forward.decode"](run), r["idle_step_setup.decode"](run),
              r["idle_driver.decode"](run)]
    assert shares == [pytest.approx(20.0), pytest.approx(9.1),
                      pytest.approx(31.0)]
    assert sum(shares) == pytest.approx(
        reader("device_idle.decode")(run) - 0.8)


def test_phase_device_ms_per_round_and_launches_per_token():
    run = _run()
    assert sp.READERS["draft_device_ms"](run) == pytest.approx(150e-6)
    assert sp.READERS["verify_device_ms"](run) == pytest.approx(190e-6)
    # six operations launched in the job; (3 - 1) + (3 - 1) tokens
    assert sp.READERS["launches_per_token"](run) == pytest.approx(6 / 4)


def test_table_by_innermost_span():
    tab = sp.table(_run().trace)
    assert tab["forward"] == [pytest.approx(200e-9), pytest.approx(280e-9), 2]
    assert tab["step_setup"] == [pytest.approx(91e-9), pytest.approx(60e-9),
                                 2]
    assert tab["(none)"] == [pytest.approx(8e-9), pytest.approx(21e-9), 2]
    assert sum(r[2] for r in tab.values()) == len(LAUNCHES)


def test_new_readers_find_nothing_without_spans():
    run = _run(with_spans=False)
    assert all(read(run) is None for read in sp.READERS.values())
    run.trace = None
    assert all(read(run) is None for read in sp.READERS.values())


@pytest.mark.parametrize("name", ["device_idle.decode", "device_idle.ar",
                                  "device_idle.prefill"])
def test_existing_readers_and_breakdown_read_the_same_with_spans(name):
    plain, spanned = _run(with_spans=False), _run()
    assert reader(name)(spanned) == reader(name)(plain)
    assert spanned.trace.breakdown() == plain.trace.breakdown()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_a_tiny_snapkv_job_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from magicdec_tpu_torch.utils import profiling
    from portbench import layout, run, weights

    data = Path(__file__).resolve().parent / "data"
    dev = torch.device("cuda", 0)
    cell = layout.load_cell("tiny-mistral.snapkv", data / "BENCHMARK.json",
                            data)
    tr = cell.traffic
    params = weights.make(cell.sizes, 7, dev, torch.bfloat16)
    jobs = run.Jobs(cell, params, 7, dev)
    engine = jobs.engine(tr["prompt_len"], tr["new_tokens"])
    jobs.run(engine, "warm", tr["prompt_len"], tr["new_tokens"])

    class Part:     # run.Jobs.run's hooks: the profiler after encode
        def __init__(self):
            self.prof = profile(activities=[ProfilerActivity.CUDA])

        def before_encode(self):
            pass

        def after_encode(self):
            self.prof.start()

    part = Part()
    profiling.start()
    try:
        rec = jobs.run(engine, "trace", tr["prompt_len"], 8, part)
    finally:
        recorded = profiling.stop()
    part.prof.stop()
    events = part.prof.profiler.kineto_results.events()
    t = reduce_events(events, "decode")
    t.job, t.spans, t.launch_ns = rec, recorded, sp.launch_times(events)
    r = Run(cell=cell, jobs=[rec], trace=t)

    rounds = sum(s.name == "round" for s in recorded)
    assert rounds == rec.rounds > 0
    # every operation launched in the traced window found its launch
    assert all(x is not None for x in t.launch_ns)
    assert sp.READERS["draft_device_ms"](r) > 0
    assert sp.READERS["verify_device_ms"](r) > 0
    assert sp.READERS["launches_per_token"](r) > 0
    shares = [sp.READERS[n](r) for n in ("idle_forward.decode",
                                         "idle_step_setup.decode",
                                         "idle_driver.decode")]
    outside = 100 * sp.idle_seconds(t)["outside"] / t.window_s
    assert sum(shares) + outside == pytest.approx(
        reader("device_idle.decode")(r))
