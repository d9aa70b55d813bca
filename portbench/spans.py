"""The program's spans against the traced part's device trace.

With the program's span recorder (magicdec_tpu_torch.utils.profiling:
start(), stop()) on over the whole traced job, its spans (name, start_ns,
end_ns, parent, job, index; the recorder's clock is time.time_ns(), the
Unix-epoch nanoseconds of the profiler's events) sort the trace by what the
program was doing:

- a device operation belongs to the innermost span that holds the start of
  the host runtime call that launched it (the two share a CUPTI correlation
  id; `launch_times`);
- an idle gap of the window (`Trace.idle_gaps`) belongs to the innermost
  span that holds its midpoint.

The program's spans (engine/spec.py): `job` around a generate_* call;
`round` (`round_flags`, `draft.step` x gamma, `verify`, `accept`) in SnapKV
rounds; `step` (`step_setup`, `forward`, `update`) in the AR loop; each draft
step and the verify hold a `step_setup` and a `forward`.

The readers take a trace.Trace that carries `spans` (the recorder's list)
and `launch_ns` (for each of `device_ops`, in order, its launch's start or
None) and return None where it carries neither. READERS maps each metric
name to its read(run).
"""

from __future__ import annotations

# what an idle gap's innermost span says the host was doing: the first of
# IDLE_KINDS among the span and its ancestors, else "driver" inside a job,
# else "outside" (the window's edges)
IDLE_KINDS = ("forward", "step_setup")


def launch_times(events) -> list:
    """For each CUDA event of kineto `events` (objects with device_type(),
    correlation_id(), start_ns()), in their order, which is the order
    trace.reduce_events keeps the device operations: the start of the host
    call (runtime or driver API) with the same correlation id, or None."""
    host, device = {}, []
    for e in events:
        c = e.correlation_id()
        if str(e.device_type()).endswith("CUDA"):
            device.append(c)
        elif c:
            s = e.start_ns()
            host[c] = min(s, host.get(c, s))
    return [host.get(c) if c else None for c in device]


def innermost(spans: list, times: list) -> list:
    """The index in `spans` of the innermost span holding each time (start
    <= t < end; a span never closed holds every later time), or None: the
    one that started last among those holding it. `spans` in the order they
    started, as the recorder returns them; times in any order."""
    order = sorted((i for i, t in enumerate(times) if t is not None),
                   key=times.__getitem__)
    out, stack, k = [None] * len(times), [], 0
    for i in order:
        t = times[i]
        while k < len(spans) and spans[k].start_ns <= t:
            stack.append(k)
            k += 1
        # spans nest, so every span still on the stack holds the earlier
        # ones; drop from the top those that ended, wherever they sit
        stack = [j for j in stack if spans[j].end_ns is None
                 or spans[j].end_ns > t]
        out[i] = stack[-1] if stack else None
    return out


def _path(spans: list, i):
    """The names of span i and of its ancestors, innermost first."""
    while i is not None:
        yield spans[i].name
        i = spans[i].parent


def idle_kind(spans: list, i) -> str:
    """What the host was doing in span i, as IDLE_KINDS counts it."""
    names = list(_path(spans, i))
    for n in names:
        if n in IDLE_KINDS:
            return n
    return "driver" if "job" in names else "outside"


def _traced(run):
    t = getattr(run, "trace", None)
    if (t is None or t.part != "decode" or not t.device_ops
            or getattr(t, "spans", None) is None
            or getattr(t, "launch_ns", None) is None):
        return None
    return t


def idle_seconds(trace) -> dict:
    """Idle seconds of the traced window by IDLE_KINDS, "driver" and
    "outside"."""
    gaps = trace.idle_gaps()
    where = innermost(trace.spans, [(s + e) // 2 for s, e in gaps])
    out = dict.fromkeys(IDLE_KINDS + ("driver", "outside"), 0.0)
    for (s, e), i in zip(gaps, where):
        out[idle_kind(trace.spans, i)] += (e - s) * 1e-9
    return out


def idle_share(kind: str):
    """read(run): the idle time of `kind` as % of the traced window."""
    def read(run):
        t = _traced(run)
        if t is None:
            return None
        return 100.0 * idle_seconds(t)[kind] / t.window_s
    return read


def _launched_in(trace) -> list:
    """Per device operation, the innermost span of its launch (or None)."""
    return innermost(trace.spans, trace.launch_ns)


def device_ms_per_round(name: str):
    """read(run): device ms of the operations launched under a `name`
    span, over the traced part's `round` spans."""
    def read(run):
        t = _traced(run)
        if t is None:
            return None
        rounds = sum(s.name == "round" for s in t.spans)
        if not rounds:
            return None
        under = {}
        ns = 0
        for (_, s, e), i in zip(t.device_ops, _launched_in(t)):
            if i not in under:
                under[i] = i is not None and name in _path(t.spans, i)
            if under[i]:
                ns += e - s
        return ns * 1e-6 / rounds
    return read


def launches_per_token(run):
    """Device operations launched under the traced job's spans, over the
    tokens its decode part delivered."""
    t = _traced(run)
    if t is None or t.job is None or t.job.delivered <= 0:
        return None
    n = sum(i is not None and "job" in _path(t.spans, i)
            for i in _launched_in(t))
    return n / t.job.delivered


def table(trace) -> dict:
    """Per span name (the innermost, "(none)" outside every span): idle
    seconds whose gap midpoint it holds, and device seconds and operations
    it launched: {name: [idle_s, device_s, launches]}."""
    out: dict = {}

    def row(i):
        return out.setdefault(
            "(none)" if i is None else trace.spans[i].name, [0.0, 0.0, 0])

    gaps = trace.idle_gaps()
    for (s, e), i in zip(gaps, innermost(trace.spans,
                                         [(s + e) // 2 for s, e in gaps])):
        row(i)[0] += (e - s) * 1e-9
    for (_, s, e), i in zip(trace.device_ops, _launched_in(trace)):
        r = row(i)
        r[1] += (e - s) * 1e-9
        r[2] += 1
    return out


READERS = {
    "draft_device_ms": device_ms_per_round("draft.step"),
    "verify_device_ms": device_ms_per_round("verify"),
    "idle_forward.decode": idle_share("forward"),
    "idle_step_setup.decode": idle_share("step_setup"),
    "idle_driver.decode": idle_share("driver"),
    "launches_per_token": launches_per_token,
}
