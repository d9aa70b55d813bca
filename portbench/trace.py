"""The traced run's profiler and its reduction to device time.

One part of one job (the decode part after `encode`, or the `encode` span
itself) runs under torch.profiler with CUDA activity only: device
operations (kernels, copies, sets) and the host's CUDA runtime calls.
Recording every CPU operator as well doubled the host's time of a decode
round on the H100 and so halved the busy share it was meant to show. The
events are read from the profiler's results in memory; nothing is written
to disk.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field



@dataclass
class Trace:
    """Device operations [(name, start_ns, end_ns)] inside the traced
    window [start_ns, end_ns], and the host's CUDA runtime calls."""
    part: str                       # "decode" or "encode"
    start_ns: int
    end_ns: int
    device_ops: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)
    job: object = None              # the traced job's JobRecord

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def kernel_seconds(self, match) -> float:
        """Seconds of device operations whose name `match(name)` accepts."""
        return sum(e - s for n, s, e in self.device_ops if match(n)) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint [start_ns, end_ns) pairs."""
        out = []
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def idle_gaps(self) -> list:
        """[(start_ns, end_ns)] of the window with no device operation."""
        gaps, t = [], self.start_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.end_ns:
            gaps.append((t, self.end_ns))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the idle time summed by the host's CUDA call running at each gap's
        midpoint ("(none)": the host was in Python or in no CUDA call):
        each a list of [name, seconds], longest first."""
        by_op: dict = {}
        for n, s, e in self.device_ops:
            by_op[n] = by_op.get(n, 0) + (e - s)
        by_host: dict = {}
        gaps = self.idle_gaps()
        for name, (s, e) in zip(self.host_names_at(
                [(s + e) // 2 for s, e in gaps]), gaps):
            by_host[name] = by_host.get(name, 0) + (e - s)

        def top_of(d):
            return [[short_name(n), v * 1e-9] for n, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_host)}

    def host_names_at(self, times: list) -> list:
        """The innermost host call running at each time (times in any
        order): the one that started last among those covering it;
        "(none)" where none does."""
        ops = sorted(self.host_ops, key=lambda o: o[1])
        order = sorted(range(len(times)), key=lambda i: times[i])
        names, active, k = [None] * len(times), [], 0
        for i in order:
            t = times[i]
            while k < len(ops) and ops[k][1] <= t:
                heapq.heappush(active, (-ops[k][1], ops[k][2], ops[k][0]))
                k += 1
            while active and active[0][1] <= t:
                heapq.heappop(active)
            names[i] = active[0][2] if active else "(none)"
        return names


def short_name(name: str) -> str:
    """A kernel's name without its parameter list (C++ templates), at most
    120 characters."""
    cut = name.split("(", 1)[0] if "(" in name[1:] else name
    return cut[:120]


class Profiler:
    """torch.profiler around one traced part, CUDA activity only: start(),
    then stop(part) returns the Trace."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self, part: str) -> Trace:
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return reduce_events(events, part)


def reduce_events(events, part: str) -> Trace:
    """A Trace from kineto events (objects with name(), device_type(),
    start_ns(), duration_ns()). CUDA events are device operations (kernels,
    copies, sets); the others are the host's CUDA runtime and driver calls.
    The window runs from the first event's start to the last one's end."""
    device, host = [], []
    for e in events:
        s = e.start_ns()
        op = (e.name() or "(unnamed)", s, s + e.duration_ns())
        (device if str(e.device_type()).endswith("CUDA") else host).append(op)
    ops = device + host
    if not ops:
        return Trace(part, 0, 0)
    return Trace(part, min(o[1] for o in ops), max(o[2] for o in ops),
                 device_ops=device, host_ops=host)
