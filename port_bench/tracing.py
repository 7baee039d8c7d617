"""The traced run's reading: ``torch.profiler`` (CPU and CUDA activities)
over a slice of the window, reduced to what the per-layer metrics read.

The arithmetic is the port's ``frame_profile.py`` and ``pipeline_profile.py``
(device operations are the profiler's events on the device: kernels, copies
and fills; the device is busy where any of them runs), with the window and
the units taken from the benchmark's own spans: every frame or step of the
slice runs inside ``record_function("port_bench.<unit>")``, so the slice is
the first such span's start to the last one's end.

An idle gap is a stretch of the slice in which no device operation runs. It
is named by the innermost host operation that spans its middle: one of the
benchmark's spans (``port_bench.pose``, ``port_bench.call``,
``port_bench.sync``) or an operation of the program or of torch inside them.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

SPAN_PREFIX = "port_bench."


@dataclasses.dataclass
class Op:
    name: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    """A traced slice. ``device_ops`` and ``host_ops`` are in the slice, in
    order of start. ``least_fn(kernel)``, set by the run, maps a kernel's
    name (``"k1"``, ``"k2"``) to {unit index: the least seconds of its call
    in that unit} from the benchmark's frozen count (``roofline.py``)."""

    unit: str
    units: int
    window_start_us: float
    window_end_us: float
    device_ops: list
    host_ops: list
    least_fn: object = None
    _least: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window_end_us - self.window_start_us) * 1e-6

    def busy_intervals(self) -> list:
        """The device's busy stretches (merged op intervals) in the slice."""
        merged = []
        for op in self.device_ops:
            s, e = max(op.start_us, self.window_start_us), min(op.end_us, self.window_end_us)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def gaps(self) -> list:
        """(start_us, end_us) of every stretch of the slice with no device op."""
        out, t = [], self.window_start_us
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window_end_us > t:
            out.append((t, self.window_end_us))
        return out

    def per_unit_s(self, patterns) -> list | None:
        """Seconds a unit of the ops whose names match each pattern: the i-th
        match of every pattern belongs to unit i. None unless each pattern
        matches exactly once a unit."""
        per = [0.0] * self.units
        for pattern in patterns:
            rx = re.compile(pattern)
            hits = [op for op in self.device_ops if rx.search(op.name)]
            if len(hits) != self.units:
                return None
            for i, op in enumerate(hits):
                per[i] += op.dur_us * 1e-6
        return per

    def least_s(self, kernel: str) -> dict:
        """{unit index: least seconds} of ``kernel``'s call (computed once)."""
        if kernel not in self._least:
            self._least[kernel] = self.least_fn(self, kernel) if self.least_fn else {}
        return self._least[kernel]

    def host_at(self, t_us: float, starts: list) -> str:
        """The innermost host op whose interval holds ``t_us``; ``starts``
        are the host ops' starts."""
        i = bisect.bisect_right(starts, t_us)
        for op in reversed(self.host_ops[max(0, i - 400):i]):
            if op.end_us >= t_us:  # the latest start that holds it: the innermost
                return op.name
        return "(no host op)"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time by what the
        host was doing, each as [[name, seconds], ...]."""
        ops = collections.Counter()
        for op in self.device_ops:
            ops[op.name[:160]] += op.dur_us * 1e-6
        idle = collections.Counter()
        starts = [op.start_us for op in self.host_ops]
        for s, e in self.gaps():
            idle[self.host_at(0.5 * (s + e), starts)[:160]] += (e - s) * 1e-6
        return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}


def from_profiler(prof, unit: str) -> Trace:
    """The ``Trace`` of a profiler run whose units are the spans
    ``port_bench.<unit>``."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.events():
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a span's range on the device (a user annotation) is no operation
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
                device.append(op)
        elif e.device_type == DeviceType.CPU:
            host.append(op)
            if e.name == SPAN_PREFIX + unit:
                spans.append(op)
    return from_ops(unit, spans, device, host)


def from_ops(unit: str, spans: list, device: list, host: list) -> Trace:
    """A ``Trace`` from its unit spans and the device's and host's ops."""
    if not spans:
        raise RuntimeError(f"the trace holds no {SPAN_PREFIX}{unit} span")
    w0, w1 = min(s.start_us for s in spans), max(s.end_us for s in spans)
    inside = lambda op: op.end_us > w0 and op.start_us < w1  # noqa: E731
    return Trace(unit=unit, units=len(spans), window_start_us=w0, window_end_us=w1,
                 device_ops=sorted(filter(inside, device), key=lambda o: o.start_us),
                 host_ops=sorted(filter(inside, host), key=lambda o: o.start_us))
