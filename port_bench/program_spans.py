"""The program's own spans in a traced slice, as the ``program_*`` metrics
read them.

While a torch profiler runs, the port records spans named ``trt.*`` on its
host path (``tpu_ray_tracer_torch/utils/timing.py``'s ``span``):
``trt.frame`` and ``trt.step`` around a frame and a fit step, and inside
them the key, the graph's lookup, input copies, replay and output clones,
and ``trt.step.wait``, the step's loss read back (the host waiting on the
device). They lie on the profiler's clock with the device's operations.

A unit's outermost program spans are the ``trt.`` spans that start inside
its ``port_bench.<unit>`` span and lie in no other ``trt.`` span. Every
reading is None where the slice holds no ``trt.`` span (a program that
records none).
"""

from __future__ import annotations

import bisect

from . import tracing

PREFIX = "trt."
WAIT = "trt.step.wait"
# the CUDA calls (cuda* and cu*) that put work on the device
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaGraphLaunch")


def outermost(trace) -> list:
    """[(start_us, end_us)] of the units' outermost program spans, in order
    (disjoint)."""
    units = sorted((op.start_us, op.end_us) for op in trace.host_ops
                   if op.name == tracing.SPAN_PREFIX + trace.unit)
    starts = [s for s, _ in units]
    spans = sorted(((op.start_us, op.end_us) for op in trace.host_ops
                    if op.name.startswith(PREFIX)), key=lambda se: (se[0], -se[1]))
    out = []
    for s, e in spans:
        if out and s < out[-1][1]:
            continue  # inside the last outermost span
        u = bisect.bisect_right(starts, s) - 1
        if u >= 0 and s <= units[u][1]:
            out.append((s, e))
    return out


def inside(t_us: float, spans: list, starts: list) -> bool:
    """Whether ``t_us`` lies in one of the disjoint, ordered ``spans``."""
    i = bisect.bisect_right(starts, t_us) - 1
    return i >= 0 and t_us <= spans[i][1]


def host_us(trace) -> float | None:
    """Microseconds a unit that the host spends inside the outermost
    program spans, less the ``trt.step.wait`` spans inside them."""
    spans = outermost(trace)
    if not spans or not trace.units:
        return None
    starts = [s for s, _ in spans]
    waits = sum(op.dur_us for op in trace.host_ops
                if op.name == WAIT and inside(op.start_us, spans, starts))
    return (sum(e - s for s, e in spans) - waits) / trace.units


def idle_share(trace) -> float | None:
    """The share of the slice, in %, in which no device operation runs
    while the host is inside an outermost program span."""
    spans = outermost(trace)
    if not spans or trace.window_s <= 0:
        return None
    idle, i = 0.0, 0
    for gs, ge in trace.gaps():
        while i < len(spans) and spans[i][1] <= gs:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < ge:
            idle += min(ge, spans[j][1]) - max(gs, spans[j][0])
            j += 1
    return 100.0 * idle * 1e-6 / trace.window_s


def launches(trace) -> float | None:
    """The calls a unit that put work on the device (``LAUNCHES``: kernel
    launches, asynchronous copies and fills, graph launches), made inside
    the outermost program spans."""
    spans = outermost(trace)
    if not spans or not trace.units:
        return None
    starts = [s for s, _ in spans]
    return sum(op.name.startswith(LAUNCHES) and inside(op.start_us, spans, starts)
               for op in trace.host_ops) / trace.units
