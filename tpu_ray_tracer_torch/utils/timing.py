"""Frame timing and throughput metering.

Counterpart of ``tpu_ray_tracer/utils/timing.py``.

Reproduces the reference's observability surface: per-frame render time and
a once-per-second ``FPS: %.4lf, last render time: %.4f ms`` stdout line
(reference: src/ray-tracer.cpp:236-242), extended with a Mrays/s counter
(the benchmark metric, BASELINE.md).

``span(name)`` names a stretch of the port's host path (``trt.frame``,
``trt.graph.replay``, ...) on a running ``torch.profiler``'s timeline, where
the device's kernels and copies lie too; with no profiler running it costs a
call and one test. ``events_by_name`` sums a profiler's events by name.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import DeviceType

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    torch profiler runs, else a shared no-op context. A span adds no device
    work, so a CUDA graph captured inside one is the same graph."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def events_by_name(prof, device_type=DeviceType.CUDA) -> dict:
    """{name: [count, us]} of the events on ``device_type`` that a finished
    ``torch.profiler.profile`` recorded: by default the device's operations
    (kernels, copies and fills) and their device time."""
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == device_type:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    return dict(by_name)


class FrameTimer:
    """Aggregates frame times; emits the reference's FPS line once per second."""

    def __init__(self, print_fn=print, interval_s: float = 1.0):
        self._print = print_fn
        self._interval = interval_s
        self._frames = 0
        self._start = time.perf_counter()
        self.last_render_ms = 0.0

    def frame(self, render_ms: float) -> None:
        self._frames += 1
        self.last_render_ms = render_ms
        elapsed = time.perf_counter() - self._start
        if elapsed >= self._interval:
            fps = self._frames / elapsed
            # exact format of reference ray-tracer.cpp:239
            self._print(f"FPS: {fps:.4f}, last render time: {render_ms:.4f} ms")
            self._frames = 0
            self._start = time.perf_counter()


def mrays_per_s(n_pixels: int, seconds: float) -> float:
    """Primary rays per second in millions (BASELINE.md derived metric)."""
    return n_pixels / seconds / 1e6 if seconds > 0 else 0.0
