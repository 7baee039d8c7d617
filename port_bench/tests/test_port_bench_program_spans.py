"""The ``program_*`` metrics, which read the program's ``trt.`` spans
(``port_bench/program_spans.py``): on a canned slice, on a slice without
them, and on a CPU profiler run of the program's graphed frame."""

import dataclasses
from pathlib import Path

import pytest
import torch

from port_bench import harness, tracing
from port_bench.tracing import Op

ROOT = Path(__file__).resolve().parents[2]
METRICS = ("program_host_us", "program_idle_share", "program_launches")


def canned(units=2, spans=True):
    """``units`` fit steps of 100 us, back to back from t = 0. In each, the
    program's ``trt.step`` from 5 to 95 us holds its key (5-20), the input
    copy (20-25, one ``cudaMemcpyAsync``), the replay (25-40, one
    ``cudaGraphLaunch``) and the wait (40-90, a synchronize); a kernel
    launch at 96-98 lies outside it. The device runs from 30 to 85 us."""
    unit, device, host = [], [], []
    for u in range(units):
        t = 100.0 * u
        unit.append(Op("port_bench.step", t, t + 100.0))
        host += [unit[-1], Op("cudaMemcpyAsync", t + 21, t + 23),
                 Op("cudaGraphLaunch", t + 27, t + 37), Op("cudaStreamSynchronize", t + 41, t + 89),
                 Op("cudaLaunchKernel", t + 96, t + 98)]
        if spans:
            host += [Op("trt.step", t + 5, t + 95), Op("trt.step.key", t + 5, t + 20),
                     Op("trt.graph.load", t + 20, t + 25), Op("trt.graph.replay", t + 25, t + 40),
                     Op("trt.step.wait", t + 40, t + 90)]
        device.append(Op("render_fwd_kernel", t + 30, t + 85))
    return tracing.from_ops("step", unit, device, host)


def read(name, trace):
    return harness.reader(ROOT, name)(trace)


def test_the_readings_of_a_canned_slice():
    """Host time: the step's 90 us less its 50 us wait. Idle under the
    program: 5-30 and 85-95 us of each 100 (35%). Launches: the copy and the
    graph launch, not the launch outside the program's span."""
    tr = canned()
    assert read("program_host_us.fit", tr) == pytest.approx(40.0)
    assert read("program_idle_share.fit", tr) == pytest.approx(35.0)
    assert read("program_launches.fit", tr) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", METRICS)
def test_no_program_span_reads_none(metric):
    assert read(f"{metric}.view", canned(spans=False)) is None


class Replays:
    """``graphs.CudaGraphs`` on the CPU: a capture keeps the function, and a
    replay runs it again into the captured outputs."""

    @staticmethod
    def grown(device, fn):
        return fn(), 0

    @staticmethod
    def warmup(device, fn):
        return fn()

    @staticmethod
    def capture(device, fn, pool=None):
        out = fn()
        return (fn, out), out, 0

    @staticmethod
    def replay(graph):
        from tpu_ray_tracer_torch.render import graphs

        fn, out = graph
        with graphs.eager():
            new = fn()
        for static, value in zip(graphs._tensors(out), graphs._tensors(new)):
            static.copy_(value)


def test_a_profiled_cpu_frame_reads_all_three(monkeypatch):
    """Three graphed frames of the program (a warm-up, a capture and
    replay, a replay) on the CPU, each inside ``port_bench.frame`` under
    ``torch.profiler``: every metric reads a number (no launch: no CUDA)."""
    import tpu_ray_tracer_torch as ttt
    from tpu_ray_tracer_torch.render import graphs, kernel_backend

    monkeypatch.setattr(graphs, "BACKEND", Replays())
    monkeypatch.setattr(graphs, "active", lambda device: not graphs._STATE.__dict__.get(
        "eager", False))
    kernel_backend._FRAMES.clear()
    scene = dataclasses.replace(ttt.load_from_file(ROOT / "scenes" / "dingdong.yml",
                                                   device="cpu"), width=16, height=12)
    cameras = [ttt.Camera(position=torch.zeros(3), yaw_deg=torch.tensor(90.0 + k),
                          pitch_deg=torch.tensor(0.0)) for k in range(3)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for camera in cameras:
            with torch.profiler.record_function("port_bench.frame"), torch.no_grad():
                kernel_backend.render_image_kernel(scene, camera)
    kernel_backend._FRAMES.clear()
    tr = tracing.from_profiler(prof, "frame")
    assert tr.units == 3
    assert read("program_host_us.view", tr) > 0
    assert 0 < read("program_idle_share.view", tr) <= 100
    assert read("program_launches.view", tr) == 0
