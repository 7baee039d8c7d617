"""Each per-layer metric's arithmetic on a canned trace, and the trace's own."""

from pathlib import Path

import pytest

from port_bench import harness, tracing
from port_bench.tracing import Op

ROOT = Path(__file__).resolve().parents[2]


def canned(unit="frame", units=4, kernels=("void render_fwd_kernel<0>(float*)",)):
    """``units`` units of 100 us each, back to back from t = 0: in each a
    2 us copy at its start, then each kernel of ``kernels`` for 30 us, one
    after the other from 10 us on; the host's spans around them."""
    spans, device, host = [], [], []
    for u in range(units):
        t = 100.0 * u
        spans.append(Op(f"port_bench.{unit}", t, t + 100.0))
        host += [spans[-1], Op("port_bench.pose", t, t + 8.0), Op("port_bench.call", t + 8.0, t + 80.0),
                 Op("port_bench.sync", t + 80.0, t + 100.0)]
        device.append(Op("Memcpy HtoD (Pageable -> Device)", t + 1.0, t + 3.0))
        for k, name in enumerate(kernels):
            device.append(Op(name, t + 10.0 + 30.0 * k, t + 40.0 + 30.0 * k))
    tr = tracing.from_ops(unit, spans, device, host)
    tr.least_fn = lambda trace, kernel: {0: 6e-6, 2: 9e-6} if kernel in ("k1", "k2") else {}
    return tr


def read(name, trace):
    return harness.reader(ROOT, name)(trace)


def test_trace_window_busy_and_gaps():
    tr = canned()
    assert tr.units == 4 and tr.window_s == pytest.approx(400e-6)
    assert tr.busy_s == pytest.approx(4 * 32e-6)
    gaps = tr.gaps()
    assert gaps[0] == (0.0, 1.0) and gaps[1] == (3.0, 10.0) and gaps[-1] == (340.0, 400.0)
    assert sum(e - s for s, e in gaps) * 1e-6 == pytest.approx(tr.window_s - tr.busy_s)


def test_breakdown_names_ops_and_idle_time_by_host_op():
    b = canned().breakdown()
    assert b["device_ops"][0] == ["void render_fwd_kernel<0>(float*)", pytest.approx(120e-6)]
    idle = dict(b["idle_gaps"])
    # 1 us before the first copy (pose); in each unit 7 us before the kernel (pose,
    # then call: named at its middle, 6.5 us, in pose); 60 us after it, to the next
    # unit's copy (61 us; call, then sync: its middle is in call)
    assert idle["port_bench.pose"] == pytest.approx(1e-6 + 4 * 7e-6)
    assert idle["port_bench.call"] == pytest.approx(3 * 61e-6 + 60e-6)
    assert sum(idle.values()) == pytest.approx(canned().window_s - canned().busy_s)


def test_user_annotations_are_no_device_ops():
    class Event:
        def __init__(self, name, device_type, start, end, annotation=False):
            self.name, self.device_type, self.is_user_annotation = name, device_type, annotation
            self.time_range = type("R", (), {"start": start, "end": end})()

    from torch.autograd import DeviceType

    class Prof:
        def events(self):
            return [Event("port_bench.frame", DeviceType.CPU, 0, 10),
                    Event("port_bench.frame", DeviceType.CUDA, 1, 9, True),
                    Event("render_fwd_kernel", DeviceType.CUDA, 2, 5)]

    tr = tracing.from_profiler(Prof(), "frame")
    assert [op.name for op in tr.device_ops] == ["render_fwd_kernel"]


def test_idle_share():
    tr = canned()
    expected = 100.0 * (1 - (4 * 32e-6) / 400e-6)
    assert read("device_idle_share.view", tr) == pytest.approx(expected)
    assert read("device_idle_share.fit", canned("step")) == pytest.approx(expected)


def test_ops_per_unit():
    assert read("device_ops_per_frame.view", canned()) == pytest.approx(2.0)
    two = ("render_bwd_kernel<1,0>", "reduce_rows_kernel")
    assert read("device_ops_per_step.fit", canned("step", 5, two)) == pytest.approx(3.0)


def test_k1_roofline_is_the_least_time_over_the_device_time_of_the_counted_units():
    tr = canned()
    assert read("k1_roofline.view", tr) == pytest.approx(100.0 * 15e-6 / 60e-6)
    assert read("k1_roofline.fit", canned("step")) == pytest.approx(25.0)


def test_k2_roofline_adds_its_two_kernels():
    tr = canned("step", 3, ("void render_bwd_kernel<1, false>(...)", "reduce_rows_kernel(...)"))
    assert read("k2_roofline.fit", tr) == pytest.approx(100.0 * 15e-6 / 120e-6)


@pytest.mark.parametrize("name", ["k1_roofline.view", "k1_roofline.fit", "k2_roofline.fit"])
def test_a_roofline_reads_nothing_where_its_kernel_is_absent_or_uncounted(name):
    assert read(name, canned(kernels=("elementwise_kernel",))) is None
    tr = canned(kernels=("render_fwd_kernel", "render_bwd_kernel", "reduce_rows_kernel"))
    tr.least_fn = lambda trace, kernel: {}
    assert read(name, tr) is None


def test_pipeline_device_ms_reads_the_pipeline_route_only():
    tr = canned("step", 2, ("elementwise_kernel", "reduce_kernel"))
    assert read("pipeline_device_ms_per_step.soft", tr) == pytest.approx(1e3 * 62e-6)
    assert read("pipeline_device_ms_per_step.soft", canned("step")) is None
