"""``gather_bwd_ms_per_step.soft`` on canned traces: aten's gather backward
and the program's own kernels read alike, two calls a step add up, and the
kernel route reads nothing."""

from pathlib import Path

import pytest

from port_bench import harness, tracing
from port_bench.tracing import Op

ROOT = Path(__file__).resolve().parents[2]
NAME = "gather_bwd_ms_per_step.soft"


def steps(kernels, units=3):
    """``units`` steps of 1000 us from t = 0, each running ``kernels`` (name,
    us) one after the other from 100 us on, then an elementwise op."""
    spans, device = [], []
    for u in range(units):
        t = 1000.0 * u
        spans.append(Op("port_bench.step", t, t + 1000.0))
        for name, dur in [*kernels, ("void at::native::elementwise_kernel<128, 2>", 50.0)]:
            device.append(Op(name, t + 100.0, t + 100.0 + dur))
            t += dur
    return tracing.from_ops("step", spans, device, list(spans))


def read(trace):
    return harness.reader(ROOT, NAME)(trace)


ATEN = ("void (anonymous namespace)::indexing_backward_kernel_small_stride<float, float, "
        "float>(long const*, long const*, float const*, float*, long, long, long, long, bool)")
OWN = ("void (anonymous namespace)::select_rows_bwd_kernel<float>(float const*, long long "
       "const*, long long, int, int, float*, float*)",
       "void (anonymous namespace)::select_rows_reduce_kernel<float>(float const*, int, float*)")


def test_reads_the_parents_kernel_and_the_programs_alike():
    # two row blocks a step: two calls of aten's kernel, or two pairs of the program's
    assert read(steps([(ATEN, 120.0), (ATEN, 80.0)])) == pytest.approx(0.2)
    assert read(steps([(OWN[0], 15.0), (OWN[1], 3.0), (OWN[0], 10.0), (OWN[1], 2.0)])) \
        == pytest.approx(0.030)


def test_divides_by_the_units_not_by_the_matches():
    two = steps([(ATEN, 100.0), (ATEN, 100.0)], units=4)
    assert two.units == 4 and two.per_unit_s([r"indexing_backward_kernel"]) is None
    assert read(two) == pytest.approx(0.2)


def test_other_ops_and_the_kernel_route_read_apart():
    assert read(steps([("void render_bwd_kernel<true, false>", 40.0)])) == 0.0
    assert read(steps([("void render_fwd_kernel<0>(float*)", 100.0), (ATEN, 10.0)])) is None
