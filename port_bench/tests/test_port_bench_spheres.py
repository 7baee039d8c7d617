"""``20spheres.fit`` on the CPU at a small size: a sound run is ``correct``,
a run broken underneath and the control are not, under the cell's own
limits; and ``k2_reduce_us_per_step`` reads K2's cross-block sum alone."""

from pathlib import Path

import pytest
import torch

from port_bench import harness, run, tracing
from port_bench.drivers.fit import gaps
from port_bench.tests.test_port_bench_faults import (SEED, half_the_batch, loss_altered,
                                                     state_unchanged)
from port_bench.tracing import Op

ROOT = Path(__file__).resolve().parents[2]
NAME = "20spheres.fit"
SIZE = (40, 30)


def cell():
    c = harness.resolve(ROOT, NAME)
    c.size = SIZE
    return c


def test_the_cell_is_the_upstream_scene_at_its_own_size():
    c = harness.resolve(ROOT, NAME)
    assert (c.setting["width"], c.setting["height"]) == (800, 600) and not c.config["reduced"]
    assert c.scene_path.read_text() == (ROOT / "scenes" / "20spheres.yml").read_text()
    assert c.mix["driver"] == "fit" and c.mix["backend"] == "kernel"
    assert c.setting["fit_fields"] == ["colors", "light_color"]


def test_sound_run_is_correct():
    out = run.run_cell(cell(), SEED, 0.2, False, torch.device("cpu"))
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, loss_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run.run_cell(cell(), SEED, 0.2, False, torch.device("cpu"))
    assert not out["correct"], out["compared"]


def test_control_is_not_correct():
    c = cell()
    drv = harness.driver(c).Driver(c, SEED, torch.device("cpu"))
    drv.free()
    got = gaps(drv.follow(reference=c.setting["control"]), drv.follow())
    assert any(got[k] > c.limits[k] for k in got), got


REDUCE = "void (anonymous namespace)::reduce_rows_kernel<float>(float const*, int, int, float*)"
BWD = "void (anonymous namespace)::render_bwd_kernel<true, false, float>(float const*)"


def steps(kernels, units=3):
    """``units`` steps of 1000 us, each running ``kernels`` (name, us) in turn."""
    spans, device = [], []
    for u in range(units):
        t = 1000.0 * u
        spans.append(Op("port_bench.step", t, t + 1000.0))
        for name, dur in kernels:
            device.append(Op(name, t + 100.0, t + 100.0 + dur))
            t += dur
    return tracing.from_ops("step", spans, device, list(spans))


def read(trace):
    return harness.reader(ROOT, "k2_reduce_us_per_step.spheres")(trace)


def test_reduce_reader_reads_the_cross_block_sum_alone():
    assert read(steps([(BWD, 90.0), (REDUCE, 2.5)])) == pytest.approx(2.5)
    assert read(steps([(BWD, 90.0), (REDUCE, 2.0), (REDUCE, 1.0)], units=4)) == pytest.approx(3.0)


def test_reduce_reader_is_silent_without_the_kernel():
    assert read(steps([(BWD, 90.0)])) is None
    assert read(steps([("void at::native::elementwise_kernel<128, 2>", 50.0)])) is None
