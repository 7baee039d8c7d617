"""The frozen roofline count equals the port's ``render/bounds.py`` on the
tree it was copied from, fed by the frozen plain packing and forward."""

import dataclasses
from pathlib import Path

import pytest
import torch

from port_bench import roofline
from port_bench.reference.models.loader import load_from_file as frozen_load
from port_bench.reference.ops.camera import Camera as FrozenCamera
from port_bench.reference.render import bounds as frozen_bounds
from port_bench.reference.render import packing

ROOT = Path(__file__).resolve().parents[2]
SCENES = ["dingdong", "clebsch", "reflection_test", "20spheres"]
POSE = ([0.3, -0.2, 0.1], 88.0, 3.0)


def _camera(cls):
    position, yaw, pitch = POSE
    return cls(position=torch.tensor(position), yaw_deg=torch.tensor(yaw),
               pitch_deg=torch.tensor(pitch))


def _program_work(name, polish):
    from tpu_ray_tracer_torch.models.loader import load_from_file
    from tpu_ray_tracer_torch.ops.camera import Camera
    from tpu_ray_tracer_torch.render import bounds, kernel_backend
    from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd

    scene = dataclasses.replace(load_from_file(ROOT / "scenes" / f"{name}.yml", device="cpu"),
                                width=32, height=16)
    tables, kw = kernel_backend.pack_frame(scene, _camera(Camera), 0, 16, polish_iters=polish)
    _, *aux = render_fwd(*tables, **kw, save_aux=True)
    return bounds.fwd_work(tables, kw, aux), bounds.bwd_work(tables, kw, aux)


@pytest.mark.parametrize("polish", [2, 3])
@pytest.mark.parametrize("name", SCENES)
def test_frozen_count_equals_the_ports(name, polish):
    scene = dataclasses.replace(frozen_load(ROOT / "scenes" / f"{name}.yml", device="cpu"),
                                width=32, height=16)
    tables, kw, aux = packing.fwd_aux(scene, _camera(FrozenCamera), polish_iters=polish)
    fwd, bwd = frozen_bounds.fwd_work(tables, kw, aux), frozen_bounds.bwd_work(tables, kw, aux)
    want_fwd, want_bwd = _program_work(name, polish)
    assert fwd == want_fwd and bwd == want_bwd
    assert fwd["ops"] > 0 and bwd["ops"] > 0


def test_frozen_components_equal_the_ports():
    from tpu_ray_tracer_torch.render import bounds

    assert frozen_bounds.fwd_components(3, 3, 1) == bounds.fwd_components(3, 3, 1)
    assert frozen_bounds.fwd_components(2, 3, 1) == bounds.fwd_components(2, 3, 1)
    assert frozen_bounds.bwd_components() == bounds.bwd_components()
    assert (roofline.PEAK_F32_OPS_PER_S, roofline.PEAK_BYTES_PER_S) == (
        bounds.H100_F32_OPS_PER_S, bounds.H100_BYTES_PER_S)


def test_least_time_is_the_larger_of_operations_and_bytes():
    assert roofline.least_s(67e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_s(1.0, 3.35e12 * 2) == pytest.approx(2.0)


def test_frame_work_of_a_frame():
    scene = dataclasses.replace(frozen_load(ROOT / "scenes" / "dingdong.yml", device="cpu"),
                                width=32, height=16)
    work = roofline.frame_work(scene, _camera(FrozenCamera), polish_iters=3, save_aux=False)
    tables, kw, aux = packing.fwd_aux(scene, _camera(FrozenCamera), polish_iters=3)
    fwd = frozen_bounds.fwd_work(tables, kw, aux)
    assert work["k1"] == pytest.approx(roofline.least_s(fwd["ops"], fwd["bytes"]))
    assert work["k2"] > 0
