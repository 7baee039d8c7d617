"""The CUDA forward kernel against its plain PyTorch version, on the card.

This file imports nothing of JAX, so it runs on a machine with a GPU and
without JAX, from the repository root:

    python -m pytest --noconftest tests/test_torch_gpu.py

Every case skips without a CUDA device.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch.models import light as tlight
from tpu_ray_tracer_torch.models import surface as tsurface
from tpu_ray_tracer_torch.models.scene import Object
from tpu_ray_tracer_torch.parity import bad_pixel_fraction
from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd, render_fwd_plain
from tpu_ray_tracer_torch.render.kernel_backend import pack_frame, render_rows_kernel

pytestmark = pytest.mark.gpu

SCENE_DIR = pathlib.Path(__file__).resolve().parent.parent / "scenes"
SCENES = ["quadratic", "20spheres", "reflection_test", "dingdong",
          "cayley", "clebsch", "cubic", "monkey_saddle"]
POSES = [((0.0, 0.0, 0.0), 90.0, 0.0), ((0.0, 2.0, -3.0), 75.0, -12.0)]
MAX_BAD_VS_PLAIN = 1e-3  # nvcc contracts multiply-adds; the plain version rounds each op


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _scene(name, device, width=64, height=48):
    scene = ttt.load_from_file(SCENE_DIR / f"{name}.yml")
    return dataclasses.replace(scene, width=width, height=height).to(device)


def _camera(pose, device):
    pos, yaw, pitch = pose
    return ttt.Camera(position=torch.tensor(pos, dtype=torch.float32, device=device),
                      yaw_deg=torch.tensor(yaw, dtype=torch.float32, device=device),
                      pitch_deg=torch.tensor(pitch, dtype=torch.float32, device=device))


def _kernel_and_plain(tables, kw):
    before = render_fwd.launches
    out = render_fwd(*tables, **kw)
    torch.cuda.synchronize()
    assert render_fwd.launches == before + 1
    assert out.device.type == "cuda" and out.shape == (kw["rows"], kw["width"], 3)
    return out.cpu().numpy(), render_fwd_plain(*tables, **kw).cpu().numpy()


@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_plain(cuda, name):
    scene = _scene(name, cuda)
    for pose in POSES:
        out, plain = _kernel_and_plain(*pack_frame(scene, _camera(pose, cuda), 0, scene.height))
        assert np.isfinite(out).all()
        assert bad_pixel_fraction(out, plain) <= MAX_BAD_VS_PLAIN, (name, pose)


def test_rows_stitch_exactly(cuda):
    scene = _scene("reflection_test", cuda, 40, 30)
    cam = _camera(POSES[1], cuda)
    full = ttt.render_image_kernel(scene, cam)
    blocks = [render_rows_kernel(scene, cam, r0, r1 - r0)
              for r0, r1 in ((0, 7), (7, 19), (19, 30))]
    assert torch.equal(torch.cat(blocks), full)


@pytest.mark.parametrize("case", ["no_objects", "no_lights"])
def test_empty_tables(cuda, case):
    """Empty object or light tables (whose data pointers may be null) render
    as the plain version does; no objects gives the background."""
    sphere = Object(tsurface.sphere((0, 0, 8), 2.0), 0.3, np.float32([0.8, 0.2, 0.1]))
    sun = tlight.directional(2.0, (0.3, -1, 0.5), (1, 1, 1))
    objects, lights = ([], [sun]) if case == "no_objects" else ([sphere], [])
    scene = ttt.build_scene(32, 24, 40.0, objects, lights, bg_color=(0.0, 0.1, 0.2)).to(cuda)
    out, plain = _kernel_and_plain(*pack_frame(scene, _camera(POSES[0], cuda), 0, 24))
    assert bad_pixel_fraction(out, plain) == 0.0
    if case == "no_objects":
        np.testing.assert_array_equal(out, np.broadcast_to(np.float32([0, 0.1, 0.2]),
                                                           out.shape))


def test_many_lights_and_large_tables(cuda):
    """More than 32 lights (several occlusion-mask words) and tables above
    the default 48 KB of shared memory still match the plain version."""
    rng = np.random.default_rng(7)
    objects = [Object(tsurface.sphere(rng.uniform(-4, 4, 3) + [0, 0, 14], 0.6), 0.0,
                      rng.uniform(0, 1, 3).astype(np.float32)) for _ in range(40)]
    objects.append(Object(tsurface.ding_dong((0, -1, 12)), 0.2, np.float32([1, 1, 1])))
    lights = [tlight.directional(0.05, rng.uniform(-1, 1, 3) - [0, 1, 0], (1, 1, 1))
              for _ in range(300)]
    lights.append(tlight.spherical(300.0, (0, 6, 6), (1, 1, 1)))
    scene = ttt.build_scene(48, 32, 50.0, objects, lights, max_reflections=2).to(cuda)
    tables, kw = pack_frame(scene, _camera(POSES[0], cuda), 0, 32)
    assert sum(t.numel() * t.element_size() for t in tables) > 48 * 1024
    out, plain = _kernel_and_plain(tables, kw)
    assert bad_pixel_fraction(out, plain) <= 0.01
