"""The terminal viewer's frame function, ``utils/term_view.view_frame``,
against the per-frame closure that ``cli.py view`` ran before it (the pose
taken to a tuple, rendered, read back, then ``downsample_for_view``): the
same array on every backend, shrinking and growing; and ``cmd_view`` calls
it."""

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from tpu_ray_tracer_torch import cli, load_from_file
from tpu_ray_tracer_torch.utils import term_view
from tpu_ray_tracer_torch.utils.flycam import FlyCamera

SCENE = Path(__file__).resolve().parents[1] / "scenes" / "dingdong.yml"


def camera():
    cam = FlyCamera()
    cam.move("w", 0.3)
    cam.mouse_move(12.0, -5.0)
    return cam.to_camera(device="cpu")


def old_closure(scene, backend, view_w, view_h):
    render = cli._renderer(scene, backend)

    def render_fn(camera):
        pose = (*camera.position.tolist(), float(camera.yaw_deg), float(camera.pitch_deg))
        return term_view.downsample_for_view(render(pose), view_w, view_h)
    return render_fn


@pytest.mark.parametrize("size,view", [((48, 24), (24, 12)), ((40, 30), (120, 72))],
                         ids=["area_mean", "nearest"])
@pytest.mark.parametrize("backend", ["kernel", "torch", "numpy"])
def test_view_frame_equals_the_old_closure(backend, size, view):
    scene = dataclasses.replace(load_from_file(SCENE, device="cpu"), width=size[0],
                                height=size[1])
    cam = camera()
    got = term_view.view_frame(cli._frame_render(backend), scene, cam, *view)
    want = old_closure(scene, backend, *view)(cam)
    assert isinstance(got, np.ndarray) and got.shape == (view[1], view[0], 3)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cmd_view_delivers_through_view_frame(monkeypatch):
    calls, shown = [], []
    sound = term_view.view_frame

    def counted(*args):
        calls.append(args[3:])
        return sound(*args)

    def viewer(render_fn, width, height, print_fn=None, device="cuda"):
        shown.append(render_fn(camera()))

    monkeypatch.setattr(term_view, "view_frame", counted)
    monkeypatch.setattr(term_view, "run_viewer", viewer)
    args = argparse.Namespace(scene=str(SCENE), device="cpu", render_size=(40, 30),
                              size=None, backend="kernel")
    assert cli.cmd_view(args) == 0
    assert calls == [(120, 72)] and shown[0].shape == (72, 120, 3)
