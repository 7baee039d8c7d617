"""The port's command line and utilities (``cli.py``, ``utils/``) against the
JAX package's: the cases of tests/test_cli.py (``fit`` with the port's
backend names: ``torch`` for ``jax``/``xla``, ``kernel`` for ``pallas``),
tests/test_guard.py, tests/test_flycam.py and tests/test_term_view.py, each
with ``--device cpu`` (the card is the default); and the PNG that
``render --backend numpy`` writes, byte for byte the JAX CLI's."""

import dataclasses
import math
import os
import re

import numpy as np
import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.cli import main as jax_main
from tpu_ray_tracer_torch.cli import main
from tpu_ray_tracer_torch.utils.film import flip_vertical, to_uint8
from tpu_ray_tracer_torch.utils.flycam import FlyCamera
from tpu_ray_tracer_torch.utils.guard import (RenderCheckError, check_image, checked,
                                              find_nonfinite)
from tpu_ray_tracer_torch.utils.term_view import downsample_for_view, frame_to_ansi

from conftest import scene_path

CPU = ["--device", "cpu"]
FPS_LINE = re.compile(r"^FPS: \d+\.\d{4}, last render time: \d+\.\d{4} ms$", re.M)


def test_render_numpy_backend(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    rc = main(["render", scene_path("quadratic"), "--backend", "numpy",
               "--size", "32", "24", "-o", out, *CPU])
    assert rc == 0
    assert open(out, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "Wrote" in capsys.readouterr().out


@pytest.mark.parametrize("pose", [None, ["0", "2", "-3", "75", "-12"]])
def test_render_numpy_png_equals_jax_cli(tmp_path, pose):
    """Same arguments, same bytes: the oracle's image is the JAX package's
    bit for bit, and write_png encodes it alike."""
    args = ["render", scene_path("dingdong"), "--backend", "numpy", "--size", "40", "30"]
    if pose:
        args += ["--pose", *pose]
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    assert main([*args, "-o", str(ours), *CPU]) == 0
    assert jax_main([*args, "-o", str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()


def test_render_torch_backend_npy(tmp_path):
    """auto renders through the plain pipeline."""
    out = str(tmp_path / "img.npy")
    rc = main(["render", scene_path("quadratic"), "--size", "32", "24", "-o", out, *CPU])
    assert rc == 0
    img = np.load(out)
    assert img.shape == (24, 32, 3) and img.dtype == np.float32
    assert np.isfinite(img).all()


def test_render_kernel_backend(tmp_path, monkeypatch):
    """--backend kernel goes through render_image_kernel (its plain version
    on the CPU), once; the CLI takes the entry from the package at call
    time."""
    calls = []
    orig = ttt.render_image_kernel

    def spy(*args, **kw):
        calls.append(args[0].width)
        return orig(*args, **kw)

    monkeypatch.setattr(ttt, "render_image_kernel", spy)
    out = str(tmp_path / "img.npy")
    rc = main(["render", scene_path("dingdong"), "--backend", "kernel", "--size", "32", "24",
               "--check", "-o", out, *CPU])
    assert rc == 0 and calls == [32]
    assert np.load(out).shape == (24, 32, 3)


def test_render_missing_scene(capsys):
    rc = main(["render", "/nonexistent/scene.yml", *CPU])
    assert rc == 1
    err = capsys.readouterr().err
    # reference error surface (src/ray-tracer.cpp:151-158)
    assert "Error during scene loading" in err
    assert "Cannot read the file" in err


def test_render_invalid_scene(tmp_path, capsys):
    path = tmp_path / "bad.yml"
    path.write_text("width: 5\nheight: 5\nobjects: []\nlight_sources: []\n")
    rc = main(["render", str(path), *CPU])
    assert rc == 1
    assert "Value 'fov' undefined" in capsys.readouterr().err


def test_default_device_is_the_card(tmp_path):
    """Without --device the scene goes to the card, and without a card the
    command raises rather than rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["render", scene_path("quadratic"), "-o", str(tmp_path / "x.png")])


def test_animate_writes_frames(tmp_path):
    prefix = str(tmp_path / "fr_")
    rc = main(["animate", scene_path("quadratic"), "--backend", "numpy",
               "--size", "24", "16", "--frames", "2", "--prefix", prefix, *CPU])
    assert rc == 0
    assert os.path.exists(prefix + "0000.png")
    assert os.path.exists(prefix + "0001.png")


def test_fit_self_recovery(capsys):
    rc = main(["fit", scene_path("cayley"), "--size", "24", "16", "--steps", "8", "--lr", "0.05",
               *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    losses = re.search(r"^loss: (\S+) -> (\S+) over 8 steps$", out, re.M)
    assert losses and float(losses[2]) < float(losses[1]), out


def test_fit_kernel_backend_reachable(capsys):
    """--backend kernel reaches the forward and backward kernels' entries
    (their plain versions on the CPU)."""
    rc = main(["fit", scene_path("quadratic"), "--size", "16", "12", "--steps", "2",
               "--backend", "kernel", *CPU])
    assert rc == 0
    assert "loss:" in capsys.readouterr().out


def test_fit_backend_wiring(monkeypatch):
    """auto on the CPU -> torch; an explicit kernel passes through, also with
    a soft loss (the explicit choice is honoured; the loss then takes the
    pipeline)."""
    from tpu_ray_tracer_torch.diff import inverse as inv

    captured = {}
    real_problem = inv.InverseProblem

    def spy(**kwargs):
        captured["backend"] = kwargs.get("backend")
        return real_problem(**kwargs)

    monkeypatch.setattr(inv, "InverseProblem", spy)
    args = ["fit", scene_path("quadratic"), "--size", "12", "8", "--steps", "1", *CPU]
    main([*args, "--backend", "kernel"])
    assert captured["backend"] == "kernel"
    main(args)
    assert captured["backend"] == "torch"  # auto on the CPU
    main([*args, "--backend", "kernel", "--soft-tau", "0.2", "--params", "coefs"])
    assert captured["backend"] == "kernel"


def test_fit_rejects_numpy_backend(capsys):
    rc = main(["fit", scene_path("quadratic"), "--size", "12", "8", "--steps", "1",
               "--backend", "numpy", *CPU])
    assert rc == 2
    assert "not differentiable" in capsys.readouterr().err


def test_fit_distributed_world_of_one(capsys, monkeypatch):
    """``--distributed`` outside torchrun (no ``WORLD_SIZE``) is a world of
    one rank: it runs and prints what the fit without it prints (two gloo
    ranks: tests/test_torch_multihost.py)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = ["fit", scene_path("quadratic"), "--size", "16", "12", "--steps", "2", *CPU]
    assert main([*args, "--distributed"]) == 0
    distributed = capsys.readouterr().out
    assert main(args) == 0
    assert distributed == capsys.readouterr().out
    assert re.search(r"^loss: \S+ -> \S+ over 2 steps$", distributed, re.M)


def test_fit_camera_and_checkpoint_resume(tmp_path, capsys):
    """--params camera prints the recovered pose beside the truth; a run
    with --checkpoint resumes where the last one saved."""
    ck = str(tmp_path / "ck.npz")
    args = ["fit", scene_path("quadratic"), "--size", "16", "12", "--params", "camera",
            "--pose", "0", "-25", "0", "90", "0", "--checkpoint", ck, "--checkpoint-every", "2",
            *CPU]
    assert main([*args, "--steps", "2"]) == 0
    assert "recovered pose: position (" in capsys.readouterr().out
    assert main([*args, "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {ck} at step 2" in out and "over 1 steps" in out
    assert "self-recovery truth: (0, -25, 0), 90, 0" in out


@pytest.mark.parametrize("backend", ["auto", "torch", "kernel"])
def test_bench_reports_frames(capsys, backend):
    """auto resolves to the pipeline on the CPU; each backend prints the
    reference's FPS line and a line naming the backend and its clock."""
    rc = main(["bench", scene_path("quadratic"), "--size", "32", "24",
               "--frames", "2", "--backend", backend, *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert FPS_LINE.search(out), out
    want = "torch" if backend == "auto" else backend
    assert f"backend {want} on cpu" in out
    assert "(host clock)" in out and "Mrays/s" in out


def test_bench_numpy_backend(capsys):
    rc = main(["bench", scene_path("quadratic"), "--size", "24", "16",
               "--frames", "2", "--backend", "numpy", *CPU])
    assert rc == 0
    assert "backend numpy" in capsys.readouterr().out


def test_bench_profile_writes_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = main(["bench", scene_path("quadratic"), "--size", "16", "12", "--frames", "1",
               "--profile", str(prof), *CPU])
    assert rc == 0
    assert (prof / "trace.json").stat().st_size > 0
    assert "profiler trace written to" in capsys.readouterr().out


def test_view_resolution_independent_of_view_size(capsys, monkeypatch):
    # reference: render at scene resolution regardless of window size
    # (src/ray-tracer.cpp:160-169, 209-214); --size only scales the display
    from tpu_ray_tracer_torch.render import reference_cpu

    seen = {}
    real = reference_cpu.render_image_np

    def spy(scene, **kwargs):
        seen["render_wh"] = (scene.width, scene.height)
        return real(scene, **kwargs)

    monkeypatch.setattr(reference_cpu, "render_image_np", spy)
    rc = main(["view", scene_path("quadratic"), "--backend", "numpy",
               "--size", "20", "10", "--render-size", "32", "24", *CPU])
    assert rc == 0
    assert seen["render_wh"] == (32, 24)  # NOT the 20x10 view size
    out = capsys.readouterr().out
    # non-TTY fallback prints one ANSI frame at the VIEW cell size
    assert out.count("\n") == 10 // 2  # half-block rows


def test_downsample_for_view():
    img = np.arange(24 * 32 * 3, dtype=np.float32).reshape(24, 32, 3) / 2304
    out = downsample_for_view(img, 16, 12)  # integer 2x2 boxes -> area mean
    assert out.shape == (12, 16, 3)
    assert np.allclose(out[0, 0], img[:2, :2].mean(axis=(0, 1)))
    out2 = downsample_for_view(img, 13, 7)  # non-integer -> nearest
    assert out2.shape == (7, 13, 3)
    assert downsample_for_view(img, 32, 24) is img


# --- utils/guard.py (tests/test_guard.py) ---

def test_find_nonfinite_indices():
    img = np.zeros((4, 5, 3), np.float32)
    img[1, 2, 0] = np.nan
    img[3, 0, 2] = np.inf
    assert find_nonfinite(img) == [(1, 2), (3, 0)]
    assert find_nonfinite(np.ones((2, 2, 3))) == []


def test_check_image_raises_with_indices():
    img = np.zeros((4, 5, 3), np.float32)
    img[2, 3] = np.nan
    with pytest.raises(RenderCheckError, match=r"\(2,3\)"):
        check_image(img, context="scene.yml")
    ok = np.ones((2, 2, 3), np.float32)
    assert check_image(ok) is ok


def test_checked_render_passes_on_real_scene():
    scene = dataclasses.replace(ttt.load_from_file(scene_path("quadratic"), device="cpu"),
                                width=32, height=16)
    config = ttt.RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)
    img = checked(lambda s: ttt.render_image(s, None, config))(scene)
    assert torch.isfinite(img).all()


def test_checked_raises():
    bad = checked(lambda x: x / x)  # 0/0 -> NaN
    with pytest.raises(RenderCheckError, match="non-finite"):
        bad(torch.zeros((2, 2, 3)))
    out = checked(lambda x: x + 1.0)(torch.ones((2, 2, 3)))
    assert float(out.min()) == 2.0


def test_cli_render_check_flag(tmp_path):
    out = tmp_path / "img.png"
    rc = main(["render", scene_path("quadratic"), "--size", "32", "16",
               "--check", "-o", str(out), *CPU])
    assert rc == 0
    assert out.exists()


# --- utils/flycam.py (tests/test_flycam.py) ---

def test_flycam_initial_state_matches_reference():
    cam = FlyCamera()
    np.testing.assert_allclose(cam.position, 0.0)
    assert cam.yaw_deg == 90.0 and cam.pitch_deg == 0.0
    np.testing.assert_allclose(cam.direction, [0, 0, 1], atol=1e-15)
    np.testing.assert_allclose(cam.movement_front, [0, 0, 1], atol=1e-15)
    np.testing.assert_allclose(cam.camera_right, [1, 0, 0], atol=1e-15)


def test_flycam_mouse_look_decreases_and_clamps():
    cam = FlyCamera()
    cam.mouse_move(10.0, 5.0)
    assert cam.yaw_deg == pytest.approx(89.0)
    assert cam.pitch_deg == pytest.approx(-0.5)
    cam.mouse_move(0.0, -10000.0)
    assert cam.pitch_deg == 89.0
    cam.mouse_move(0.0, 10000.0)
    assert cam.pitch_deg == -89.0


def test_flycam_movement_is_horizontal_for_ws():
    cam = FlyCamera()
    cam.mouse_move(0.0, -300.0)
    assert cam.pitch_deg == pytest.approx(30.0)
    assert abs(cam.movement_front[1]) < 1e-12
    cam.move("w", dt=0.1)
    assert cam.position[1] == pytest.approx(0.0)
    assert np.linalg.norm(cam.position) == pytest.approx(1.0)


def test_flycam_vertical_keys():
    cam = FlyCamera()
    cam.move("q", dt=0.25)
    np.testing.assert_allclose(cam.position, [0, 2.5, 0])
    cam.move("z", dt=0.25)
    np.testing.assert_allclose(cam.position, [0, 0, 0], atol=1e-12)


def test_flycam_scroll_multiplier():
    cam = FlyCamera()
    cam.scroll(2.0)
    assert cam.speed_multiplier == pytest.approx(1.1**2)
    cam.move("w", dt=0.1)
    assert np.linalg.norm(cam.position) == pytest.approx(10 * 1.1**2 * 0.1)
    cam.scroll(-2.0)
    assert cam.speed_multiplier == pytest.approx(1.0)


def test_flycam_strafe_direction():
    cam = FlyCamera()
    cam.move("d", dt=0.1)
    np.testing.assert_allclose(cam.position, [1.0, 0, 0], atol=1e-12)
    cam.move("a", dt=0.2)
    np.testing.assert_allclose(cam.position, [-1.0, 0, 0], atol=1e-12)


def test_flycam_to_camera_roundtrip():
    cam = FlyCamera()
    cam.mouse_move(100.0, -50.0)
    cam.move("wd", dt=0.05)
    c = cam.to_camera("float64", device="cpu")
    assert c.position.dtype == torch.float64 and c.position.device.type == "cpu"
    np.testing.assert_allclose(c.position.numpy(), cam.position)
    assert float(c.yaw_deg) == pytest.approx(cam.yaw_deg)
    assert float(c.pitch_deg) == pytest.approx(cam.pitch_deg)
    assert math.isclose(float(cam.to_camera(device="cpu").yaw_deg), cam.yaw_deg, rel_tol=1e-6)


# --- utils/film.py and utils/term_view.py (tests/test_term_view.py) ---

def test_to_uint8_rounds_like_reference():
    img = np.array([[[0.0, 0.5 / 255.0, 1.0]]], dtype=np.float32)
    assert to_uint8(img).tolist() == [[[0, 1, 255]]]
    img = np.array([[[-0.5, 2.0, 0.25]]], dtype=np.float32)
    assert to_uint8(img).tolist() == [[[0, 255, 64]]]


def test_flip_vertical():
    img = np.arange(12).reshape(2, 2, 3)
    np.testing.assert_array_equal(flip_vertical(img)[0], img[1])


def test_frame_to_ansi_shape_and_colors():
    img = np.zeros((4, 2, 3), dtype=np.float32)
    img[3, 0] = [1, 0, 0]  # top-left after flip
    lines = frame_to_ansi(img).split("\n")
    assert len(lines) == 2
    assert "▀" in lines[0]
    assert "38;2;255;0;0" in lines[0]


def test_frame_to_ansi_odd_height_dropped():
    assert len(frame_to_ansi(np.zeros((5, 3, 3), dtype=np.float32)).split("\n")) == 2
