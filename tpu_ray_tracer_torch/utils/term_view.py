"""Interactive terminal viewer: the reference's GLFW window + fly camera
(reference: src/ray-tracer.cpp) re-imagined for headless GPU hosts.

Counterpart of ``tpu_ray_tracer/utils/term_view.py``.

Renders frames through any backend and displays them as 24-bit ANSI
half-block cells (two pixels per character row), with the reference's
control scheme mapped to the keyboard:

  w/s/a/d   move (horizontal, reference :69-80)
  q/z       up / down (:81-86)
  arrows    look (mouse-look analogue, :106-129)
  +/-       speed multiplier x1.1 (scroll analogue, :131-134)
  ESC / x   quit (:66-68)

Each frame prints the reference's ``FPS: ..., last render time: ... ms``
line. Requires a TTY; falls back to a single dumped frame otherwise.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .film import to_uint8
from .flycam import FlyCamera
from .timing import FrameTimer, span

ESC = "\x1b"


def downsample_for_view(image: np.ndarray, view_w: int, view_h: int) -> np.ndarray:
    """[H, W, 3] frame -> [view_h, view_w, 3] for terminal display.

    The render resolution is the scene's (reference: the GL texture is
    scene-sized and the window only rescales it, src/ray-tracer.cpp:209-214
    with GL_LINEAR magnification). Area-mean over integer-strided boxes when
    shrinking; nearest-neighbor indexing otherwise. No-op when sizes match.
    """
    h, w = image.shape[:2]
    if (w, h) == (view_w, view_h):
        return image
    if w >= view_w and h >= view_h and w % view_w == 0 and h % view_h == 0:
        sy, sx = h // view_h, w // view_w
        return image.reshape(view_h, sy, view_w, sx, 3).mean(axis=(1, 3))
    ys = (np.arange(view_h) * h) // view_h
    xs = (np.arange(view_w) * w) // view_w
    return image[ys][:, xs]


def view_frame(frame, scene, camera, view_w: int, view_h: int) -> np.ndarray:
    """One frame of the viewer: ``frame(scene, camera)`` (a tensor backend's
    render, ``render_image_kernel`` on the card) without a gradient, read
    back to the host whole, then ``downsample_for_view`` to the
    [view_h, view_w, 3] grid. The frame is delivered when that array is on
    the host.

    While a torch profiler runs it shows as the span ``trt.view``, with the
    copy to the host as ``trt.view.readback`` and the reduction as
    ``trt.view.downsample``."""
    import torch

    with span("trt.view"):
        with torch.no_grad():
            image = frame(scene, camera)
        with span("trt.view.readback"):
            host = image.cpu().numpy()
        with span("trt.view.downsample"):
            return downsample_for_view(host, view_w, view_h)


def frame_to_ansi(image: np.ndarray) -> str:
    """[H, W, 3] float/uint8 (row 0 = bottom) -> ANSI half-block string."""
    img = to_uint8(image)[::-1]  # top-down for terminal
    height, width = img.shape[:2]
    if height % 2:
        img = img[:-1]
        height -= 1
    lines = []
    for y in range(0, height, 2):
        top, bottom = img[y], img[y + 1]
        cells = []
        for x in range(width):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg_, bb = (int(v) for v in bottom[x])
            cells.append(
                f"{ESC}[38;2;{tr};{tg};{tb}m{ESC}[48;2;{br};{bg_};{bb}m▀"
            )
        lines.append("".join(cells) + f"{ESC}[0m")
    return "\n".join(lines)


def _read_key(timeout_s: float):
    """Non-blocking single-key read from a raw-mode TTY; arrows decoded."""
    import select

    r, _, _ = select.select([sys.stdin], [], [], timeout_s)
    if not r:
        return None
    ch = sys.stdin.read(1)
    if ch == ESC:
        r, _, _ = select.select([sys.stdin], [], [], 0.01)
        if not r:
            return "esc"
        seq = sys.stdin.read(2)
        return {"[A": "up", "[B": "down", "[C": "right", "[D": "left"}.get(seq, None)
    return ch


def run_viewer(render_fn, width: int, height: int, print_fn=None,
               device="cuda") -> None:
    """Drive an interactive session. ``render_fn(camera) -> [H, W, 3]``
    numpy, the camera's tensors on ``device``.

    Falls back to printing one frame when stdin is not a TTY.
    """
    out = sys.stdout
    cam = FlyCamera()
    if not sys.stdin.isatty():
        out.write(frame_to_ansi(render_fn(cam.to_camera(device=device))) + "\n")
        return

    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    timer = FrameTimer(print_fn=print_fn or (lambda s: None))
    look_step = 40.0  # "mouse" pixels per arrow press
    try:
        tty.setcbreak(fd)
        out.write(f"{ESC}[2J")  # clear
        last = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            frame = render_fn(cam.to_camera(device=device))
            render_ms = (time.perf_counter() - t0) * 1e3
            out.write(f"{ESC}[H" + frame_to_ansi(frame) + "\n")
            out.write(
                f"pos=({cam.position[0]:.1f},{cam.position[1]:.1f},"
                f"{cam.position[2]:.1f}) yaw={cam.yaw_deg:.1f} "
                f"pitch={cam.pitch_deg:.1f} x{cam.speed_multiplier:.2f} | "
                f"render {render_ms:.1f} ms | wasd/qz move, arrows look, "
                f"+/- speed, x quit\n"
            )
            out.flush()
            timer.frame(render_ms)

            key = _read_key(0.02)
            now = time.perf_counter()
            dt = now - last
            last = now
            if key in ("esc", "x"):
                break
            if key in ("w", "s", "a", "d", "q", "z"):
                cam.move(key, dt)
            elif key == "left":
                cam.mouse_move(-look_step, 0)
            elif key == "right":
                cam.mouse_move(look_step, 0)
            elif key == "up":
                cam.mouse_move(0, -look_step)
            elif key == "down":
                cam.mouse_move(0, look_step)
            elif key == "+":
                cam.scroll(1.0)
            elif key == "-":
                cam.scroll(-1.0)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        out.write(f"{ESC}[0m\n")
