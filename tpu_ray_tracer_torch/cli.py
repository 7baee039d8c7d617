"""Command-line app shell of the port.

Counterpart of ``tpu_ray_tracer/cli.py``. The reference's shell is a GLFW
window with a fly camera (reference: src/ray-tracer.cpp:136-248); GPU hosts
are headless, so the shell becomes subcommands:

* ``render <scene.yml> [-o out.png] [--pose X Y Z YAW PITCH] [--size W H]``
  — one frame to a PNG/NPY.
* ``bench <scene.yml> [--frames N]`` — frame-time / FPS / Mrays/s report,
  printing the reference's ``FPS: ..., last render time: ... ms`` line.
* ``view <scene.yml>`` — interactive terminal viewer with the fly camera.
* ``animate <scene.yml>`` — render a camera path (the offline analogue of
  fly-camera interaction), writing numbered PNGs.

Backends: ``torch`` is the plain PyTorch pipeline (the JAX package's
``jax``), ``kernel`` the hand-written forward kernel (its ``pallas``),
``numpy`` the f64 NumPy oracle. ``auto`` takes the pipeline for ``render``
and ``animate``, and for ``bench`` and ``view`` the kernel on the card and
the pipeline on the CPU. ``--device`` places the scene and the render:
``cuda`` (the default) raises without a card; ``cpu`` renders on the host,
where the kernel backend runs its plain version.

Window size arguments exist for parity but only affect output scaling, as in
the reference (scene resolution is independent of window size,
reference: src/ray-tracer.cpp:160-169, 209-214).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def _add_common(p):
    p.add_argument("scene", help="YAML scene description")
    p.add_argument("--backend", choices=["auto", "torch", "kernel", "numpy"],
                   default="auto",
                   help="renderer backend (torch = plain PyTorch pipeline; kernel = "
                        "the hand-written CUDA kernel, its plain version on the CPU; "
                        "numpy = the f64 oracle)")
    p.add_argument("--device", default="cuda",
                   help="device of the scene and the render (default cuda, which "
                        "raises without a CUDA device; cpu renders on the host)")
    p.add_argument("--size", nargs=2, type=int, metavar=("W", "H"), default=None,
                   help="override scene resolution")
    p.add_argument("--pose", nargs=5, type=float,
                   metavar=("X", "Y", "Z", "YAW", "PITCH"), default=None,
                   help="camera pose (default: reference initial pose)")


def _load(args):
    import dataclasses

    from . import load_from_file

    scene = load_from_file(args.scene, device=args.device)
    if args.size:
        scene = dataclasses.replace(scene, width=args.size[0], height=args.size[1])
    return scene


def _camera_from_pose(pose, device):
    """(X, Y, Z, YAW, PITCH) — the --pose argument order — to an f32 Camera."""
    import torch

    from . import Camera

    return Camera(
        position=torch.tensor(pose[:3], dtype=torch.float32, device=device),
        yaw_deg=torch.tensor(pose[3], dtype=torch.float32, device=device),
        pitch_deg=torch.tensor(pose[4], dtype=torch.float32, device=device),
    )


def _tensor_render(backend: str):
    """``(scene, camera) -> [H, W, 3]`` tensor for the ``kernel`` or
    ``torch`` backend."""
    from . import FAST_CONFIG, render_image, render_image_kernel

    if backend == "kernel":
        return render_image_kernel
    return lambda scene, camera: render_image(scene, camera, FAST_CONFIG)


def _renderer(scene, backend: str):
    """``render(pose) -> [H, W, 3]`` numpy for a backend; ``pose`` is the
    --pose tuple or None for the reference pose."""
    if backend == "numpy":
        from .render.reference_cpu import render_image_np

        def render(pose):
            pose = pose or (0.0, 0.0, 0.0, 90.0, 0.0)
            return render_image_np(scene, position=pose[:3], yaw_deg=pose[3],
                                   pitch_deg=pose[4])
        return render

    import torch

    device = scene.coefs.device
    frame = _tensor_render(backend)

    def render(pose):
        camera = _camera_from_pose(pose, device) if pose else None
        with torch.no_grad():
            return frame(scene, camera).cpu().numpy()
    return render


def _resolve_backend(args_backend: str, device) -> str:
    """auto -> the kernel on the card, the plain pipeline on the CPU (where
    the kernel's plain version would be slower than the pipeline)."""
    if args_backend != "auto":
        return args_backend
    return "kernel" if device.type == "cuda" else "torch"


def cmd_render(args) -> int:
    from .models.errors import SceneError
    from .utils.io import write_npy, write_png

    try:
        scene = _load(args)
    except SceneError as exc:
        # reference error surface (src/ray-tracer.cpp:151-158)
        print(f"Error during scene loading\n{exc}", file=sys.stderr)
        return 1
    backend = "torch" if args.backend == "auto" else args.backend
    image = _renderer(scene, backend)(args.pose)
    if args.check:
        # device-error surface (the checkCudaErrors analog): report
        # non-finite pixels with indices and exit nonzero
        from .utils.guard import RenderCheckError, check_image

        try:
            check_image(image, context=args.scene)
        except RenderCheckError as exc:
            print(f"Render check failed\n{exc}", file=sys.stderr)
            return 1
    out = args.output or "render.png"
    if out.endswith(".npy"):
        write_npy(out, image)
    else:
        write_png(out, image)
    print(f"Wrote {out} ({scene.width}x{scene.height})")
    return 0


def cmd_bench(args) -> int:
    """Frame-time / Mrays/s report over ``--frames`` frames with distinct
    poses (yaw 90 + 1e-3 k), after one warm-up frame (which builds the
    kernel on first use). On the card the frames are timed by CUDA events
    around the loop, the reference's own method (src/update-cuda.cu:178-189);
    on the CPU by the host clock."""
    import torch

    from .utils.timing import FrameTimer, mrays_per_s

    scene = _load(args)
    n_px = scene.width * scene.height
    device = scene.coefs.device
    backend = _resolve_backend(args.backend, device)
    poses = [(0.0, 0.0, 0.0, 90.0 + 1e-3 * k, 0.0) for k in range(args.frames)]

    if backend == "numpy":
        # the reference's serial-CPU-backend analogue: honest wall timing
        render = _renderer(scene, backend)
        timer = FrameTimer()
        times = []
        for pose in poses:
            t0 = time.perf_counter()
            render(pose)
            dt = time.perf_counter() - t0
            times.append(dt)
            timer.frame(dt * 1e3)
        best = min(times)
        print(f"backend numpy | frame best {best*1e3:.3f} ms mean "
              f"{sum(times)/len(times)*1e3:.3f} ms | "
              f"{mrays_per_s(n_px, best):.1f} Mrays/s (primary)")
        return 0

    cams = [_camera_from_pose(pose, device) for pose in poses]
    render = _tensor_render(backend)
    cuda = device.type == "cuda"

    with torch.no_grad():
        t0 = time.perf_counter()
        render(scene, cams[0])
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0

        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = (torch.profiler.profile(activities=activities) if args.profile
                else contextlib.nullcontext())
        with prof:
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for camera in cams:
                    render(scene, camera)
                end.record()
                torch.cuda.synchronize(device)
                frame_s = start.elapsed_time(end) / 1e3 / args.frames
            else:
                t0 = time.perf_counter()
                for camera in cams:
                    render(scene, camera)
                frame_s = (time.perf_counter() - t0) / args.frames
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(path)
            print(f"profiler trace written to {path}")

    # the reference's FPS line (src/ray-tracer.cpp:239), from the measured
    # per-frame time
    print(f"FPS: {1.0 / frame_s:.4f}, last render time: {frame_s * 1e3:.4f} ms")
    clock = "CUDA events" if cuda else "host clock"
    where = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(
        f"backend {backend} on {where} | set-up {setup_s:.1f} s | frame "
        f"{frame_s*1e3:.3f} ms over {args.frames} frames ({clock}) | "
        f"{mrays_per_s(n_px, frame_s):.1f} Mrays/s (primary)"
    )
    return 0


def cmd_view(args) -> int:
    """Interactive terminal viewer (the reference's GLFW window analogue).

    As in the reference, the render resolution is the SCENE resolution and
    the view (window) size only scales the display (src/ray-tracer.cpp:
    160-169, 209-214 — the texture is scene-sized regardless of window
    size). ``--size`` sets the terminal cell grid; ``--render-size``
    overrides the scene resolution itself (useful on CPU hosts where the
    full-resolution frame is slow, mirroring the reference's CPU backend).
    """
    import dataclasses

    from . import load_from_file
    from .utils.term_view import downsample_for_view, run_viewer

    scene = load_from_file(args.scene, device=args.device)
    if args.render_size:
        scene = dataclasses.replace(
            scene, width=args.render_size[0], height=args.render_size[1])
    view_w = args.size[0] if args.size else 120
    view_h = args.size[1] if args.size else 72
    render = _renderer(scene, _resolve_backend(args.backend, scene.coefs.device))

    def render_fn(camera):
        pose = (*camera.position.tolist(), float(camera.yaw_deg), float(camera.pitch_deg))
        return downsample_for_view(render(pose), view_w, view_h)

    run_viewer(render_fn, view_w, view_h, print_fn=None, device=args.device)
    return 0


def cmd_animate(args) -> int:
    from .utils.io import write_png

    scene = _load(args)
    render = _renderer(scene, "torch" if args.backend == "auto" else args.backend)
    for i in range(args.frames):
        image = render((0.0, 0.0, 0.0, 90.0 + args.yaw_rate * i, 0.0))
        path = f"{args.prefix}{i:04d}.png"
        write_png(path, image)
        print(f"Wrote {path}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu-ray-tracer-torch",
        description="differentiable ray tracer for algebraic surfaces, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one frame to an image file")
    _add_common(p)
    p.add_argument("-o", "--output", default=None, help="output file (.png/.npy)")
    p.add_argument("--check", action="store_true",
                   help="fail with pixel indices if the render produces "
                        "non-finite values (device-error surface)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="benchmark frame time / Mrays/s")
    _add_common(p)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed frames to "
                        "DIR/trace.json")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("view", help="interactive terminal viewer (fly camera)")
    _add_common(p)
    p.add_argument("--render-size", nargs=2, type=int, metavar=("W", "H"),
                   default=None,
                   help="override the scene's render resolution (the view "
                        "--size only scales the display, as in the "
                        "reference)")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("animate", help="render a yaw-sweep camera path")
    _add_common(p)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--yaw-rate", type=float, default=2.0, help="deg per frame")
    p.add_argument("--prefix", default="frame_")
    p.set_defaults(fn=cmd_animate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
