"""Command-line app shell of the port.

Counterpart of ``tpu_ray_tracer/cli.py``. The reference's shell is a GLFW
window with a fly camera (reference: src/ray-tracer.cpp:136-248); GPU hosts
are headless, so the shell becomes subcommands:

* ``render <scene.yml> [-o out.png] [--pose X Y Z YAW PITCH] [--size W H]``
  — one frame to a PNG/NPY.
* ``bench <scene.yml> [--frames N]`` — frame-time / FPS / Mrays/s report,
  printing the reference's ``FPS: ..., last render time: ... ms`` line.
* ``fit <scene.yml> [--params F,...] [--steps N] [--soft-tau T]`` — inverse
  rendering: recover perturbed scene parameters (or the pose) from a target
  frame by Adam steps.
* ``view <scene.yml>`` — interactive terminal viewer with the fly camera.
* ``animate <scene.yml>`` — render a camera path (the offline analogue of
  fly-camera interaction), writing numbered PNGs.

Backends: ``torch`` is the plain PyTorch pipeline (the JAX package's
``jax``, or ``xla`` for ``fit``), ``kernel`` the hand-written kernels (its
``pallas``), ``numpy`` the f64 NumPy oracle. ``auto`` takes the pipeline for
``render`` and ``animate``, and for ``bench``, ``view`` and ``fit`` the
kernel on the card and the pipeline on the CPU (``fit`` takes the pipeline
for a soft loss, an empty scene or more than 31 lights; it rejects
``numpy``). ``--device`` places the scene and the render:
``cuda`` (the default) raises without a card; ``cpu`` renders on the host,
where the kernel backend runs its plain version.

Window size arguments exist for parity but only affect output scaling, as in
the reference (scene resolution is independent of window size,
reference: src/ray-tracer.cpp:160-169, 209-214).
"""

from __future__ import annotations

import argparse
import atexit
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


def cmd_fit(args) -> int:
    """Inverse rendering: recover perturbed scene parameters from a target
    image by gradient descent (BASELINE.json config; no reference analog)."""
    import numpy as np
    import torch

    from . import Camera
    from .diff.inverse import InverseProblem, fit
    from .parallel.sharding import render_image_sharded
    from .render.kernel_backend import MAX_AUX_LIGHTS
    from .render.pipeline import RenderConfig

    group, rank = None, 0
    if args.distributed:
        # one process per device under torchrun: the process group from its
        # environment (NCCL on cuda:LOCAL_RANK, gloo with --device cpu); the
        # rows are split across the ranks and the gradient all-reduced
        from .parallel.multihost import initialize_distributed
        from .parallel.sharding import make_mesh

        if initialize_distributed(device=args.device):
            atexit.register(torch.distributed.destroy_process_group)
        mesh = make_mesh(args.device)
        args.device = mesh.device
        group, rank = mesh.group, mesh.rank
    scene = _load(args)
    device = scene.coefs.device
    config = RenderConfig(geom_dtype="float32", polish_iters=2, chunk_px=None)
    # --pose sets the camera the self-recovery target is rendered at (and
    # the fixed render camera for scene-parameter fits)
    true_cam = _camera_from_pose(args.pose or (0.0, 0.0, 0.0, 90.0, 0.0), device)
    if args.target:
        target = torch.as_tensor(np.load(args.target), dtype=torch.float32, device=device)
    else:
        # self-recovery: the target is the unperturbed scene's frame, each
        # rank rendering its rows of it (one process renders them all)
        with torch.no_grad():
            target = render_image_sharded(scene, true_cam, config, backend="kernel", group=group)

    fields = args.params.split(",")
    perturbed = _perturb_scene(scene, fields, args.perturb)
    camera = true_cam
    if "camera" in fields and not args.target:
        # self-recovery pose fit: start from a perturbed pose; with an
        # external --target, --pose is the user's initial guess
        camera = _perturbed_camera(true_cam, args.pose_perturb)
    backend = args.backend
    if backend == "numpy":
        # fit cannot honour --backend numpy (the oracle has no gradient), so
        # reject it rather than remap the user's explicit choice
        print("fit: --backend numpy is not differentiable; use --backend torch or kernel",
              file=sys.stderr)
        return 2
    if backend == "auto":
        # the kernels wherever they apply (on the card); soft losses, empty
        # scenes and > 31-light scenes take the pipeline
        backend = ("torch" if args.soft_tau is not None or scene.n_objects == 0
                   or scene.n_lights > MAX_AUX_LIGHTS else _resolve_backend("auto", device))
    problem = InverseProblem(scene_template=perturbed, config=config,
                             param_fields=tuple(fields), learning_rate=args.lr,
                             soft_tau=args.soft_tau, backend=backend)
    params, losses = fit(problem, target, camera=camera, steps=args.steps,
                         checkpoint_path=args.checkpoint,
                         checkpoint_every=args.checkpoint_every,
                         tau_final=args.soft_tau_final, group=group)
    if rank != 0:
        return 0  # every rank holds the same result; rank 0 reports it
    print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e} over {len(losses)} steps")
    if "camera" in params:
        cam = Camera(*(t.detach() for t in (params["camera"].position,
                                            params["camera"].yaw_deg,
                                            params["camera"].pitch_deg)))
        pos = cam.position.cpu().tolist()
        hint = ""
        if not args.target:
            tp = true_cam.position.cpu().tolist()
            hint = (f" (self-recovery truth: ({tp[0]:g}, {tp[1]:g}, {tp[2]:g}),"
                    f" {float(true_cam.yaw_deg):g}, {float(true_cam.pitch_deg):g})")
        print(f"recovered pose: position ({pos[0]:.4f}, {pos[1]:.4f}, {pos[2]:.4f}), "
              f"yaw {float(cam.yaw_deg):.3f} deg, pitch {float(cam.pitch_deg):.3f} deg{hint}")
    return 0


def _perturb_scene(scene, fields, factor):
    """Perturb exactly the scene fields being optimized (``--params``), so
    that self-recovery descends on the parameters that differ from the
    target. ``coefs`` perturbs only the constant column: a uniform scaling
    of all 20 coefficients leaves the zero set F = 0 unchanged."""
    import dataclasses

    updates = {}
    for field in fields:
        if field == "camera":
            continue  # the pose is perturbed by _perturbed_camera
        value = getattr(scene, field)
        if field == "coefs":
            value = value.clone()
            value[:, 19] = value[:, 19] * factor
        else:
            value = value * factor
        updates[field] = value
    return dataclasses.replace(scene, **updates)


def _perturbed_camera(base, pose_perturb_deg: float):
    """Initial pose guess for camera recovery: ``base`` offset by
    ``pose_perturb_deg`` in yaw (half of it in pitch) and a proportional
    position shift."""
    import torch

    from . import Camera

    d = float(pose_perturb_deg)
    shift = torch.tensor([0.02 * d, -0.02 * d, 0.01 * d], dtype=torch.float32,
                         device=base.position.device)
    return Camera(position=base.position + shift, yaw_deg=base.yaw_deg + d,
                  pitch_deg=base.pitch_deg - 0.5 * d)


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

    p = sub.add_parser("fit", help="inverse rendering: recover scene params")
    _add_common(p)
    p.add_argument("--target", default=None, help=".npy target image (default: self)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--perturb", type=float, default=0.6,
                   help="light-intensity perturbation factor to recover from")
    p.add_argument("--params", default="light_color",
                   help="comma-separated scene fields to optimize; the pseudo-field "
                        "'camera' optimizes the camera pose (position/yaw/pitch)")
    p.add_argument("--pose-perturb", type=float, default=3.0,
                   help="initial pose offset in degrees for --params camera "
                        "self-recovery (plus a proportional position shift)")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process job under torchrun (python -m torch.distributed.run "
                        "--nproc_per_node N -m tpu_ray_tracer_torch.cli fit ... --distributed): "
                        "one rank per device (cuda:LOCAL_RANK over NCCL; --device cpu over "
                        "gloo), rows split across the ranks, gradients all-reduced, rank 0 "
                        "prints and writes checkpoints")
    p.add_argument("--soft-tau", type=float, default=None,
                   help="soft-visibility temperature for surface-coefficient recovery "
                        "across silhouette discontinuities (e.g. 0.15); default: hard render")
    p.add_argument("--soft-tau-final", type=float, default=None,
                   help="continuation: anneal the temperature geometrically from "
                        "--soft-tau down to this value (e.g. 1e-3)")
    p.set_defaults(fn=cmd_fit)

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
