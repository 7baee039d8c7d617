"""The ``view`` driver: a fly-through, as the reference's window runs it.

One client in a closed loop. Each frame takes the next pose of the seeded
session (``flysession.py``, cycled), makes the program's ``Camera`` tensors
on the device from it (as the port's ``FlyCamera.to_camera`` does), calls
``render_image_kernel(scene, camera)`` under ``torch.no_grad()`` at the
call's defaults, and synchronizes: the frame is delivered then, its image
left on the device (the reference draws through GL interop and never reads
back). A frame's latency runs from taking its pose to that synchronize.

Correctness: a seeded reservoir sample of the window's frames (the images as
the program returned them) is compared, once the window has closed, with the
plain reference's frame at the same pose (``reference/``, in the
configuration's reference dtype): ``bad_px_share`` is the largest share, over
the sampled frames, of pixels whose largest channel differs by more than
2/255.
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

from .. import flysession, harness, roofline
from ..reference import fit as ref

BAD_PIXEL = 2.0 / 255.0


def bad_px_share(image, reference) -> float:
    """The share of pixels whose largest channel differs by more than 2/255."""
    diff = (image.double() - reference.double()).abs().amax(-1)
    return float((diff > BAD_PIXEL).double().mean())


class Driver:
    unit = "frame"

    def __init__(self, cell, seed: int, device):
        from tpu_ray_tracer_torch.models.loader import load_from_file
        from tpu_ray_tracer_torch.ops.camera import Camera
        from tpu_ray_tracer_torch.render.kernel_backend import render_image_kernel

        t0 = time.perf_counter()
        self.cell, self.device, self.mix = cell, device, cell.mix
        self.Camera = Camera
        self.render = render_image_kernel
        self.scene = load_from_file(cell.scene_path, device=device)
        if cell.size is not None:
            self.scene = dataclasses.replace(self.scene, width=cell.size[0], height=cell.size[1])
        elif (self.scene.width, self.scene.height) != (cell.setting["width"], cell.setting["height"]):
            raise ValueError(f"{cell.scene_path}: {self.scene.width}x{self.scene.height}, the "
                             f"configuration states {cell.setting['width']}x{cell.setting['height']}")
        t1 = time.perf_counter()
        pos, yaw, pitch = flysession.session(self.mix, cell.setting["view"], seed)
        # the pose as the program gets it: float32 (FlyCamera.to_camera)
        self.poses = [(p.astype(np.float32), float(np.float32(y)), float(np.float32(q)))
                      for p, y, q in zip(pos, yaw, pitch)]
        self.sampler = random.Random(seed)
        self.keep = int(self.mix["sample_frames"])
        self.kept = []        # [(pose index, image)]
        self.latencies = []
        self.n = 0
        self.trace_start = 0
        self.failures = 0
        t2 = time.perf_counter()
        held = []  # as many frames alive as the window keeps, so that it allocates no more
        for _ in range(int(self.mix["warm_frames"])):
            held = held[-self.keep:] + [self.frame(self.n % len(self.poses), harness.no_span)]
            self.n += 1
        del held
        self.n = 0  # the window starts the session again
        self.reference_s = 0.0
        self.phases = {"scene": t1 - t0, "session": t2 - t1, "warm_frames": time.perf_counter() - t2}

    def frame(self, i: int, span):
        position, yaw, pitch = self.poses[i]
        with span("port_bench.pose"):
            camera = self.Camera(
                position=torch.as_tensor(position, dtype=torch.float32, device=self.device),
                yaw_deg=torch.tensor(yaw, dtype=torch.float32, device=self.device),
                pitch_deg=torch.tensor(pitch, dtype=torch.float32, device=self.device))
        with span("port_bench.call"), torch.no_grad():
            image = self.render(self.scene, camera)
        with span("port_bench.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return image

    def before_trace(self) -> None:
        self.trace_start = self.n

    def run_unit(self, span) -> None:
        i = self.n % len(self.poses)
        with span("port_bench.frame"):
            t0 = time.perf_counter()
            image = self.frame(i, span)
            self.latencies.append(time.perf_counter() - t0)
        # reservoir sample of the window's frames, drawn from the seed
        if len(self.kept) < self.keep:
            self.kept.append((i, image))
        else:
            j = self.sampler.randrange(self.n + 1)
            if j < self.keep:
                self.kept[j] = (i, image)
        self.n += 1

    def end_to_end(self, window_s: float, n: int) -> dict:
        return {"frame_ms": window_s * 1e3 / n,
                "frame_ms_p95": float(np.percentile(np.asarray(self.latencies), 95)) * 1e3}

    def free(self) -> None:
        from tpu_ray_tracer_torch.render import kernel_backend

        kernel_backend._FRAMES.clear()
        self.scene = None

    def reference_scene(self, dtype):
        scene = ref.load_scene(self.cell.scene_path, self.device, dtype)
        if self.cell.size is not None:
            scene = dataclasses.replace(scene, width=self.cell.size[0], height=self.cell.size[1])
        return scene

    def reference_frame(self, scene, i: int, polish_iters: int):
        position, yaw, pitch = self.poses[i]
        dtype = scene.coefs.dtype
        return ref.render_frame(scene, ref.camera(dtype, self.device, position.tolist(), yaw, pitch),
                                polish_iters=polish_iters)

    def readings(self, images=None) -> list:
        """The bad-pixel share of each sampled frame (or of ``images``, one
        per sampled pose) against the reference."""
        reference = self.cell.setting["reference"]
        scene = self.reference_scene(getattr(torch, reference["dtype"]))
        images = images or [image for _, image in self.kept]
        return [bad_px_share(image, self.reference_frame(scene, i, reference["polish_iters"]))
                for (i, _), image in zip(self.kept, images)]

    def check(self) -> dict:
        shares = self.readings()
        limit = self.cell.limits["bad_px_share"]
        self.failures = sum(s > limit for s in shares)
        return {"bad_px_share": {"value": max(shares), "limit": limit}}

    def least(self, trace, kernel: str) -> dict:
        """{unit: least seconds} of K1 for a few frames of the traced slice,
        spread evenly over it (K2 has no call in a frame)."""
        if kernel != "k1":
            return {}
        scene = self.reference_scene(torch.float32)
        count = min(int(self.mix["roofline_frames"]), trace.units)
        out = {}
        for u in np.linspace(0, trace.units - 1, count).round().astype(int).tolist():
            position, yaw, pitch = self.poses[(self.trace_start + u) % len(self.poses)]
            camera = ref.camera(torch.float32, self.device, position.tolist(), yaw, pitch)
            out[u] = roofline.frame_work(scene, camera, polish_iters=int(self.mix["polish_iters"]),
                                         save_aux=False)["k1"]
        return out

