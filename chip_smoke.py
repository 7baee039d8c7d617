#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ray_tracer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. device: require CUDA; print the card's name and power limit, torch,
   CUDA and nvcc versions;
2. build: compile every kernel of the path from csrc/ (timed as set-up);
3. main path: load scenes/dingdong.yml and render it at 1280x720 from the
   reference pose through ``render_image_kernel``, with every launch count
   set to 0 just before and read just after; check the frame;
4. parity: all 8 bundled scenes at full size through ``render_image_kernel``
   against bench_goldens/<scene>.npz, each within its gate
   (tpu_ray_tracer_torch.parity.PARITY_GATES, the JAX bench's gates);
5. kernel vs plain: the kernel against ``render_fwd_plain`` on the same
   CUDA tables, every scene at the reference pose and dingdong at an off
   pose, at most 1e-3 of the pixels differing by more than 2/255 per frame;
6. timing: CUDA events over 32 frames of dingdong 1280x720 at yaws
   90 + 1e-3 k after warm-up (kernel alone, whole call, plain version), and
   the kernel alone per scene.

The last lines are the card's name and power limit, a {"kernels": [...]}
line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = ("dingdong", "monkey_saddle", "20spheres", "reflection_test",
          "quadratic", "cayley", "clebsch", "cubic")
MAX_BAD_VS_PLAIN = 1e-3   # per frame, kernel vs its plain version
OFF_POSE = ((0.0, 2.0, -3.0), 75.0, -12.0)
TIMED_FRAMES = 32
PLAIN_FRAMES = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def timed_ms(fn, frames: int) -> float:
    """Device time per call of ``fn(k)`` for k in range(frames), by CUDA
    events around the whole run (host gaps between calls included)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for k in range(frames):
        fn(k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "tpu_ray_tracer_torch")):
        raise SystemExit(f"chip_smoke: no tpu_ray_tracer_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    import numpy as np

    import tpu_ray_tracer_torch as ttt
    from tpu_ray_tracer_torch.parity import PARITY_GATES, bad_pixel_fraction
    from tpu_ray_tracer_torch.render import _build
    from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd, render_fwd_plain
    from tpu_ray_tracer_torch.render.kernel_backend import pack_frame

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # --- 1. device ---
    smi = nvidia_smi_line()
    log(f"[device] {smi} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"| torch {torch.__version__} CUDA {torch.version.cuda} "
        f"| {nvcc_version(_build._nvcc())}")

    # --- 2. build ---
    t0 = time.perf_counter()
    lib_path = _build.build("render_fwd")
    _build.load("render_fwd")
    log(f"[build] render_fwd: {time.perf_counter() - t0:.1f} s -> {lib_path} "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in (lib_path.parent / "ptxas.txt").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    def load(name):
        return ttt.load_from_file(os.path.join(REPO, "scenes", name + ".yml"))

    def golden(name):
        return np.load(os.path.join(REPO, "bench_goldens", name + ".npz"))["image"]

    def camera(position=(0.0, 0.0, 0.0), yaw=90.0, pitch=0.0):
        return ttt.Camera(position=torch.tensor(position, dtype=torch.float32, device=dev),
                          yaw_deg=torch.tensor(yaw, dtype=torch.float32, device=dev),
                          pitch_deg=torch.tensor(pitch, dtype=torch.float32, device=dev))

    # --- 3. main path: dingdong 1280x720, reference pose ---
    ding = load("dingdong").to(dev)
    render_fwd.launches = 0
    image = ttt.render_image_kernel(ding)
    torch.cuda.synchronize()
    main_launches = render_fwd.launches
    if main_launches < 1:
        raise RuntimeError("main path: render_image_kernel never launched render_fwd")
    image = image.cpu().numpy()
    if image.shape != (720, 1280, 3) or not np.isfinite(image).all():
        raise RuntimeError(f"main path: bad frame shape {image.shape} or non-finite values")
    frac = bad_pixel_fraction(image, golden("dingdong"))
    log(f"[main] dingdong 1280x720 via render_image_kernel: launches={main_launches} "
        f"bad-px vs golden {frac:.6f} (gate {PARITY_GATES['dingdong']})")
    if frac > PARITY_GATES["dingdong"]:
        raise RuntimeError("main path: dingdong over its parity gate")

    # --- 4. parity against the goldens, all scenes at full size ---
    scenes = {name: load(name).to(dev) for name in SCENES}
    parity = {}
    for name, scene in scenes.items():
        before = render_fwd.launches
        img = ttt.render_image_kernel(scene).cpu().numpy()
        if render_fwd.launches != before + 1:
            raise RuntimeError(f"parity {name}: expected one kernel launch, "
                               f"counted {render_fwd.launches - before}")
        parity[name] = bad_pixel_fraction(img, golden(name))
        log(f"[parity] {name} {scene.width}x{scene.height}: bad-px {parity[name]:.6f} "
            f"(gate {PARITY_GATES[name]})")
    over = [n for n, f in parity.items() if f > PARITY_GATES[n]]
    if over:
        raise RuntimeError(f"parity gate exceeded: {over}")

    # --- 5. kernel against its plain version on the same CUDA tables ---
    cases = [(name, camera()) for name in SCENES]
    cases.append(("dingdong@off", camera(*OFF_POSE)))
    worst_frac, worst_abs = 0.0, 0.0
    for label, cam in cases:
        scene = scenes[label.split("@")[0]]
        tables, kw = pack_frame(scene, cam, 0, scene.height)
        k_img = render_fwd(*tables, **kw).cpu().numpy()
        p_img = render_fwd_plain(*tables, **kw).cpu().numpy()
        frac = bad_pixel_fraction(k_img, p_img)
        max_abs = float(np.abs(k_img - p_img).max())
        worst_frac, worst_abs = max(worst_frac, frac), max(worst_abs, max_abs)
        log(f"[vs-plain] {label}: bad-px {frac:.6f} max|diff| {max_abs:.6f}")
        if frac > MAX_BAD_VS_PLAIN:
            raise RuntimeError(f"kernel vs plain {label}: {frac} > {MAX_BAD_VS_PLAIN}")

    # --- 6. timing (dingdong 1280x720, the JAX bench's yaw sweep) ---
    n_px = ding.width * ding.height
    yaws = (90.0 + 1e-3 * torch.arange(TIMED_FRAMES, dtype=torch.float32)).tolist()
    cams = [camera(yaw=y) for y in yaws]
    frames = [pack_frame(ding, c, 0, ding.height) for c in cams]
    for tables, kw in frames[:2]:  # warm-up
        render_fwd(*tables, **kw)
        render_fwd_plain(*tables, **kw)
    kernel_ms = timed_ms(lambda k: render_fwd(*frames[k][0], **frames[k][1]), TIMED_FRAMES)
    call_ms = timed_ms(lambda k: ttt.render_image_kernel(ding, cams[k]), TIMED_FRAMES)
    plain_ms = timed_ms(lambda k: render_fwd_plain(*frames[k][0], **frames[k][1]),
                        PLAIN_FRAMES)
    for what, ms in (("kernel", kernel_ms), ("render_image_kernel call", call_ms),
                     ("plain version", plain_ms)):
        log(f"[time] dingdong 1280x720 {what}: {ms:.4f} ms/frame "
            f"{n_px / ms / 1e3:.2f} Mrays/s ({smi})")
    for name, scene in scenes.items():
        tables, kw = pack_frame(scene, camera(), 0, scene.height)
        render_fwd(*tables, **kw)
        ms = timed_ms(lambda k: render_fwd(*tables, **kw), TIMED_FRAMES)
        log(f"[time] kernel {name} {scene.width}x{scene.height}: {ms:.4f} ms/frame "
            f"{scene.width * scene.height / ms / 1e3:.2f} Mrays/s ({smi})")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/render_fwd.cu",
        "replaces": "tpu_ray_tracer/render/pallas_backend.py:978",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "worst_bad_px_vs_plain": worst_frac,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
