#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ray_tracer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. device: require CUDA; print the card's name and power limit, torch,
   CUDA and nvcc versions;
2. build: compile every kernel of the path from csrc/, one nvcc per source,
   all started together (timed as set-up);
3. main path: load scenes/dingdong.yml (onto the card, the loader's
   default) and render it at 1280x720 from the reference pose through
   ``render_image_kernel``, with every launch count set to 0 just before and
   read just after (the forward's main instantiation must have run); check
   the frame;
4. parity: all 8 bundled scenes at full size through ``render_image_kernel``
   against bench_goldens/<scene>.npz, each within its gate
   (tpu_ray_tracer_torch.parity.PARITY_GATES, the JAX bench's gates);
5. kernel vs plain: the kernel against ``render_fwd_plain`` on the same
   CUDA tables, every scene at the reference pose, dingdong at an off pose
   and dingdong with polish 2 (the generic instantiation; the others run the
   main ones, reflection_test the one with a chain), at most 1e-3 of the
   pixels differing by more than 2/255 per frame;
6. timing: CUDA events over 32 frames of dingdong 1280x720 at yaws
   90 + 1e-3 k after warm-up (the kernel alone as device time of its
   launches run back to back; the whole call and the plain version with the
   host's gaps), and
   the kernel alone per scene, each beside its bound
   (tpu_ray_tracer_torch/render/bounds.py, counted from that frame's aux);
7a. the main path with a gradient: dingdong 1280x720 through
   ``render_image_kernel`` with every differentiable scene and camera
   tensor requiring grad, then ``loss.backward()``, the counts set to 0
   just before and read just after: one render_fwd and one render_bwd
   launch, every gradient finite and nonzero (reflection excepted: no
   dingdong object reflects, so the chain is not traced);
7b. the backward kernel against ``render_bwd_plain`` on the same aux (the
   kernel forward's), dingdong, reflection_test and 20spheres at full size,
   each parameter group within tests/test_pallas.py's rule;
7c. determinism: a second backward gives the same bits;
7d. three ``torch.optim.Adam`` steps (lr 1e-2) on dingdong 1280x720 fitting
   the object colours and bg_color, started 10% low, to the frame rendered
   at the true values: the loss falls at every step;
7e. timing by CUDA events over 32 frames of the yaw sweep:
   ``render_fwd(save_aux=True)``, ``render_bwd`` alone, the whole fwd+bwd
   call, and ``render_bwd_plain`` once, each kernel beside its bound
   (counted from the timed frames' own aux); the backward alone on
   20spheres and reflection_test beside its bound;
8a. the command line in-process: ``render scenes/dingdong.yml --backend
   kernel --check`` (the counts set to 0 just before: one render_fwd launch,
   of the main instantiation; the frame within dingdong's gate), then
   ``bench scenes/dingdong.yml --frames 32`` (auto resolves to the kernel on
   the card) with its FPS line;
8b. the plain PyTorch pipeline on the card: FAST (f32, polish 3, one shot)
   on all 8 scenes at full size against bench_goldens (at most 1% bad
   pixels) and against K1's frame (at most 0.5%), with each frame's peak
   device memory; GOLDEN (f64) on dingdong and reflection_test against the
   goldens (at most 1%);
8c. the gradient fallback: a 33-light and a 0-object scene built with the
   port's builders through ``render_image_kernel`` and ``backward()``, the
   counts set to 0 just before: one render_fwd launch (main), no
   render_bwd; the gradients equal the pipeline's own autograd (rtol 1e-5
   light_color, 1e-4 coefs; zero for the 0-object lights);
8d. the pipeline's fwd+bwd on dingdong 1280x720 at pitch 5 against K2's
   gradient from 7a under tests/test_pallas.py:174-181's rule, logged per
   group over the frame; every group finite, and within the rule over the
   pixels whose primary hit the two forwards find alike (the same object,
   t and dF/dt within 1e-4 relative), weighted by the
   cotangent of 7a;
8e. the pipeline's times by CUDA events (FAST and GOLDEN forward, fwd+bwd,
   the 33-light fallback's fwd+bwd) with the peak device memory of each;
9a. the fit's main path: ``fit scenes/dingdong.yml --steps 5`` in-process
   (auto resolves to the kernel route; the counts set to 0 just before):
   5 render_fwd launches with aux and 5 render_bwd, plus the one forward
   of the target frame; the loss finite and falling; then the train step
   alone timed by CUDA events beside 7e's fwd+bwd call;
9b. the BASELINE.json inverse configuration: clebsch 800x600, coefs and
   light colours perturbed by 0.6, 5 steps through the kernels and 3 with
   the soft loss (tau 0.15) through the pipeline by row blocks; the loss
   falls on both routes; each step's time and the peak device memory;
9c. ``render_rays_soft`` at tau 1e-4 against the hard pipeline frame on
   clebsch and quadratic at full size: under 2% of pixels apart by more
   than 2/255 (tests/test_soft.py:36-59's rule);
9d. checkpoint resume: 4 kernel-route fit steps on dingdong against 2, a
   checkpoint and 2 resumed, bitwise equal parameters; a checkpoint without
   its ``opt/...`` keys raises;
10a. the row-sharded path at world size 1 over NCCL, in this process
   (the counts set to 0 just before): ``render_image_sharded`` (kernel
   route) on dingdong 1280x720 equals phase 3's frame bit for bit, and 5
   sharded kernel-route fit steps (light colours x0.6, polish 2) give the
   losses and parameters of ``make_train_step`` without a process group,
   bit for bit; each step's time by CUDA events and its peak memory;
10b. two ranks on the one card, in two spawned processes of this script
   (``--rank``; gloo on CUDA tensors, since NCCL refuses two ranks on one
   device; each child bounded by a timeout): the stitched frame equals phase
   3's bit for bit; rank 1's rows (row0 360) match ``render_fwd_plain`` on
   the same tables under phase 5's 1e-3 rule; a 5-step ``fit`` with a
   shared checkpoint path gives the same light colours on both ranks, bit
   for bit, and losses and light colours within 1e-5 relative of 10a's,
   the loss falling, only rank 0 writing the checkpoint, and each rank 5
   ``render_fwd`` launches with aux and 5 ``render_bwd``; each step timed;
10c. ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
   tpu_ray_tracer_torch.cli fit scenes/dingdong.yml --steps 5
   --distributed``: exit 0, one summary line, the loss falling. A world of
   one forms no process group, so this runs no collective: it checks the
   CLI's torchrun entry on the card (NCCL refuses a second rank on the one
   card; two CLI ranks run over gloo in tests/test_torch_multihost.py);
10d. the native C++ loader (``tpu_ray_tracer_torch/native``, built with g++)
   puts all 8 scenes on the card with tables equal to the Python loader's,
   and its dingdong renders phase 3's frame bit for bit.

The last lines are the card's name and power limit, a {"kernels": [...]}
line (each kernel's launches on the main paths, the sharded ones of 10a and
of both ranks of 10b included, its time, its plain
version's, its bound and share of the bound on dingdong 1280x720; no single
PyTorch call computes either function, so ``library_ms`` is null), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = ("dingdong", "monkey_saddle", "20spheres", "reflection_test",
          "quadratic", "cayley", "clebsch", "cubic")
MAX_BAD_VS_PLAIN = 1e-3   # per frame, kernel vs its plain version
MAX_BAD_PIPELINE = 0.01   # pipeline vs golden (tests/test_golden.py's limit)
MAX_BAD_PIPELINE_VS_K1 = 0.005  # pipeline vs K1 (tests/test_torch_render.py's)
OFF_POSE = ((0.0, 2.0, -3.0), 75.0, -12.0)
TIMED_FRAMES = 32
PLAIN_FRAMES = 3
KERNELS = ("render_fwd", "render_bwd")
FIT_STEPS = 5          # 9a: the CLI's fit on dingdong; 10a-10c: the sharded fit
FIT_TIMED_STEPS = 8    # 9a: the train step timed alone
RANK_TIMEOUT_S = 300   # 10b, 10c: each spawned process
SHARDED_FIT_RTOL = 1e-5  # 10b against 10a: losses and light colours, relative
DIFF_FIELDS = ("coefs", "colors", "reflection", "light_p", "light_color", "bg_color",
               "tan_half_fov")


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
    from tpu_ray_tracer_torch.kernel_bench import timed_ms
    from tpu_ray_tracer_torch.parity import (PARITY_GATES, bad_pixel_fraction,
                                             gradient_group_errors)
    from tpu_ray_tracer_torch.render import _build, bounds
    from tpu_ray_tracer_torch.render.bwd_kernel import render_bwd, render_bwd_plain
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
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        lib_paths = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, lib_path in lib_paths.items():
        _build.load(name)
        log(f"[build] {name} -> {lib_path}")
        for line in (lib_path.parent / "ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")

    def load(name):
        return ttt.load_from_file(os.path.join(REPO, "scenes", name + ".yml"))

    def golden(name):
        return np.load(os.path.join(REPO, "bench_goldens", name + ".npz"))["image"]

    def camera(position=(0.0, 0.0, 0.0), yaw=90.0, pitch=0.0):
        return ttt.Camera(position=torch.tensor(position, dtype=torch.float32, device=dev),
                          yaw_deg=torch.tensor(yaw, dtype=torch.float32, device=dev),
                          pitch_deg=torch.tensor(pitch, dtype=torch.float32, device=dev))

    # --- 3. main path: dingdong 1280x720, reference pose ---
    def zero_counts():
        render_fwd.launches = render_fwd.launches_save_aux = render_bwd.launches = 0
        for counts in (render_fwd.launches_by_variant, render_bwd.launches_by_placement):
            for key in counts:
                counts[key] = 0

    ding = load("dingdong")
    if ding.coefs.device.type != "cuda":
        raise RuntimeError(f"main path: the loader put the scene on {ding.coefs.device}")
    zero_counts()
    image = ttt.render_image_kernel(ding)
    torch.cuda.synchronize()
    main_launches = render_fwd.launches
    main_variants = {k: v for k, v in render_fwd.launches_by_variant.items() if v}
    if main_launches < 1 or main_variants != {"main": main_launches}:
        raise RuntimeError(f"main path: render_fwd launches {main_launches}, by "
                           f"instantiation {main_variants}; expected the main one")
    image = image.cpu().numpy()
    if image.shape != (720, 1280, 3) or not np.isfinite(image).all():
        raise RuntimeError(f"main path: bad frame shape {image.shape} or non-finite values")
    frac = bad_pixel_fraction(image, golden("dingdong"))
    log(f"[main] dingdong 1280x720 via render_image_kernel: launches={main_launches} "
        f"{main_variants} "
        f"bad-px vs golden {frac:.6f} (gate {PARITY_GATES['dingdong']})")
    if frac > PARITY_GATES["dingdong"]:
        raise RuntimeError("main path: dingdong over its parity gate")

    # --- 4. parity against the goldens, all scenes at full size ---
    scenes = {name: load(name) for name in SCENES}
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
    cases = [(name, camera(), 3) for name in SCENES]
    cases += [("dingdong@off", camera(*OFF_POSE), 3), ("dingdong@polish2", camera(), 2)]
    worst_frac, worst_abs = 0.0, 0.0
    zero_counts()
    for label, cam, polish in cases:
        scene = scenes[label.split("@")[0]]
        tables, kw = pack_frame(scene, cam, 0, scene.height, polish_iters=polish)
        k_img = render_fwd(*tables, **kw).cpu().numpy()
        p_img = render_fwd_plain(*tables, **kw).cpu().numpy()
        frac = bad_pixel_fraction(k_img, p_img)
        max_abs = float(np.abs(k_img - p_img).max())
        worst_frac, worst_abs = max(worst_frac, frac), max(worst_abs, max_abs)
        log(f"[vs-plain] {label}: bad-px {frac:.6f} max|diff| {max_abs:.6f}")
        if frac > MAX_BAD_VS_PLAIN:
            raise RuntimeError(f"kernel vs plain {label}: {frac} > {MAX_BAD_VS_PLAIN}")
    log(f"[vs-plain] launches by instantiation {render_fwd.launches_by_variant}")
    if not all(render_fwd.launches_by_variant.values()):
        raise RuntimeError("kernel vs plain: an instantiation of render_fwd never ran")

    # --- 6. timing (dingdong 1280x720, the JAX bench's yaw sweep) ---
    n_px = ding.width * ding.height
    yaws = (90.0 + 1e-3 * torch.arange(TIMED_FRAMES, dtype=torch.float32)).tolist()
    cams = [camera(yaw=y) for y in yaws]
    frames = [pack_frame(ding, c, 0, ding.height) for c in cams]
    for tables, kw in frames[:2]:  # warm-up
        render_fwd(*tables, **kw)
        render_fwd_plain(*tables, **kw)
    kernel_ms = timed_ms(lambda k: render_fwd(*frames[k][0], **frames[k][1]), TIMED_FRAMES,
                         device_only=True)
    call_ms = timed_ms(lambda k: ttt.render_image_kernel(ding, cams[k]), TIMED_FRAMES)
    plain_ms = timed_ms(lambda k: render_fwd_plain(*frames[k][0], **frames[k][1]),
                        PLAIN_FRAMES)
    for what, ms in (("kernel", kernel_ms), ("render_image_kernel call", call_ms),
                     ("plain version", plain_ms)):
        log(f"[time] dingdong 1280x720 {what}: {ms:.4f} ms/frame "
            f"{n_px / ms / 1e3:.2f} Mrays/s ({smi})")
    for name, scene in scenes.items():
        tables, kw = pack_frame(scene, camera(), 0, scene.height)
        aux = render_fwd(*tables, **kw, save_aux=True)[1:]
        work = bounds.fwd_work(tables, kw, aux)
        bound, bound_by = bounds.bound_ms(work["ops"], work["bytes"])
        ms = timed_ms(lambda k: render_fwd(*tables, **kw), TIMED_FRAMES, device_only=True)
        log(f"[time] kernel {name} {scene.width}x{scene.height}: {ms:.4f} ms/frame "
            f"{scene.width * scene.height / ms / 1e3:.2f} Mrays/s, bound {bound:.4f} ms "
            f"({bound_by}, {work['ops'] / (scene.width * scene.height):.0f} ops/px), "
            f"share {bound / ms:.3f}, hit share {float((aux[1][0] >= 0).float().mean()):.4f} "
            f"({smi})")
    # --- 7a. the main path with a gradient ---
    def grad_leaves(scene, cam):
        """The scene and camera with every differentiable tensor a leaf."""
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in DIFF_FIELDS}
        cam_leaves = {f: getattr(cam, f).detach().clone().requires_grad_()
                      for f in ("position", "yaw_deg", "pitch_deg")}
        return (dataclasses.replace(scene, **leaves), ttt.Camera(**cam_leaves),
                {**leaves, **cam_leaves})

    w = torch.linspace(0.1, 1.0, ding.height * ding.width * 3, device=dev).reshape(
        ding.height, ding.width, 3)
    g_scene, g_cam, leaves = grad_leaves(ding, camera(pitch=5.0))
    zero_counts()
    (w * ttt.render_image_kernel(g_scene, g_cam)).sum().backward()
    torch.cuda.synchronize()
    grad_launches = {"render_fwd": render_fwd.launches, "render_bwd": render_bwd.launches}
    grad_detail = {k: v for k, v in {**render_fwd.launches_by_variant,
                                     **render_bwd.launches_by_placement}.items() if v}
    log(f"[grad] dingdong 1280x720 loss.backward(): launches {grad_launches} {grad_detail}")
    if grad_launches != {"render_fwd": 1, "render_bwd": 1}:
        raise RuntimeError(f"grad path: expected one launch of each kernel, got {grad_launches}")
    for name, leaf in leaves.items():
        gmax = float(leaf.grad.abs().max())
        log(f"[grad]   {name}: max|grad| {gmax:.6g}")
        if not torch.isfinite(leaf.grad).all():
            raise RuntimeError(f"grad path: non-finite gradient for {name}")
        if gmax == 0.0 and name != "reflection":
            raise RuntimeError(f"grad path: zero gradient for {name}")

    # --- 7b. kernel against plain backward on the same (kernel) aux ---
    def bwd_case(scene, cam):
        tables, kw = pack_frame(scene, cam, 0, scene.height)
        _, *aux = render_fwd(*tables, **kw, save_aux=True)
        grad = torch.linspace(0.1, 1.0, scene.height * scene.width * 3, device=dev).reshape(
            scene.height, scene.width, 3)
        args = (tables[0], tables[2], tables[3], tables[4], tables[7], grad, *aux)
        bkw = dict(width=kw["width"], height=kw["height"], rows=kw["rows"],
                   n_lights=tables[4].shape[0], bounces=kw["bounces"])
        return args, bkw, (tables, kw, aux)

    bwd_worst_abs = bwd_worst_rel = 0.0
    for name in ("dingdong", "reflection_test", "20spheres"):
        scene = scenes[name]
        args, bkw, _ = bwd_case(scene, camera(pitch=5.0))
        k_vec = render_bwd(*args, **bkw)
        p_vec = render_bwd_plain(*args, **bkw)
        if not torch.isfinite(k_vec).all():
            raise RuntimeError(f"bwd vs plain {name}: non-finite kernel gradient")
        bwd_worst_abs = max(bwd_worst_abs, float((k_vec - p_vec).abs().max()))
        report = []
        errors = gradient_group_errors(k_vec, p_vec, args[0].shape[0], bkw["n_lights"])
        for group, (rel, tol) in errors.items():
            report.append(f"{group} {rel:.2e}")
            bwd_worst_rel = max(bwd_worst_rel, rel)
            if rel >= tol:
                raise RuntimeError(f"bwd vs plain {name} {group}: relerr {rel} >= {tol}")
        log(f"[bwd-vs-plain] {name} {scene.width}x{scene.height} bounces={bkw['bounces']}: "
            + ", ".join(report))

        # --- 7c. determinism ---
        if not torch.equal(render_bwd(*args, **bkw), k_vec):
            raise RuntimeError(f"bwd {name}: a second call gave other bits")
    grads_first = {n: leaf.grad.clone() for n, leaf in leaves.items()}
    for leaf in leaves.values():
        leaf.grad = None
    (w * ttt.render_image_kernel(g_scene, g_cam)).sum().backward()
    if any(not torch.equal(leaf.grad, grads_first[n]) for n, leaf in leaves.items()):
        raise RuntimeError("grad path: a second backward gave other bits")
    log("[determinism] render_bwd on 3 scenes and the whole backward: bitwise equal on rerun")

    # --- 7d. three fitting steps ---
    target = ttt.render_image_kernel(ding)
    colors = (ding.colors * 0.9).requires_grad_()
    bg = (ding.bg_color * 0.9).requires_grad_()
    fit_scene = dataclasses.replace(ding, colors=colors, bg_color=bg)
    opt = torch.optim.Adam([colors, bg], lr=1e-2)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = ((ttt.render_image_kernel(fit_scene) - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    with torch.no_grad():
        losses.append(float(((ttt.render_image_kernel(fit_scene) - target) ** 2).mean()))
    log(f"[fit] Adam lr 1e-2 on colors + bg_color, dingdong 1280x720: losses {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise RuntimeError(f"fit: the loss did not fall at every step: {losses}")

    # --- 7e. timing of the differentiable path ---
    aux_frames = [render_fwd(*t, **kw, save_aux=True)[1:] for t, kw in frames]
    grad_img = w.contiguous()

    def bwd_args(k):
        tables, kw = frames[k]
        return ((tables[0], tables[2], tables[3], tables[4], tables[7], grad_img,
                 *aux_frames[k]),
                dict(width=kw["width"], height=kw["height"], rows=kw["rows"],
                     n_lights=tables[4].shape[0], bounces=kw["bounces"]))

    # a fitting loop's frame: leaves made once, gradients accumulating
    t_scene, _, _ = grad_leaves(ding, cams[0])
    t_cams = [grad_leaves(ding, c)[1] for c in cams]

    def fwd_bwd(k):
        (w * ttt.render_image_kernel(t_scene, t_cams[k])).sum().backward()

    render_bwd(*bwd_args(0)[0], **bwd_args(0)[1])  # warm-up
    render_bwd_plain(*bwd_args(0)[0], **bwd_args(0)[1])
    fwd_bwd(0)
    aux_ms = timed_ms(lambda k: render_fwd(*frames[k][0], **frames[k][1], save_aux=True),
                      TIMED_FRAMES, device_only=True)
    bwd_ms = timed_ms(lambda k: render_bwd(*bwd_args(k)[0], **bwd_args(k)[1]), TIMED_FRAMES,
                      device_only=True)
    fwd_bwd_ms = timed_ms(fwd_bwd, TIMED_FRAMES)
    bwd_plain_ms = timed_ms(lambda k: render_bwd_plain(*bwd_args(k)[0], **bwd_args(k)[1]), 1)
    for what, ms in (("render_fwd(save_aux=True) kernel", aux_ms),
                     ("render_bwd kernel", bwd_ms),
                     ("fwd+bwd call (render_image_kernel + backward)", fwd_bwd_ms),
                     ("render_bwd_plain", bwd_plain_ms)):
        log(f"[time] dingdong 1280x720 {what}: {ms:.4f} ms/frame "
            f"{n_px / ms / 1e3:.2f} Mrays/s ({smi})")

    # --- bounds of the timed dingdong frames, from each frame's own aux ---
    works = [bounds.fwd_work(t, kw, a) for (t, kw), a in zip(frames, aux_frames)]
    fwd_ops = sum(wk["ops"] for wk in works) / len(works)
    fwd_bound, fwd_bound_by = bounds.bound_ms(fwd_ops, works[0]["bytes"])
    aux_bound, _ = bounds.bound_ms(fwd_ops, works[0]["bytes_save_aux"])
    bwd_works = [bounds.bwd_work(t, kw, a) for (t, kw), a in zip(frames, aux_frames)]
    bwd_ops = sum(wk["ops"] for wk in bwd_works) / len(bwd_works)
    bwd_bound, bwd_bound_by = bounds.bound_ms(bwd_ops, bwd_works[0]["bytes"])
    hit_share = float((aux_frames[0][1][0] >= 0).float().mean())
    log(f"[bound] dingdong 1280x720 hit share {hit_share:.4f} (stage 0 of frame 0)")
    for what, ms, bound, by, ops in (
            ("render_fwd", kernel_ms, fwd_bound, fwd_bound_by, fwd_ops),
            ("render_fwd(save_aux=True)", aux_ms, aux_bound, fwd_bound_by, fwd_ops),
            ("render_bwd", bwd_ms, bwd_bound, bwd_bound_by, bwd_ops)):
        log(f"[bound] dingdong 1280x720 {what}: {ops / n_px:.0f} ops/px, bound {bound:.4f} ms "
            f"({by}), time {ms:.4f} ms, share {bound / ms:.3f} ({smi})")
    for name in ("20spheres", "reflection_test"):
        scene = scenes[name]
        args, bkw, frame = bwd_case(scene, camera())
        ms = timed_ms(lambda k: render_bwd(*args, **bkw), TIMED_FRAMES, device_only=True)
        wk = bounds.bwd_work(*frame)
        bound, by = bounds.bound_ms(wk["ops"], wk["bytes"])
        log(f"[bound] {name} {scene.width}x{scene.height} render_bwd: {ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}, {wk['ops'] / (scene.width * scene.height):.0f} ops/px), "
            f"share {bound / ms:.3f}, hit share "
            f"{float((frame[2][1][0] >= 0).float().mean()):.4f} ({smi})")
    # --- 8a. the command line, in-process ---
    from tpu_ray_tracer_torch import cli
    from tpu_ray_tracer_torch.models import light as tlight
    from tpu_ray_tracer_torch.models import surface as tsurface
    from tpu_ray_tracer_torch.models.scene import Object

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    ding_yml = os.path.join(REPO, "scenes", "dingdong.yml")
    cli_npy = os.path.join(out_dir, "dingdong_cli.npy")
    zero_counts()
    rc = cli.main(["render", ding_yml, "--backend", "kernel", "--check", "-o", cli_npy])
    torch.cuda.synchronize()
    cli_launches = render_fwd.launches
    cli_variants = {k: v for k, v in render_fwd.launches_by_variant.items() if v}
    if rc != 0 or cli_launches != 1 or cli_variants != {"main": 1}:
        raise RuntimeError(f"cli render: rc {rc}, render_fwd launches {cli_variants}; "
                           "expected one of the main instantiation")
    frac = bad_pixel_fraction(np.load(cli_npy), golden("dingdong"))
    log(f"[cli] render dingdong --backend kernel: launches {cli_variants}, bad-px vs golden "
        f"{frac:.6f} (gate {PARITY_GATES['dingdong']})")
    if frac > PARITY_GATES["dingdong"]:
        raise RuntimeError("cli render: dingdong over its parity gate")
    buf = io.StringIO()
    before = render_fwd.launches
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", ding_yml, "--frames", str(TIMED_FRAMES)])
    torch.cuda.synchronize()
    for line in buf.getvalue().splitlines():
        log(f"[cli] {line}")
    fps = re.search(r"^FPS: \d+\.\d{4}, last render time: (\d+\.\d{4}) ms$", buf.getvalue(),
                    re.M)
    if (rc != 0 or fps is None or "backend kernel" not in buf.getvalue()
            or render_fwd.launches - before != TIMED_FRAMES + 1):
        raise RuntimeError(f"cli bench: rc {rc}, {render_fwd.launches - before} launches, "
                           "expected the kernel backend's FPS line")
    log(f"[cli] bench: {render_fwd.launches - before} render_fwd launches (1 warm-up + "
        f"{TIMED_FRAMES}) ({smi})")

    # --- 8b. the plain pipeline on the card against the goldens and K1 ---
    def peak_of(fn):
        """fn()'s result and the peak device memory (GiB) while it ran."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() / 2**30

    pipeline_peaks = {}
    for name, scene in scenes.items():
        with torch.no_grad():
            img, peak = peak_of(lambda: ttt.render_image(scene).cpu().numpy())
            k1 = ttt.render_image_kernel(scene).cpu().numpy()
        pipeline_peaks[name] = peak
        if img.shape != (scene.height, scene.width, 3) or not np.isfinite(img).all():
            raise RuntimeError(f"pipeline {name}: bad frame")
        frac_g, frac_k = bad_pixel_fraction(img, golden(name)), bad_pixel_fraction(img, k1)
        log(f"[pipeline] FAST {name} {scene.width}x{scene.height}: bad-px vs golden "
            f"{frac_g:.6f} (limit {MAX_BAD_PIPELINE}), vs K1 {frac_k:.6f} (limit "
            f"{MAX_BAD_PIPELINE_VS_K1}), peak {peak:.3f} GiB")
        if frac_g > MAX_BAD_PIPELINE or frac_k > MAX_BAD_PIPELINE_VS_K1:
            raise RuntimeError(f"pipeline {name}: over its limit")
    for name in ("dingdong", "reflection_test"):
        scene = scenes[name]
        with torch.no_grad():
            img, peak = peak_of(
                lambda: ttt.render_image(scene, config=ttt.GOLDEN_CONFIG).cpu().numpy())
        frac_g = bad_pixel_fraction(img, golden(name))
        pipeline_peaks[f"{name} GOLDEN"] = peak
        log(f"[pipeline] GOLDEN f64 {name} {scene.width}x{scene.height}: bad-px vs golden "
            f"{frac_g:.6f} (limit {MAX_BAD_PIPELINE}), peak {peak:.3f} GiB")
        if not np.isfinite(img).all() or frac_g > MAX_BAD_PIPELINE:
            raise RuntimeError(f"pipeline GOLDEN {name}: over its limit")

    # --- 8c. the gradient fallback (> 31 lights, no object) ---
    fan = [Object(tsurface.sphere((0.0, 0.0, 6.0), 2.0), 0.0, np.float32([0.8, 0.3, 0.2])),
           Object(tsurface.plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0)), 0.0,
                  np.float32([0.2, 0.6, 0.9]))]
    fan_lights = [tlight.directional(
        0.08, (np.cos(2 * np.pi * i / 33) * 0.5, -1.0, np.sin(2 * np.pi * i / 33) * 0.5 + 0.3),
        (1.0, 1.0 - 0.5 * (i % 3) / 2.0, 0.5 + 0.5 * (i % 2))) for i in range(33)]
    many = ttt.build_scene(640, 480, 60.0, fan, fan_lights, bg_color=(0.1, 0.1, 0.1))
    empty = ttt.build_scene(640, 480, 60.0, [], fan_lights[:1], bg_color=(0.3, 0.6, 0.9))
    fallback_config = ttt.RenderConfig("float32", 3, 0, chunk_px=None)

    def fallback_grads(scene, fields, fallback=True):
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in fields}
        s = dataclasses.replace(scene, **leaves)
        image = (ttt.render_image_kernel(s) if fallback
                 else ttt.render_image(s, None, fallback_config))
        image.sum().backward()
        # a leaf the frame does not read (a light, with no object) gets no
        # gradient from autograd: zero
        return {f: torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
                for f, leaf in leaves.items()}

    fallback_launches = 0
    for label, scene, fields in (("33 lights", many, ("light_color", "coefs")),
                                 ("0 objects", empty, ("light_color", "bg_color"))):
        zero_counts()
        got = fallback_grads(scene, fields)
        torch.cuda.synchronize()
        launches = {"render_fwd": render_fwd.launches, "render_bwd": render_bwd.launches}
        variants = {k: v for k, v in render_fwd.launches_by_variant.items() if v}
        fallback_launches += render_fwd.launches
        ref = fallback_grads(scene, fields, fallback=False)
        log(f"[fallback] {label} 640x480 loss.backward(): launches {launches} {variants}")
        if launches != {"render_fwd": 1, "render_bwd": 0} or variants != {"main": 1}:
            raise RuntimeError(f"fallback {label}: expected one render_fwd (main), no render_bwd")
        for f in fields:
            g, r = got[f], ref[f]
            rtol = 1e-4 if f == "coefs" else 1e-5
            atol = 1e-6 * max(1.0, float(r.abs().max())) if f == "coefs" else 1e-7
            err = float((g - r).abs().max())
            log(f"[fallback]   {f}: max|grad| {float(g.abs().max()):.6g}, max|diff| vs the "
                f"pipeline's autograd {err:.3g}")
            if not torch.isfinite(g).all() or not torch.allclose(g, r, rtol=rtol, atol=atol):
                raise RuntimeError(f"fallback {label} {f}: gradient differs")
        if label == "0 objects" and bool(got["light_color"].any()):
            raise RuntimeError("fallback 0 objects: nonzero light gradient")
        if label == "33 lights" and not bool(got["light_color"].any()):
            raise RuntimeError("fallback 33 lights: zero light gradient")

    # --- 8d. the pipeline's gradient against K2's (dingdong 1280x720, pitch 5) ---
    from tpu_ray_tracer_torch.ops import camera as camera_ops
    from tpu_ray_tracer_torch.ops.poly import poly_gradient
    from tpu_ray_tracer_torch.render import pipeline

    pose = camera(pitch=5.0)
    # The pixels whose primary hit both forwards find alike: the same
    # object, t within 1e-4 relative, and the slope dF/dt = grad F . d that
    # the implicit-function backward divides by within 1e-4 relative. Near a
    # double root of dingdong's cubic the f32 root is ill-conditioned: the
    # two forwards' roots differ, and 1/slope amplifies it into the gradient.
    tables, kw = pack_frame(ding, pose, 0, ding.height)
    _, k_t, k_slot, _ = render_fwd(*tables, **kw, save_aux=True)
    k_t, k_slot = k_t[0].flatten(), k_slot[0].flatten().long()
    k_idx = torch.where(k_slot >= 0, tables[1].long()[k_slot.clamp(min=0)], -1)
    with torch.no_grad():
        s32 = ding.astype(torch.float32)
        rot, eye = camera_ops.camera_frame(pose)
        dirs = camera_ops.pixel_directions(rot, ding.width, ding.height, ding.aspect_ratio,
                                           s32.tan_half_fov).reshape(-1, 3)
        hit = pipeline.trace_and_shade(s32, eye.expand(dirs.shape), dirs, 3)
        p_t = ((hit.point - eye) * dirs).sum(-1)
        p_idx = torch.where(hit.hit, hit.idx, -1)
        sel = s32.coefs[p_idx.clamp(min=0)]
        p_slope = (poly_gradient(sel, hit.point) * dirs).sum(-1)
        k_slope = (poly_gradient(sel, eye + k_t[:, None] * dirs) * dirs).sum(-1)
    same = (p_idx == k_idx) & ((p_idx < 0) | (((p_t - k_t).abs() <= 1e-4 * k_t.abs())
                                             & ((p_slope - k_slope).abs()
                                                <= 1e-4 * k_slope.abs())))
    same = same.reshape(ding.height, ding.width, 1)
    n_diff = int((~same).sum())
    log(f"[pipeline-grad] primary hits: the pipeline and K1 differ (object, t beyond 1e-4 "
        f"or dF/dt beyond 1e-4 relative) on {n_diff} of {n_px} pixels")

    def grads_for(render, weights):
        g_scene, g_cam, g_leaves = grad_leaves(ding, pose)
        (weights * render(g_scene, g_cam)).sum().backward()
        return {n: torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
                for n, leaf in g_leaves.items() if n != "reflection"}

    def group_errors(got, ref):
        out = {}
        for n in got:
            scale = max(float(ref[n].abs().max()), 1e-6)
            out[n] = (float((got[n] - ref[n]).abs().max()) / scale,
                      2e-3 if float(ref[n].abs().max()) > 1.0 else 2e-2)
        return out

    pipe_render = lambda sc, c: ttt.render_image(sc, c)  # noqa: E731
    pipe_full = grads_for(pipe_render, w)
    if not all(torch.isfinite(g).all() for g in pipe_full.values()):
        raise RuntimeError("pipeline gradient: non-finite values")
    full_errors = group_errors(pipe_full, grads_first)
    same_errors = group_errors(grads_for(pipe_render, w * same),
                               grads_for(ttt.render_image_kernel, w * same))
    for n, (rel, tol) in full_errors.items():
        rel_same = same_errors[n][0]
        log(f"[pipeline-grad] {n}: relerr vs K2 {rel:.3e} over the frame"
            f"{' (over the limit: ROADMAP Queue 3)' if rel >= tol else ''}, {rel_same:.3e} "
            f"where both forwards hit alike (limit {tol:g})")
        if rel_same >= tol:
            raise RuntimeError(f"pipeline gradient {n}: relerr {rel_same} >= {tol} against K2 "
                               "where both forwards hit alike")

    # --- 8e. the pipeline's times and peak memory (dingdong 1280x720) ---
    pipe_frames = 8
    with torch.no_grad():
        ttt.render_image(ding, cams[0])
        fast_ms, fast_peak = peak_of(lambda: timed_ms(
            lambda k: ttt.render_image(ding, cams[k]), pipe_frames))
        golden_ms, golden_peak = peak_of(lambda: timed_ms(
            lambda k: ttt.render_image(ding, cams[k], ttt.GOLDEN_CONFIG), pipe_frames))

    def pipe_fwd_bwd(k):
        (w * ttt.render_image(t_scene, t_cams[k])).sum().backward()

    pipe_fwd_bwd(0)
    fwd_bwd_pipe_ms, fwd_bwd_peak = peak_of(lambda: timed_ms(pipe_fwd_bwd, pipe_frames))
    fb_leaf = many.light_color.detach().clone().requires_grad_()
    fb_scene = dataclasses.replace(many, light_color=fb_leaf, coefs=many.coefs.clone()
                                   .requires_grad_())
    fb_cams = [camera(yaw=y) for y in yaws[:pipe_frames]]

    def fallback_step(k):
        ttt.render_image_kernel(fb_scene, fb_cams[k]).sum().backward()

    fallback_step(0)
    fallback_ms, fallback_peak = peak_of(lambda: timed_ms(fallback_step, pipe_frames))
    for what, ms, peak, px in (
            ("dingdong 1280x720 pipeline FAST (f32) forward", fast_ms, fast_peak, n_px),
            ("dingdong 1280x720 pipeline GOLDEN (f64) forward", golden_ms, golden_peak, n_px),
            ("dingdong 1280x720 pipeline fwd+bwd", fwd_bwd_pipe_ms, fwd_bwd_peak, n_px),
            ("33-light 640x480 fallback fwd+bwd (K1 + pipeline backward)", fallback_ms,
             fallback_peak, 640 * 480)):
        log(f"[time] {what}: {ms:.4f} ms/frame {px / ms / 1e3:.2f} Mrays/s, peak "
            f"{peak:.3f} GiB ({smi})")
    log(f"[memory] FAST/GOLDEN one-frame peaks (GiB): "
        + ", ".join(f"{k} {v:.3f}" for k, v in pipeline_peaks.items()) + f" ({smi})")

    # --- 9a. the fit's main path: the CLI's fit on dingdong 1280x720 ---
    from tpu_ray_tracer_torch.diff import inverse
    from tpu_ray_tracer_torch.diff.soft import render_rays_soft

    t_fit = time.perf_counter()
    buf = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit", ding_yml, "--steps", str(FIT_STEPS)])
    torch.cuda.synchronize()
    fit_launches = {"render_fwd": render_fwd.launches,
                    "render_fwd_save_aux": render_fwd.launches_save_aux,
                    "render_bwd": render_bwd.launches}
    fit_detail = {k: v for k, v in {**render_fwd.launches_by_variant,
                                    **render_bwd.launches_by_placement}.items() if v}
    for line in buf.getvalue().splitlines():
        log(f"[fit] {line}")
    summary = re.search(r"^loss: (\S+) -> (\S+) over (\d+) steps$", buf.getvalue(), re.M)
    logged = [float(x) for x in re.findall(r"^step \d+: loss (\S+)$", buf.getvalue(), re.M)]
    log(f"[fit] dingdong 1280x720 fit --steps {FIT_STEPS} (auto -> kernel): launches "
        f"{fit_launches} {fit_detail} (the target frame is the one render_fwd without aux)")
    if rc != 0 or summary is None or int(summary[3]) != FIT_STEPS:
        raise RuntimeError(f"fit: rc {rc}, no summary line for {FIT_STEPS} steps")
    if fit_launches != {"render_fwd": FIT_STEPS + 1, "render_fwd_save_aux": FIT_STEPS,
                        "render_bwd": FIT_STEPS}:
        raise RuntimeError(f"fit: expected {FIT_STEPS} launches of each kernel with aux and "
                           f"one target frame, got {fit_launches}")
    logged += [float(summary[1]), float(summary[2])]
    if not all(np.isfinite(logged)) or not float(summary[2]) < float(summary[1]):
        raise RuntimeError(f"fit: the loss did not fall or is not finite: {logged}")

    fit_config = ttt.RenderConfig("float32", polish_iters=2, chunk_px=None)

    def fit_case(scene, fields, backend, soft_tau=None):
        """A self-recovery problem as the CLI's fit builds it: the target at
        the reference pose, the optimized fields perturbed by 0.6."""
        with torch.no_grad():
            target = ttt.render_image_kernel(scene, camera(), polish_iters=2, bounces=0)
        problem = inverse.InverseProblem(
            scene_template=cli._perturb_scene(scene, fields, 0.6), config=fit_config,
            param_fields=tuple(fields), learning_rate=5e-2, backend=backend,
            soft_tau=soft_tau)
        return problem, target

    def fit_steps(problem, target, steps, params_out=None, group=None):
        """``steps`` train steps (row-sharded over ``group``; None is one
        process) -> (losses, ms of each step by CUDA events, peak device
        memory in GiB); the parameters reached go into ``params_out``."""
        params = inverse.extract_params(problem.scene_template.astype(torch.float32),
                                        problem.param_fields)
        if params_out is not None:
            params_out.update(params)
        optimizer = problem.optimizer(params)
        step = inverse.make_train_step(problem, group)
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(params, optimizer, camera(), target))
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return losses, times, torch.cuda.max_memory_allocated() / 2**30

    ding_problem, ding_target = fit_case(ding, ["light_color"], "kernel")
    losses, times, peak = fit_steps(ding_problem, ding_target, FIT_TIMED_STEPS)
    fit_step_ms = float(np.median(times[1:]))
    log(f"[time] dingdong 1280x720 kernel-route fit step (light_color): median "
        f"{fit_step_ms:.4f} ms over steps 2-{FIT_TIMED_STEPS} (all {', '.join(f'{t:.4f}' for t in times)}), "
        f"peak {peak:.3f} GiB; 7e's fwd+bwd call {fwd_bwd_ms:.4f} ms ({smi})")

    # --- 9b. the BASELINE inverse configuration: clebsch 800x600, both routes ---
    clebsch = scenes["clebsch"]
    baseline_steps = {}
    for label, backend, soft_tau, steps in (("hard, kernel route", "kernel", None, 5),
                                            ("soft tau 0.15, pipeline route", "torch", 0.15, 3)):
        problem, target = fit_case(clebsch, ["coefs", "light_color"], backend, soft_tau)
        loss_fn = inverse.make_loss_fn(problem)
        if loss_fn.use_kernel != (backend == "kernel"):
            raise RuntimeError(f"baseline fit {label}: wrong route")
        zero_counts()
        losses, times, peak = fit_steps(problem, target, steps)
        launches = (render_fwd.launches_save_aux, render_bwd.launches)
        baseline_steps[label] = float(np.median(times))
        log(f"[fit] clebsch 800x600 coefs+light_color, {label} ({loss_fn.block_rows} rows a "
            f"block): losses {losses}, step ms {', '.join(f'{t:.4f}' for t in times)}, peak "
            f"{peak:.3f} GiB, kernel launches (fwd with aux, bwd) {launches} ({smi})")
        want = (steps, steps) if backend == "kernel" else (0, 0)
        if launches != want or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"baseline fit {label}: launches {launches} (want {want}) or the "
                               f"loss did not fall: {losses}")

    # --- 9c. the soft render converges to the hard one at full size ---
    from tpu_ray_tracer_torch.ops import camera as camera_ops

    for name in ("clebsch", "quadratic"):
        scene = scenes[name].astype(torch.float32)
        hard_config = ttt.RenderConfig("float32", polish_iters=2, bounces=0, chunk_px=None)
        with torch.no_grad():
            hard = ttt.render_image(scene, camera(), hard_config)
            rot, eye = camera_ops.camera_frame(camera())
            rows = inverse.make_loss_fn(inverse.InverseProblem(
                scene, fit_config, soft_tau=1e-4)).block_rows
            soft = torch.cat([render_rays_soft(
                scene, eye.expand(d.shape), d, polish_iters=2, tau=1e-4)
                for d in (camera_ops.pixel_directions(rot, scene.width, scene.height,
                                                      scene.aspect_ratio, scene.tan_half_fov,
                                                      y0=y0, rows=min(rows, scene.height - y0))
                          for y0 in range(0, scene.height, rows))])
        frac = bad_pixel_fraction(soft.cpu().numpy(), hard.cpu().numpy())
        log(f"[soft] {name} {scene.width}x{scene.height} tau 1e-4 vs the hard pipeline frame: "
            f"{frac:.6f} of pixels apart by > 2/255 (limit 0.02)")
        if not torch.isfinite(soft).all() or frac >= 0.02:
            raise RuntimeError(f"soft {name}: {frac} of pixels apart")

    # --- 9d. checkpoint resume on the card ---
    ck = os.path.join(out_dir, "fit_checkpoint.npz")
    if os.path.exists(ck):
        os.remove(ck)
    quiet = dict(log_every=0, print_fn=lambda *a: None)
    whole, _ = inverse.fit(ding_problem, ding_target, camera(), steps=4, **quiet)
    inverse.fit(ding_problem, ding_target, camera(), steps=2, checkpoint_path=ck,
                checkpoint_every=2, **quiet)
    resumed, resumed_losses = inverse.fit(ding_problem, ding_target, camera(), steps=4,
                                          checkpoint_path=ck, checkpoint_every=2, **quiet)
    diffs = {k: float((whole[k] - resumed[k]).detach().abs().max()) for k in whole}
    log(f"[checkpoint] 4 steps against 2 + checkpoint + 2 resumed ({len(resumed_losses)} "
        f"steps run): max|diff| {diffs}")
    if len(resumed_losses) != 2 or any(v != 0.0 for v in diffs.values()):
        raise RuntimeError(f"checkpoint resume: params differ {diffs}")
    with np.load(ck) as data:
        kept = {k: data[k] for k in data.files if not k.startswith("opt/")}
    np.savez(ck, **kept)
    try:
        inverse.fit(ding_problem, ding_target, camera(), steps=4, checkpoint_path=ck, **quiet)
    except KeyError as exc:
        log(f"[checkpoint] without opt/... keys: raises KeyError {exc}")
    else:
        raise RuntimeError("checkpoint without optimizer state: resumed silently")
    log(f"[fit] phase 9 in {time.perf_counter() - t_fit:.1f} s")

    # --- 10a. the row-sharded path at world size 1 over NCCL, in process ---
    import datetime

    import torch.distributed as dist

    from tpu_ray_tracer_torch import native
    from tpu_ray_tracer_torch.parallel.sharding import make_mesh, render_image_sharded

    t_sharded = time.perf_counter()
    unsharded_params = {}
    unsharded_losses, unsharded_times, _ = fit_steps(ding_problem, ding_target, FIT_STEPS,
                                                     unsharded_params)
    store = os.path.join(out_dir, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    group = make_mesh().group
    zero_counts()
    with torch.no_grad():
        sharded_image = render_image_sharded(
            ding, camera(), ttt.RenderConfig(polish_iters=3, chunk_px=None),
            group=group).cpu().numpy()
    sharded_params = {}
    held = torch.cuda.memory_allocated() / 2**30
    sharded_losses, sharded_times, sharded_peak = fit_steps(ding_problem, ding_target, FIT_STEPS,
                                                            sharded_params, group)
    torch.cuda.synchronize()
    sharded_launches = {"render_fwd": render_fwd.launches,
                        "render_fwd_save_aux": render_fwd.launches_save_aux,
                        "render_bwd": render_bwd.launches}
    dist.destroy_process_group()
    log(f"[sharded] world 1 (NCCL) dingdong 1280x720: launches {sharded_launches}; frame "
        f"{'equals' if np.array_equal(sharded_image, image) else 'DIFFERS FROM'} phase 3's; "
        f"losses {sharded_losses} against {unsharded_losses} without a process group")
    log(f"[time] dingdong 1280x720 sharded fit step, world 1 (NCCL): "
        f"{', '.join(f'{t:.4f}' for t in sharded_times)} ms, peak {sharded_peak:.3f} GiB "
        f"({held:.3f} GiB held by the process before the steps); the same steps without a "
        f"process group just before: {', '.join(f'{t:.4f}' for t in unsharded_times)} ms "
        f"({smi})")
    if not np.array_equal(sharded_image, image):
        raise RuntimeError("sharded world 1: the frame differs from phase 3's")
    if sharded_losses != unsharded_losses or any(
            not torch.equal(sharded_params[k], unsharded_params[k]) for k in sharded_params):
        raise RuntimeError("sharded world 1: the fit differs from the one without a group")
    if sharded_launches != {"render_fwd": FIT_STEPS + 1, "render_fwd_save_aux": FIT_STEPS,
                            "render_bwd": FIT_STEPS}:
        raise RuntimeError(f"sharded world 1: launches {sharded_launches}")

    # --- 10b. two ranks on the one card (gloo over CUDA tensors) ---
    ranks = run_ranks(2, out_dir)
    stitched = np.load(os.path.join(out_dir, "sharded_frame.npy"))
    for r in ranks:
        log(f"[sharded] world 2 (gloo) rank {r['rank']}: launches {r['launches']}, losses "
            f"{r['losses']}, checkpoint writes {r['ckpt_writes']}; rows from {r['row0']}: K1 "
            f"vs plain bad-px {r['bad_px_vs_plain']:.6f} max|diff| "
            f"{r['max_abs_vs_plain']:.6f}, equal to the gathered frame's: "
            f"{r['rows_equal_frame']}")
        log(f"[time] dingdong 1280x720 sharded fit step, world 2 (gloo, one card) rank "
            f"{r['rank']}: {', '.join(f'{t:.4f}' for t in r['step_ms'])} ms, peak "
            f"{r['peak_gib']:.3f} GiB ({r['held_gib']:.3f} GiB held by the rank's process "
            f"before the steps) ({smi})")
    if not np.array_equal(stitched, image):
        raise RuntimeError("sharded world 2: the stitched frame differs from phase 3's")
    # Two ranks sum two half-frame gradients where one rank sums the frame:
    # the fit differs from 10a's by f32 rounding only. The loss is
    # all-reduced, so equal losses on both ranks cannot show a missing
    # gradient reduction; the parameters can: each rank must hold the same
    # light colours, and they must be 10a's.
    loss_err = max(abs(a - b) for a, b in zip(ranks[0]["losses"], sharded_losses))
    loss_scale = max(abs(x) for x in sharded_losses)
    world1_light = sharded_params["light_color"].detach().cpu().numpy()
    light_err = float(np.abs(np.asarray(ranks[0]["light_color"]) - world1_light).max()
                      / np.abs(world1_light).max())
    log(f"[sharded] world 2 against world 1: losses relerr {loss_err / loss_scale:.3e}, "
        f"light_color relerr {light_err:.3e} (limit {SHARDED_FIT_RTOL:g} each); ranks' "
        f"light_color {'equal' if ranks[0]['light_color'] == ranks[1]['light_color'] else 'DIFFER'}")
    want = {"render_fwd": FIT_STEPS + 2, "render_fwd_save_aux": FIT_STEPS,
            "render_bwd": FIT_STEPS}
    if (any(r["launches"] != want for r in ranks) or ranks[0]["ckpt_writes"] != FIT_STEPS
            or ranks[1]["ckpt_writes"] != 0 or ranks[0]["losses"] != ranks[1]["losses"]
            or ranks[0]["light_color"] != ranks[1]["light_color"]
            or not all(r["rows_equal_frame"] for r in ranks)
            or ranks[1]["bad_px_vs_plain"] > MAX_BAD_VS_PLAIN
            or loss_err / loss_scale >= SHARDED_FIT_RTOL or light_err >= SHARDED_FIT_RTOL
            or not ranks[0]["losses"][-1] < ranks[0]["losses"][0]):
        raise RuntimeError(f"sharded world 2: a check failed: {ranks}")

    # --- 10c. fit --distributed under torchrun ---
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "tpu_ray_tracer_torch.cli", "fit", ding_yml, "--steps", str(FIT_STEPS),
         "--distributed"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        log(f"[torchrun] {line}")
    summaries = re.findall(r"^loss: (\S+) -> (\S+) over (\d+) steps$", proc.stdout, re.M)
    if (proc.returncode != 0 or len(summaries) != 1 or int(summaries[0][2]) != FIT_STEPS
            or not float(summaries[0][1]) < float(summaries[0][0])):
        raise RuntimeError(f"fit --distributed: rc {proc.returncode}, summaries {summaries}\n"
                           f"{proc.stderr[-4000:]}")

    # --- 10d. the native scene loader onto the card ---
    for name, scene in scenes.items():
        nscene = native.load_from_file(os.path.join(REPO, "scenes", name + ".yml"))
        differ = [f for f in DIFF_FIELDS + ("light_is_spherical",)
                  if getattr(nscene, f).device.type != "cuda"
                  or not torch.equal(getattr(nscene, f), getattr(scene, f))]
        if differ or (nscene.width, nscene.height) != (scene.width, scene.height):
            raise RuntimeError(f"native loader {name}: tables differ from the Python loader's "
                               f"({differ})")
    native_image = ttt.render_image_kernel(
        native.load_from_file(os.path.join(REPO, "scenes", "dingdong.yml"))).cpu().numpy()
    if not np.array_equal(native_image, image):
        raise RuntimeError("native loader: the dingdong frame differs from phase 3's")
    log(f"[native] {len(scenes)} scenes on the card equal to the Python loader's tables; "
        f"dingdong frame equal to phase 3's ({native.build_library()})")
    log(f"[sharded] phase 10 in {time.perf_counter() - t_sharded:.1f} s")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # the sharded paths' launches: 10a in this process, 10b in both ranks
    sharded_fwd = sharded_launches["render_fwd"] + sum(r["launches"]["render_fwd"] for r in ranks)
    sharded_bwd = sharded_launches["render_bwd"] + sum(r["launches"]["render_bwd"] for r in ranks)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/render_fwd.cu",
        "replaces": "tpu_ray_tracer/render/pallas_backend.py:978",
        "launches": (main_launches + grad_launches["render_fwd"] + cli_launches
                     + fallback_launches + fit_launches["render_fwd"] + sharded_fwd),
        "launches_by_path": {"forward": main_launches, "gradient": grad_launches["render_fwd"],
                             "cli": cli_launches, "fallback": fallback_launches,
                             "fit": fit_launches["render_fwd"], "sharded": sharded_fwd},
        "max_abs_err": worst_abs,
        "worst_bad_px_vs_plain": worst_frac,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "library_ms": None,
        "share_of_bound": fwd_bound / kernel_ms,
        "ops_per_px": fwd_ops / n_px,
        "ms_save_aux": aux_ms,
        "bound_ms_save_aux": aux_bound,
    }, {
        "name": "render_bwd",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/render_bwd.cu",
        "replaces": "tpu_ray_tracer/render/pallas_backend.py:1613",
        "launches": grad_launches["render_bwd"] + fit_launches["render_bwd"] + sharded_bwd,
        "launches_by_path": {"gradient": grad_launches["render_bwd"],
                             "fit": fit_launches["render_bwd"], "sharded": sharded_bwd},
        "max_abs_err": bwd_worst_abs,
        "worst_group_relerr_vs_plain": bwd_worst_rel,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": None,
        "share_of_bound": bwd_bound / bwd_ms,
        "ops_per_px": bwd_ops / n_px,
        "fwd_bwd_call_ms": fwd_bwd_ms,
        "fit_step_ms": fit_step_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def sharded_rank(rank: int, world: int, store: str, out_dir: str) -> int:
    """10b's body in one spawned rank: both ranks share card 0 over gloo.
    Writes rank<r>.json (and rank 0 the stitched frame) into ``out_dir``."""
    import datetime

    import torch

    sys.path.insert(0, REPO)
    import numpy as np

    import tpu_ray_tracer_torch as ttt
    from tpu_ray_tracer_torch import cli
    from tpu_ray_tracer_torch.diff import inverse
    from tpu_ray_tracer_torch.parallel.multihost import initialize_distributed
    from tpu_ray_tracer_torch.parallel.sharding import make_mesh, render_image_sharded
    from tpu_ray_tracer_torch.parity import bad_pixel_fraction
    from tpu_ray_tracer_torch.render.bwd_kernel import render_bwd
    from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd, render_fwd_plain
    from tpu_ray_tracer_torch.render.kernel_backend import pack_frame

    dev = torch.device("cuda", 0)
    initialize_distributed(backend="gloo", device=dev, init_method=f"file://{store}",
                           world_size=world, rank=rank, timeout=datetime.timedelta(seconds=120))
    group = make_mesh(dev).group
    ding = ttt.load_from_file(os.path.join(REPO, "scenes", "dingdong.yml"))
    cam = ttt.Camera.initial(torch.float32, dev)
    fit_config = ttt.RenderConfig("float32", polish_iters=2, chunk_px=None)
    problem = inverse.InverseProblem(
        scene_template=cli._perturb_scene(ding, ["light_color"], 0.6), config=fit_config,
        param_fields=("light_color",), learning_rate=5e-2, backend="kernel")
    ck = os.path.join(out_dir, "sharded_checkpoint.npz")
    writes = []
    save = inverse.save_checkpoint

    def spy(path, params, optimizer, step):
        writes.append(step)
        save(path, params, optimizer, step)

    # the main path: the counts set to 0 just before, read just after
    render_fwd.launches = render_fwd.launches_save_aux = render_bwd.launches = 0
    with torch.no_grad():
        frame = render_image_sharded(ding, cam, ttt.RenderConfig(polish_iters=3, chunk_px=None),
                                     group=group)
        target = render_image_sharded(ding, cam, fit_config, group=group)
    inverse.save_checkpoint = spy
    try:
        params, losses = inverse.fit(problem, target, cam, steps=FIT_STEPS, log_every=0,
                                     checkpoint_path=ck, checkpoint_every=1, group=group)
    finally:
        inverse.save_checkpoint = save
    torch.cuda.synchronize()
    launches = {"render_fwd": render_fwd.launches,
                "render_fwd_save_aux": render_fwd.launches_save_aux,
                "render_bwd": render_bwd.launches}
    # each sharded step alone, by CUDA events, with its peak memory
    params_t = inverse.extract_params(problem.scene_template.astype(torch.float32),
                                      problem.param_fields)
    optimizer = problem.optimizer(params_t)
    step = inverse.make_train_step(problem, group)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    for _ in range(FIT_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(params_t, optimizer, cam, target)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # this rank's rows through K1 against the plain version, same tables
    # (comparison launches, after the counts were read)
    rows = ding.height // world
    tables, kw = pack_frame(ding, cam, rank * rows, rows)
    k_rows = render_fwd(*tables, **kw)
    p_rows = render_fwd_plain(*tables, **kw)
    result = {
        "rank": rank, "launches": launches, "losses": losses, "ckpt_writes": len(writes),
        "step_ms": times, "peak_gib": peak, "held_gib": held, "row0": rank * rows,
        "rows_equal_frame": bool(torch.equal(k_rows, frame[rank * rows:(rank + 1) * rows])),
        "bad_px_vs_plain": bad_pixel_fraction(k_rows.cpu().numpy(), p_rows.cpu().numpy()),
        "max_abs_vs_plain": float((k_rows - p_rows).abs().max()),
        "light_color": params["light_color"].detach().cpu().tolist(),
    }
    if rank == 0:
        np.save(os.path.join(out_dir, "sharded_frame.npy"), frame.cpu().numpy())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()
    return 0


def run_ranks(world: int, out_dir: str) -> list:
    """Spawn ``world`` ranks of ``sharded_rank``, each bounded by
    RANK_TIMEOUT_S; returns their results. A failed or late rank fails."""
    store = os.path.join(out_dir, "gloo_store")
    for stale in [store] + [os.path.join(out_dir, f"rank{r}.json") for r in range(world)]:
        if os.path.exists(stale):
            os.remove(stale)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(world), "--store", store, "--out", out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"sharded rank {r} failed (rc {p.returncode}):\n{out[-4000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        opts = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        sys.exit(sharded_rank(int(opts["--rank"]), int(opts["--world"]), opts["--store"],
                              opts["--out"]))
    sys.exit(main())
