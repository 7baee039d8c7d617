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
   20spheres and reflection_test beside its bound.

The last lines are the card's name and power limit, a {"kernels": [...]}
line (each kernel's launches on the main path, its time, its plain
version's, its bound and share of the bound on dingdong 1280x720; no single
PyTorch call computes either function, so ``library_ms`` is null), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = ("dingdong", "monkey_saddle", "20spheres", "reflection_test",
          "quadratic", "cayley", "clebsch", "cubic")
MAX_BAD_VS_PLAIN = 1e-3   # per frame, kernel vs its plain version
OFF_POSE = ((0.0, 2.0, -3.0), 75.0, -12.0)
TIMED_FRAMES = 32
PLAIN_FRAMES = 3
KERNELS = ("render_fwd", "render_bwd")
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
        render_fwd.launches = render_bwd.launches = 0
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
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/render_fwd.cu",
        "replaces": "tpu_ray_tracer/render/pallas_backend.py:978",
        "launches": main_launches + grad_launches["render_fwd"],
        "launches_by_path": {"forward": main_launches, "gradient": grad_launches["render_fwd"]},
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
        "launches": grad_launches["render_bwd"],
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
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
