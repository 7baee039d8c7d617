#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ray_tracer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. device: require CUDA; print the card's name and power limit, torch,
   CUDA and nvcc versions;
2. build: compile every kernel of the path from csrc/ (render_fwd.cu,
   render_bwd.cu, pack.cu, select_rows.cu, solve_roots.cu), one nvcc per
   source, all started together (timed as set-up);
3. main path: load scenes/dingdong.yml (onto the card, the loader's
   default) and render it at 1280x720 from the reference pose through
   ``render_image_kernel``, with every launch count set to 0 just before and
   read just after (the forward's main instantiation must have run, and one
   pack_frame launch with each render_fwd launch, on this path and on every
   later one); check the frame;
4. parity: all 8 bundled scenes at full size through ``render_image_kernel``
   against bench_goldens/<scene>.npz, each within its gate
   (tpu_ray_tracer_torch.parity.PARITY_GATES, the JAX bench's gates);
5. kernel vs plain: the kernel against ``render_fwd_plain`` on the same
   CUDA tables, every scene at the reference pose, dingdong at an off pose
   and dingdong with polish 2 (the generic instantiation; the others run the
   main ones, reflection_test the one with a chain), at most 1e-3 of the
   pixels differing by more than 2/255 per frame;
5b. the packing kernels against their plain versions on the card:
   ``pack_tables`` against ``pack_tables_plain`` on all 8 scenes at 3 poses
   (f32 cameras; f64 at one) and row0 0 and half the height (the second of
   two row-sharded ranks): every table bit for bit, or each differing entry
   listed with its ulps (every table, the camera rows too, must be bit
   for bit); ``pack_vjp`` against
   ``pack_vjp_plain`` on a seeded gradient vector on all 8 scenes (the
   table gradients bit for bit, the angles within PACK_VJP_RTOL); each
   kernel timed alone (device-only, PACK_TIMED_CALLS launches) against its
   plain version, beside its bound (``render/bounds.py`` ``pack_work``,
   ``vjp_work``); then the step-1 profile of a graphed dingdong frame
   (``tpu_ray_tracer_torch.frame_profile.profile_ops``: device ops and
   device time a frame of the bench's forward and fwd+bwd sweeps, against
   the parent's PARENT_FRAME_OPS); the frames and the fit step that the
   packing speeds up are timed by 9e (the graphed calls and fit step) and
   11 (the bench's dingdong stages);
5c. the backward of the pipeline's per-object gather (``select_rows_bwd``,
   csrc/select_rows.cu) at clebsch 800x600's two soft row blocks (598,400
   and 361,600 rows of 20 f32 into one object), the count set to 0 just
   before: a gradient of ones gives each entry its row count exactly;
   integers in [-8, 8] give the float64 ``index_add_`` bit for bit (every
   partial sum is an integer under 2**24); normal values lie within the
   card test's rounding limit of the float64 sum, with aten's serial
   ``index_put_`` (autograd's own backward of ``table[idx]``) read beside
   it, and a second call gives the same bits; then the kernel timed alone
   (device-only), its plain version (each object's rows masked and summed)
   and aten's ``index_put_`` beside its bytes' bound;
5d. the pipeline's root solve (``solve_roots``, csrc/solve_roots.cu) on the
   four calls of clebsch 800x600's soft render by row blocks (374 rows,
   then 226: branch A's primary solve [rows, 800] and both branches' shadow
   solve [2, rows, 800, 6]; polish 2), and the same source's branch B
   (``roots_excluding_pair``) on its two calls ([rows, 800], the problem's
   mask), recorded from ``Loss.render_rows``: each call's root table equal
   to its plain version's (``_solve_plain``, ``_excluding_pair_plain``) on
   the same tensors bit for bit, or each differing entry's ulps listed
   (fatal), one launch a call; then each kernel timed alone (device-only)
   beside its bound (``render/bounds.py`` ``solve_work`` and
   ``excluding_pair_work`` at ``H100_F32_ISSUE_PER_S``, as the source is
   built without FMAs) and the plain version;
6. timing: CUDA events over 32 frames of dingdong 1280x720 at yaws
   90 + 1e-3 k after warm-up (the kernel alone as device time of its
   launches run back to back, proven by ``timed_ms``'s gate; the whole call
   and the plain version with the host's gaps), and the kernel alone per
   scene, each beside its bound (tpu_ray_tracer_torch/render/bounds.py,
   counted from that frame's aux). The gate's check: the kernel alone over
   32 and 256 frames of the sweep, with the host quiet and with a Python
   thread spinning for the GIL (``busy_host``), each printed with its gate
   (sleep, reruns, the host's enqueue time a call); all four within 2% of
   the quiet 32-frame reading;
7a. the main path with a gradient: dingdong 1280x720 through
   ``render_image_kernel`` with every differentiable scene and camera
   tensor requiring grad, then ``loss.backward()``, the counts set to 0
   just before and read just after: one render_fwd and one render_bwd
   launch, one pack_frame and one pack_vjp, every gradient finite and
   nonzero (reflection excepted: no
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
   20spheres and reflection_test beside its bound, and beside it the bench's
   reading of the same kernel (the sweep's 32 frames, the cotangent of
   mean(img^2)) crossed with this one (one frame, a linear ramp), and the
   bench's 128-frame sweep beside its last 32 poses alone;
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
   render_bwd, and ``select_rows`` launches for the coefficients' gradient
   (33 lights) and none without it (0 objects); the gradients equal the
   pipeline's own autograd (rtol 1e-5 light_color, 1e-4 coefs; zero for
   the 0-object lights);
8d. the pipeline's fwd+bwd on dingdong 1280x720 at pitch 5 against K2's
   gradient from 7a under tests/test_pallas.py:174-181's rule, logged per
   group over the frame; every group finite, and within the rule over the
   pixels whose primary hit the two forwards find alike (the same object,
   t and dF/dt within 1e-4 relative), weighted by the
   cotangent of 7a;
8e. the pipeline's times by CUDA events (FAST and GOLDEN forward, fwd+bwd,
   the 33-light fallback's fwd+bwd) with the peak device memory of each,
   eager (``graphs.eager()``, as in every earlier run; 9f times the graphs);
9a. the fit's main path: ``fit scenes/dingdong.yml --steps 5`` in-process
   (auto resolves to the kernel route; the counts set to 0 just before):
   5 render_fwd launches with aux and 5 render_bwd, plus the one forward
   of the target frame; the loss finite and falling; then the train step
   alone timed by CUDA events beside 7e's fwd+bwd call;
9b. the BASELINE.json inverse configuration: clebsch 800x600, coefs and
   light colours perturbed by 0.6, 5 steps through the kernels and 3 with
   the soft loss (tau 0.15) through the pipeline by row blocks (a warm-up,
   a capture and a replay of the step's graph; no render_fwd, render_bwd or
   packing launch, and one ``select_rows`` launch a row block, 2 a step, for
   the coefficients' gradient, two ``solve_roots`` and one
   ``roots_excluding_pair`` launch a row block; the kernel route none of
   these); the loss falls on
   both routes; each step's time and the peak device memory;
9c. ``render_rays_soft`` at tau 1e-4 against the hard pipeline frame on
   clebsch and quadratic at full size: under 2% of pixels apart by more
   than 2/255 (tests/test_soft.py:36-59's rule);
9d. checkpoint resume: 4 kernel-route fit steps on dingdong against 2, a
   checkpoint and 2 resumed, bitwise equal parameters; a checkpoint without
   its ``opt/...`` keys raises;
9e. the CUDA graphs (``render/graphs.py``; the counts set to 0 just before
   and read after (d)): (a) all 8 scenes at full size, each frame's graph
   captured at its second call at the reference pose and replayed at two
   further poses, every graphed frame equal to the eager one
   (``graphs.eager()``) bit for bit, one render_fwd launch a frame, one
   capture a scene; (b) a kept frame unchanged by the next replay; (c) on
   dingdong, reflection_test and 20spheres the graphed gradients of every
   group equal the eager ones bit for bit over warm-up, capture and replay,
   one launch of each kernel a backward, and a backward taken after the
   next frame's forward too; (d) 5 graphed kernel-route fit steps on
   dingdong (light colours x0.6, polish 2) and on clebsch 800x600 (coefs and
   light colours, the BASELINE problem) give the losses and parameters of 5
   eager steps with the same capturable Adam, bit for bit, with 5 launches
   of each kernel and the captures printed, and so does the same train
   step again with new parameters and a new optimizer (whose state does
   not exist when its keys' graphs do); 9d's graphed 4-step fit equals
   an eager one; (e) CUDA-event times of the eager and the graphed forward
   frame, fwd+bwd frame and fit step on dingdong in turns (eager, graphed,
   graphed, eager), host quiet and busy; the forward and fwd+bwd frames
   device-only over 6 calls (logged as not measured where the gate refuses
   the reading); one ``torch._foreach_copy_`` of a frame's inputs against a
   copy each; the launches each replay adds and each capture's host time;
   torch.profiler over 8 graphed calls of each path; the memory that one
   forward-frame, fwd+bwd-frame and fit-step graph keeps on the card;
9f. the pipeline route as CUDA graphs (the counts set to 0 just before and
   read at its end): (a) the soft fit of 9b annealed 0.15 -> 0.05 over 5
   steps by ``tau_schedule`` and (b) the hard pipeline route on dingdong
   (``backend="torch"``, light colours x0.6, polish 2), each 5 graphed steps
   giving the losses and parameters of 5 eager steps with the same
   capturable Adam, bit for bit, through one capture and no render_fwd,
   render_bwd or pack_vjp launch; (a) one ``select_rows`` launch a row
   block a step, eager and graphed alike, (b) none;
   (c) ``render_image`` FAST on dingdong, reflection_test, clebsch and
   cayley and GOLDEN on dingdong and reflection_test, each captured at its
   second call and replayed at two further poses, bitwise the eager frame
   (cayley may share clebsch's key), a kept frame unchanged by the next
   replay, and 20spheres FAST in one shot captured like them (its key's
   warm-up, logged, is under ``graphs.MAX_GRAPH_BYTES`` since the root
   solve is one kernel: none of its 3 calls counted in ``over_bound``),
   then, with ``MAX_GRAPH_BYTES`` set to one frame's bytes in a fresh
   cache, held eager by the byte bound (2 of its 3 calls counted in
   ``over_bound``, no capture) and bitwise the eager frame;
   (d) 8c's 33-light and 0-object scenes through ``render_image_kernel`` and
   ``backward()``, the graphed frame and gradients bitwise the eager ones
   over warm-up, capture and replay, one render_fwd (main) and no render_bwd
   a frame; (e) CUDA-event times of the eager and graphed soft step, hard
   pipeline step, FAST frame, GOLDEN frame and fallback fwd+bwd in turns
   (eager, graphed, graphed, eager), host quiet, then torch.profiler over the
   same calls (``tpu_ray_tracer_torch.pipeline_profile``: device ops, host
   and device time, busy share, peak memory; each graphed call's captures,
   their host time and the bytes its graphs keep);
10a. the row-sharded path at world size 1 over NCCL, in this process
   (the counts set to 0 just before): ``render_image_sharded`` (kernel
   route) on dingdong 1280x720 equals phase 3's frame bit for bit, and 5
   sharded kernel-route fit steps (light colours x0.6, polish 2) give the
   losses and parameters of ``make_train_step`` without a process group,
   bit for bit; each step's time by CUDA events and its peak memory; then
   torch.profiler over 5 steps without the group and with it, in turns,
   printing each step's host and device time and the operations whose
   count the group changes: a group of one must run no all-reduce;
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
   and its dingdong renders phase 3's frame bit for bit;
11. the port's bench, ``python -m tpu_ray_tracer_torch.bench``, as a child
   process at full size on the card, bounded by a timeout: exit 0, a last
   line that parses as JSON with the headline, all 12 stages measured (none
   failed or skipped), all 8 scenes within their parity gates, the ``cuda``
   forward backend, and the kernels' launches over the run equal to what
   its stage list implies (``bench_launches``); the headline and the
   dingdong figures are printed.

Every exact launch check of phases 3-11 counts the packing kernels too:
one pack_frame with each render_fwd, one pack_vjp with each render_bwd of
a frame's backward (the bench's kernel readings call render_bwd alone).

The last lines are the card's name and power limit, a {"kernels": [...]}
line (each kernel's launches on the main paths, 9e's, 9f's, the sharded ones of
10a and of both ranks of 10b and the bench's of 11 included, its time, its plain
version's, its bound and share of the bound on dingdong 1280x720, and
``select_rows``' at clebsch's soft row blocks: its launches in 5c, 8c, 9b and
9f; ``solve_roots``' and ``roots_excluding_pair``'s at the same blocks, their
launches in 5d and 9b; no single
PyTorch call computes K1, K2, the packing or the solves, so their
``library_ms`` is null, and ``select_rows``' is aten's ``index_put_``), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import threading
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
GATE_FRAMES = 256      # 6: the long sweep of the device-only reading's check
GATE_RTOL = 0.02       # 6: each of its four readings against the quiet 32-frame one
K2_LONG_SWEEP = 128    # 7e: the bench's sweep at TRT_BENCH_FRAMES=128
PLAIN_FRAMES = 3
KERNELS = ("render_fwd", "render_bwd", "pack", "select_rows", "solve_roots")
PACK_VJP_RTOL = 1e-5   # 5b: d yaw, d pitch, kernel against plain, relative
PACK_TIMED_CALLS = 256  # 5b: each packing kernel timed alone; 5c: select_rows_bwd
# 5c: clebsch 800x600's two soft row blocks (Loss.block_rows 374 of 600 rows,
# then 226), each of 800 rays and both branches
SELECT_ROWS = (2 * 374 * 800, 2 * 226 * 800)
SELECT_PLAIN_CALLS = 3  # 5c: the plain version and aten's index_put_, timed
SOLVE_TIMED_CALLS = 64  # 5d: solve_roots timed alone, a call
SOLVE_PLAIN_CALLS = 3   # 5d: its plain version, timed
# 5b: device ops a frame of the bench's dingdong sweep graphs on the parent
# (19626a1), PERF.md's step-1 profile (frame_profile, NVIDIA H100 80GB HBM3,
# 700.00 W)
PARENT_FRAME_OPS = {"forward": 72.03, "fwd+bwd": 88.00}
FIT_STEPS = 5          # 9a: the CLI's fit on dingdong; 10a-10c: the sharded fit
FIT_TIMED_STEPS = 8    # 9a: the train step timed alone
PROFILED_STEPS = 5     # 10a: the world-1 step under torch.profiler, with and without the group
DEVICE_ONLY_CALLS = 6  # 9e: the device-only readings of a whole call
PIPE_TIMED_CALLS = 3   # 9f (e): the pipeline route's calls timed, and profiled, a turn
RANK_TIMEOUT_S = 300   # 10b, 10c: each spawned process
SHARDED_FIT_RTOL = 1e-5  # 10b against 10a: losses and light colours, relative
BENCH_TIMEOUT_S = 600  # 11: the bench's child process
BENCH_FRAMES = 32      # 11: the bench's default sweep (TRT_BENCH_FRAMES)
DIFF_FIELDS = ("coefs", "colors", "reflection", "light_p", "light_color", "bg_color",
               "tan_half_fov")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


@contextlib.contextmanager
def busy_host():
    """A Python thread of this process spinning while the block runs: it
    contends for the GIL, so every enqueue of the block waits for it."""
    stop = threading.Event()

    def spin():
        n = 0
        while not stop.is_set():
            n += 1

    thread = threading.Thread(target=spin, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


def bench_launches(frames: int) -> dict:
    """The kernels' launches over one run of the bench, from its stage list.
    Each stage's sweep is one CUDA graph: its eager warm-up on a side stream
    runs the sweep once, the capture executes nothing (its launches are not
    counted), and the warm replay and the timed replay run it twice more.
    Each of its 8 forward stages (reflection_test's at 5 bounces, the others
    without a chain) launches render_fwd for the sweep's frames and the
    parity frame three times, and for the sweep's frames alone once more
    (the kernel reading); each of its 4 forward+backward stages (dingdong,
    monkey_saddle, reflection_test, 20spheres) launches render_fwd with aux
    and render_bwd once each for the sweep's frames three times, and once
    more for the kernel reading (render_fwd for its aux, render_bwd
    timed).
    Every render_fwd launch comes with a pack_frame launch (the kernel
    readings' tables come from ``pack_frame``), and each of the sweeps'
    backwards with a pack_vjp launch (3 a frame of a forward+backward
    sweep; the kernel reading runs render_bwd alone)."""
    fwd, fwdbwd = 4 * frames + 3, 4 * frames
    return {"render_fwd": 8 * fwd + 4 * fwdbwd, "render_fwd.save_aux": 4 * fwdbwd,
            "render_bwd": 4 * fwdbwd, "render_fwd.main": 7 * fwd + 3 * fwdbwd,
            "render_fwd.main_chain": fwd + fwdbwd, "render_fwd.generic": 0,
            "pack_frame": 8 * fwd + 4 * fwdbwd, "pack_vjp": 4 * 3 * frames}


def _ordered_bits(t):
    """f32 values as integers that differ by their distance in ulps."""
    import torch

    i = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def pack_phase(scenes: dict, camera, dev, smi: str) -> dict:
    """Phase 5b (see the module's docstring); returns the packing kernels'
    worst differences against their plain versions, their times, their
    plain versions' and their bounds on dingdong 1280x720."""
    import numpy as np
    import torch

    from tpu_ray_tracer_torch import frame_profile
    from tpu_ray_tracer_torch.kernel_bench import timed_ms
    from tpu_ray_tracer_torch.render import bounds
    from tpu_ray_tracer_torch.render.bwd_kernel import acc_layout
    from tpu_ray_tracer_torch.render.kernel_backend import _host_half
    from tpu_ray_tracer_torch.render.pack_kernel import (GRAD_FIELDS, pack_tables,
                                                         pack_tables_plain, pack_vjp,
                                                         pack_vjp_plain)

    tables = ("coefs", "orig_index", "colors", "refl", "lights", "dir_table", "posdef", "cam")
    poses = {"reference": ((0.0, 0.0, 0.0), 90.0, 0.0), "yaw 91 pitch 2": ((0.0, 0.0, 0.0),
                                                                           91.0, 2.0),
             "off": OFF_POSE}
    worst_ulps = dict.fromkeys(tables, 0)
    listed, cases, worst_abs = [], 0, 0.0
    for name, scene in scenes.items():
        host = _host_half(scene, 3, None, None)
        for label, pose in poses.items():
            cams = [("f32", camera(*pose))]
            if label == "off":
                cams.append(("f64", _camera_f64(camera(*pose))))
            for dtype, cam in cams:
                for row0 in (0, scene.height // 2):
                    got = pack_tables(scene, cam, host["slots"], n_cubic=host["n_cubic"],
                                      row0=row0)
                    want = pack_tables_plain(scene, cam, host["slots"],
                                             n_cubic=host["n_cubic"], row0=row0)
                    cases += 1
                    for key, g, w in zip(tables, got, want):
                        if g.dtype != w.dtype or g.shape != w.shape:
                            raise RuntimeError(f"pack {name} {key}: {g.dtype} {tuple(g.shape)} "
                                               f"against {w.dtype} {tuple(w.shape)}")
                        if g.dtype == torch.int32:
                            differ = g != w
                            ulps = (g.long() - w.long()).abs()
                        else:
                            differ = g.view(torch.int32) != w.view(torch.int32)
                            ulps = (_ordered_bits(g) - _ordered_bits(w)).abs()
                            if g.numel():
                                worst_abs = max(worst_abs, float((g - w).abs().max()))
                        if bool(differ.any()):
                            at = differ.nonzero().tolist()
                            listed.append(f"{name} {label} {dtype} row0 {row0} {key}: "
                                          + ", ".join(f"{tuple(i)} {int(ulps[tuple(i)])} ulps"
                                                      for i in at))
                            worst_ulps[key] = max(worst_ulps[key], int(ulps.max()))
    for line in listed:
        log(f"[pack] differs: {line}")
    log(f"[pack] pack_frame against pack_tables_plain: {cases} cases (8 scenes, 3 poses, f64 "
        f"at one, row0 0 and height / 2), worst ulps by table {worst_ulps}")
    differing = [k for k in tables if worst_ulps[k]]
    if differing:
        raise RuntimeError(f"pack_frame differs from its plain version: tables {differing} (must "
                           f"be bit for bit)")

    rng = np.random.default_rng(15)
    vjp_worst = {"table_abs": 0.0, "angle_rel": 0.0, "angle_abs": 0.0}
    for name, scene in scenes.items():
        gather = _host_half(scene, 3, None, None)["slots"][0]
        cam = camera((0.5, -1.0, 2.0), 91.0, 2.0)
        n = acc_layout(scene.n_objects, scene.n_lights)[-1]
        vec = torch.tensor(rng.standard_normal(n).astype(np.float32), device=dev)
        got = pack_vjp(vec, gather, scene, cam)
        want = pack_vjp_plain(vec, gather, scene, cam)
        for field, g, w in zip(GRAD_FIELDS, got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.isfinite(g).all():
                raise RuntimeError(f"pack_vjp {name} {field}: {g.dtype} {tuple(g.shape)}, "
                                   f"finite {bool(torch.isfinite(g).all())}")
            err = float((g - w).abs().max())
            if field in ("yaw_deg", "pitch_deg"):
                rel = err / max(float(w.abs()), 1e-30)
                vjp_worst["angle_rel"] = max(vjp_worst["angle_rel"], rel)
                vjp_worst["angle_abs"] = max(vjp_worst["angle_abs"], err)
                if rel > PACK_VJP_RTOL:
                    raise RuntimeError(f"pack_vjp {name} {field}: relerr {rel} > {PACK_VJP_RTOL}")
            else:
                vjp_worst["table_abs"] = max(vjp_worst["table_abs"], err)
                if not torch.equal(g, w):
                    raise RuntimeError(f"pack_vjp {name} {field}: differs from the plain version")
    log(f"[pack] pack_vjp against pack_vjp_plain, 8 scenes, a seeded gradient vector: table "
        f"gradients bit for bit, yaw and pitch relerr {vjp_worst['angle_rel']:.3e} (limit "
        f"{PACK_VJP_RTOL:g})")

    # each kernel alone against its plain version, beside its bound
    ding = scenes["dingdong"]
    host = _host_half(ding, 3, None, None)
    cam = camera()
    gather = host["slots"][0]
    vec = torch.tensor(rng.standard_normal(acc_layout(ding.n_objects, ding.n_lights)[-1])
                       .astype(np.float32), device=dev)
    calls = {
        "pack_frame": (lambda k: pack_tables(ding, cam, host["slots"], n_cubic=host["n_cubic"],
                                             row0=0),
                       lambda k: pack_tables_plain(ding, cam, host["slots"],
                                                   n_cubic=host["n_cubic"], row0=0),
                       bounds.pack_work(ding, cam)),
        "pack_vjp": (lambda k: pack_vjp(vec, gather, ding, cam),
                     lambda k: pack_vjp_plain(vec, gather, ding, cam),
                     bounds.vjp_work(ding, cam)),
    }
    out = {}
    for name, (kernel, plain, work) in calls.items():
        kernel(0)
        plain(0)
        ms = timed_ms(kernel, PACK_TIMED_CALLS, device_only=True)
        plain_ms = timed_ms(plain, PACK_TIMED_CALLS)
        bound, by = bounds.bound_ms(work["ops"], work["bytes"])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "ops": work["ops"], "bytes": work["bytes"]}
        log(f"[pack] {name} dingdong: kernel {ms * 1e3:.3f} us a launch (device-only, "
            f"{PACK_TIMED_CALLS} launches), plain version {plain_ms * 1e3:.3f} us a call (CUDA "
            f"events with the host's gaps); bound {bound * 1e6:.3f} ns ({by}: {work['bytes']} "
            f"bytes, {work['ops']} operations), share {bound / ms:.2e} ({smi})")
    out["max_abs_err"] = {"pack_frame": worst_abs,
                          "pack_vjp": max(vjp_worst["table_abs"], vjp_worst["angle_abs"])}
    out["worst_ulps"] = worst_ulps
    out["vjp_angle_rel"] = vjp_worst["angle_rel"]

    # the step-1 profile on this tree: device ops a frame of the bench's
    # graphed dingdong sweeps, against the parent's
    ops = frame_profile.profile_ops(dev, ding)
    for what, r in ops.items():
        log(f"[frame-profile] graphed {what} sweep, dingdong 1280x720: {r['ops_a_frame']:.2f} "
            f"device ops a frame (parent {PARENT_FRAME_OPS[what]:.2f}), "
            f"{r['device_ms_a_frame']:.4f} ms of device time a frame: "
            + "; ".join(f"{o['count']:g} x {o['name'][:60]} {o['us']:.2f} us" for o in r["by_name"])
            + f" ({smi})")
    if not ops["forward"]["ops_a_frame"] < PARENT_FRAME_OPS["forward"] / 4:
        raise RuntimeError(f"graphed forward frame: {ops['forward']['ops_a_frame']} device ops a "
                           f"frame, the parent's {PARENT_FRAME_OPS['forward']}")
    out["frame_ops"] = {k: v["ops_a_frame"] for k, v in ops.items()}
    return out


def select_phase(dev, smi: str) -> dict:
    """Phase 5c (see the module's docstring); returns the gather's backward
    kernels' worst errors, their time at each of clebsch's soft row blocks,
    their plain version's, aten's and the bound."""
    import torch

    from tpu_ray_tracer_torch.kernel_bench import timed_ms
    from tpu_ray_tracer_torch.render import bounds
    from tpu_ray_tracer_torch.render.select_kernel import select_plan, select_rows_bwd

    n, c = 1, 20  # clebsch's one object, its 20 coefficients
    g = torch.Generator(device=dev).manual_seed(18)
    out = {"rel_err": 0.0, "rel_err_aten": 0.0, "blocks": {}}
    for rows in SELECT_ROWS:
        idx = torch.zeros(rows, dtype=torch.int64, device=dev)  # every ray on the object
        shape = (n, c)

        def f64_sum(values):
            return torch.zeros(shape, dtype=torch.float64, device=dev).index_add_(
                0, idx, values.double())

        # a gradient of ones: each entry is the object's row count, exactly
        counts = select_rows_bwd(torch.ones((rows, c), device=dev), idx, shape)
        # integers in [-8, 8]: every partial sum is an integer under 2**24,
        # exact in f32 in any order, so the kernel equals the f64 sum bit for bit
        ints = torch.randint(-8, 9, (rows, c), generator=g, device=dev).float()
        int_sum = select_rows_bwd(ints, idx, shape)
        if not bool((counts == rows).all()) or not torch.equal(int_sum.double(), f64_sum(ints)):
            raise RuntimeError(f"select_rows_bwd {rows} rows: counts {counts.flatten().tolist()} "
                               f"(want {rows}), or the integer gradient's sum differs from the "
                               f"f64 sum by {float((int_sum.double() - f64_sum(ints)).abs().max())}")
        # normal values against the f64 sum and against autograd's own
        # backward of table[idx] (aten's index_put_(accumulate=True)); the
        # limit is the test's: the sum of |rows| times the unit roundoff
        # times the longest chain of additions in the kernel's order
        grad = torch.randn((rows, c), generator=g, device=dev)
        got = select_rows_bwd(grad, idx, shape)
        if not torch.equal(select_rows_bwd(grad, idx, shape), got):
            raise RuntimeError(f"select_rows_bwd {rows} rows: a second call gave other bits")
        table = torch.zeros(shape, device=dev, requires_grad=True)
        (aten,) = torch.autograd.grad(table[idx], table, grad)
        want, abs_sum = f64_sum(grad), f64_sum(grad.abs())
        placement, blocks, _ = select_plan(rows, n, c, grad.dtype)
        depth = -(-rows // (blocks * 8)) + 1 + 8 * 32 + -(-blocks // 256) + 8
        tol = depth * torch.finfo(torch.float32).eps / 2 * abs_sum
        err, err_aten = (got.double() - want).abs(), (aten.double() - want).abs()
        rel, rel_aten = float((err / abs_sum).max()), float((err_aten / abs_sum).max())
        out["rel_err"], out["rel_err_aten"] = (max(out["rel_err"], rel),
                                               max(out["rel_err_aten"], rel_aten))
        if not bool((err <= tol).all()):
            raise RuntimeError(f"select_rows_bwd {rows} rows: {float((err / tol).max()):.3g} "
                               f"times its limit from the f64 sum")

        def plain(k):  # plain PyTorch in a fixed order: the object's rows masked and summed
            return torch.stack([torch.where((idx == j)[:, None], grad, 0.0).sum(0)
                                for j in range(n)])

        ms = timed_ms(lambda k: select_rows_bwd(grad, idx, shape), PACK_TIMED_CALLS,
                      device_only=True)
        plain(0)
        plain_ms = timed_ms(plain, SELECT_PLAIN_CALLS)
        zero = torch.zeros(shape, device=dev)
        library_ms = timed_ms(lambda k: zero.index_put_((idx,), grad, accumulate=True),
                              SELECT_PLAIN_CALLS)
        n_bytes = rows * (c * 4 + 8) + n * c * 4
        bound, by = bounds.bound_ms(rows * c, n_bytes)
        out["blocks"][rows] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                               "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
                               "placement": placement, "grid": blocks}
        log(f"[select] select_rows_bwd, clebsch's soft row block: {rows} rows of {c} f32 into "
            f"{n} object ({placement}, {blocks} blocks): counts exact, integer sums equal the f64 "
            f"sum, normal values {rel:.3e} of the |rows| sum from the f64 sum (aten's serial "
            f"index_put_ {rel_aten:.3e}); kernel {ms * 1e3:.3f} us a call (device-only, "
            f"{PACK_TIMED_CALLS} calls), plain version {plain_ms:.4f} ms, aten's index_put_ "
            f"{library_ms:.4f} ms (CUDA events with the host's gaps); bound {bound * 1e3:.3f} us "
            f"({by}: {n_bytes} bytes), share {bound / ms:.3f} ({smi})")
    return out


def solve_phase(dev, smi: str) -> dict:
    """Phase 5d (see the module's docstring); returns, by kernel
    (``solve_roots``, ``roots_excluding_pair``), each call's time, its plain
    version's and its bound at clebsch's soft render by row blocks, and the
    kernel's launches."""
    import torch

    import tpu_ray_tracer_torch as ttt
    from tpu_ray_tracer_torch.diff import soft
    from tpu_ray_tracer_torch.diff.inverse import Loss, extract_params
    from tpu_ray_tracer_torch.kernel_bench import timed_ms
    from tpu_ray_tracer_torch.ops import intersect
    from tpu_ray_tracer_torch.pipeline_profile import _camera, fit_problem
    from tpu_ray_tracer_torch.render import bounds
    from tpu_ray_tracer_torch.ops.solve_kernel import (_solve_plain, roots_excluding_pair,
                                                       solve_roots)

    clebsch = ttt.load_from_file(os.path.join(REPO, "scenes", "clebsch.yml"), device=dev)
    problem, _ = fit_problem(clebsch, ["coefs", "light_color"], "torch", soft_tau=0.15)
    loss = Loss(problem)
    params = extract_params(problem.scene_template.astype(torch.float32), problem.param_fields)
    calls = {"solve_roots": [], "roots_excluding_pair": []}

    def recorder(name, kernel):
        def record(*args):
            calls[name].append(tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                     for a in args))
            return kernel(*args)
        return record

    intersect.solve_roots = recorder("solve_roots", solve_roots)
    soft.roots_excluding_pair = recorder("roots_excluding_pair", roots_excluding_pair)
    try:
        with torch.no_grad():
            for y0 in range(0, clebsch.height, loss.block_rows):
                loss.render_rows(params, _camera(dev), y0,
                                 min(loss.block_rows, clebsch.height - y0))
    finally:
        intersect.solve_roots, soft.roots_excluding_pair = solve_roots, roots_excluding_pair
    # (kernel, its plain version, its count, the calls a soft render makes)
    kernels = {"solve_roots": (solve_roots, _solve_plain,
                               lambda c, o, d, p: bounds.solve_work(c, o, d, p), 4),
               "roots_excluding_pair": (roots_excluding_pair, soft._excluding_pair_plain,
                                        lambda c, o, d, p, kinds, _t:
                                        bounds.excluding_pair_work(c, o, d, p, kinds), 2)}
    out = {}
    for name, (kernel, plain, work_of, n_calls) in kernels.items():
        res = out[name] = {"calls": [], "launches": 0}
        for args in calls[name]:
            coefs, origin, d, polish = args[:4]
            label = "x".join(map(str, torch.broadcast_shapes(origin.shape, d.shape)[:-1]))
            before = kernel.launches
            got = kernel(*args)
            res["launches"] += kernel.launches - before
            want = plain(*args)
            differ = (got != want) & ~(got.isnan() & want.isnan())
            if bool(differ.any()):
                ulps = (_ordered_bits(got) - _ordered_bits(want)).abs()[differ]
                raise RuntimeError(f"{name} [{label}]: {int(differ.sum())} of {got.numel()} "
                                   f"entries differ from its plain version, up to "
                                   f"{int(ulps.max())} ulps")
            ms = timed_ms(lambda k: kernel(*args), SOLVE_TIMED_CALLS, device_only=True)
            plain_ms = timed_ms(lambda k: plain(*args), SOLVE_PLAIN_CALLS)
            work = work_of(*args)
            # built without FMAs: each multiply and add is an instruction of its own
            bound, by = bounds.bound_ms(work["ops"], work["bytes"], bounds.H100_F32_ISSUE_PER_S)
            res["calls"].append({"shape": label, "solves": got.numel(), "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                                 "ops": work["ops"], "bytes": work["bytes"],
                                 "share_of_bound": bound / ms})
            log(f"[solve] {name}, clebsch's soft row block [{label}] x {coefs.shape[0]} "
                f"object, polish {polish}: bit for bit its plain version's; kernel "
                f"{ms * 1e3:.3f} us a call (device-only, {SOLVE_TIMED_CALLS} calls), plain "
                f"version {plain_ms:.3f} ms (CUDA events with the host's gaps); bound "
                f"{bound * 1e3:.3f} us ({by}: {work['ops']} operations at the f32 issue rate "
                f"without FMAs, {work['bytes']} bytes), share {bound / ms:.3f} ({smi})")
        if res["launches"] != len(calls[name]) or len(calls[name]) != n_calls:
            raise RuntimeError(f"{name}: {len(calls[name])} calls in the soft render by row "
                               f"blocks (want {n_calls}), {res['launches']} launches")
    return out


def _camera_f64(cam):
    """``cam`` with f64 tensors."""
    import torch

    return type(cam)(*(t.to(torch.float64) for t in (cam.position, cam.yaw_deg, cam.pitch_deg)))


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
    from tpu_ray_tracer_torch.kernel_bench import GateRefused, timed_ms
    from tpu_ray_tracer_torch.parity import (PARITY_GATES, bad_pixel_fraction,
                                             gradient_group_errors)
    from tpu_ray_tracer_torch.render import _build, bounds
    from tpu_ray_tracer_torch.render.bwd_kernel import render_bwd, render_bwd_plain
    from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd, render_fwd_plain
    from tpu_ray_tracer_torch.render.kernel_backend import pack_frame
    from tpu_ray_tracer_torch.render.pack_kernel import pack_tables, pack_vjp
    from tpu_ray_tracer_torch.render.select_kernel import select_rows
    from tpu_ray_tracer_torch.ops.solve_kernel import roots_excluding_pair, solve_roots
    from tpu_ray_tracer_torch.utils.device import smi_line

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # --- 1. device ---
    smi = smi_line()
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
        pack_tables.launches = pack_vjp.launches = select_rows.launches = 0
        solve_roots.launches = roots_excluding_pair.launches = 0
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
    main_pack = (pack_tables.launches, pack_vjp.launches)
    if solve_roots.launches:
        raise RuntimeError(f"main path: {solve_roots.launches} solve_roots launches on the "
                           f"kernel route")
    if main_launches < 1 or main_variants != {"main": main_launches}:
        raise RuntimeError(f"main path: render_fwd launches {main_launches}, by "
                           f"instantiation {main_variants}; expected the main one")
    if main_pack != (main_launches, 0):
        raise RuntimeError(f"main path: (pack_frame, pack_vjp) launches {main_pack}, expected "
                           f"({main_launches}, 0)")
    image = image.cpu().numpy()
    if image.shape != (720, 1280, 3) or not np.isfinite(image).all():
        raise RuntimeError(f"main path: bad frame shape {image.shape} or non-finite values")
    frac = bad_pixel_fraction(image, golden("dingdong"))
    log(f"[main] dingdong 1280x720 via render_image_kernel: launches={main_launches} "
        f"{main_variants}, pack_frame {main_pack[0]} "
        f"bad-px vs golden {frac:.6f} (gate {PARITY_GATES['dingdong']})")
    if frac > PARITY_GATES["dingdong"]:
        raise RuntimeError("main path: dingdong over its parity gate")

    # --- 4. parity against the goldens, all scenes at full size ---
    scenes = {name: load(name) for name in SCENES}
    parity = {}
    for name, scene in scenes.items():
        before = (render_fwd.launches, pack_tables.launches)
        img = ttt.render_image_kernel(scene).cpu().numpy()
        launched = (render_fwd.launches - before[0], pack_tables.launches - before[1])
        if launched != (1, 1):
            raise RuntimeError(f"parity {name}: expected one render_fwd and one pack_frame "
                               f"launch, counted {launched}")
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

    # --- 5b. the packing kernels against their plain versions ---
    pack = pack_phase(scenes, camera, dev, smi)

    # --- 5c. the pipeline gather's backward kernels at clebsch's soft row blocks ---
    zero_counts()
    select = select_phase(dev, smi)
    select_by_path = {"vs_f64": select_rows.launches}

    # --- 5d. the pipeline's root solve at clebsch's soft row blocks ---
    zero_counts()
    solve = solve_phase(dev, smi)
    solve_by_path = {"vs_plain": solve["solve_roots"]["launches"]}
    excluding_by_path = {"vs_plain": solve["roots_excluding_pair"]["launches"]}

    # --- 6. timing (dingdong 1280x720, the JAX bench's yaw sweep) ---
    n_px = ding.width * ding.height
    sweep_yaws = (90.0 + 1e-3 * torch.arange(GATE_FRAMES, dtype=torch.float32)).tolist()
    yaws = sweep_yaws[:TIMED_FRAMES]
    cams = [camera(yaw=y) for y in yaws]
    sweep = [pack_frame(ding, camera(yaw=y), 0, ding.height) for y in sweep_yaws]
    frames = sweep[:TIMED_FRAMES]
    for tables, kw in frames[:2]:  # warm-up
        render_fwd(*tables, **kw)
        render_fwd_plain(*tables, **kw)
    # the device-only reading's gate: K1 at two sweep lengths, with the host
    # quiet and with a Python thread spinning for the GIL, so that every
    # enqueue waits; all four within GATE_RTOL of the first
    gate_ms = {}
    for n, busy in ((TIMED_FRAMES, False), (GATE_FRAMES, False), (TIMED_FRAMES, True),
                    (GATE_FRAMES, True)):
        with busy_host() if busy else contextlib.nullcontext():
            ms = timed_ms(lambda k: render_fwd(*sweep[k][0], **sweep[k][1]), n,
                          device_only=True)
        gate = timed_ms.last_gate
        gate_ms[n, busy] = ms
        log(f"[gate] K1 dingdong 1280x720 {n} frames, host {'busy' if busy else 'quiet'}: "
            f"{ms:.5f} ms/frame; gate sleep {gate.cycles} cycles, {gate.reruns} reruns; host "
            f"enqueue {gate.enqueue_ms:.4f} ms a call ({smi})")
    kernel_ms = gate_ms[TIMED_FRAMES, False]
    off = {key: ms / kernel_ms - 1 for key, ms in gate_ms.items()}
    log("[gate] against the quiet 32-frame reading: " + ", ".join(
        f"{n} {'busy' if busy else 'quiet'} {d:+.4%}" for (n, busy), d in off.items()))
    if any(abs(d) > GATE_RTOL for d in off.values()):
        raise RuntimeError(f"device-only K1 readings differ by more than {GATE_RTOL:.0%}: "
                           f"{gate_ms}")
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
    grad_launches = {"render_fwd": render_fwd.launches, "render_bwd": render_bwd.launches,
                     "pack_frame": pack_tables.launches, "pack_vjp": pack_vjp.launches}
    grad_detail = {k: v for k, v in {**render_fwd.launches_by_variant,
                                     **render_bwd.launches_by_placement}.items() if v}
    log(f"[grad] dingdong 1280x720 loss.backward(): launches {grad_launches} {grad_detail}")
    if grad_launches != {"render_fwd": 1, "render_bwd": 1, "pack_frame": 1, "pack_vjp": 1}:
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
        before = dict(render_bwd.launches_by_placement)
        k_vec = render_bwd(*args, **bkw)
        layout = [k for k, v in render_bwd.launches_by_placement.items() if v != before[k]]
        if name == "20spheres" and layout != ["light_columns.shared"]:
            raise RuntimeError(f"bwd {name}: launched under {layout}, not light_columns.shared")
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
        log(f"[bwd-vs-plain] {name} {scene.width}x{scene.height} bounces={bkw['bounces']} "
            f"({layout[0]}): " + ", ".join(report))

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
        # The bench's reading of this kernel (kernel_ms_bwd_<scene>) takes the
        # sweep's poses, each with its own aux, and the cotangent of
        # mean(img^2), 2 img / N; the reading above takes one frame's aux and
        # a linear ramp. Crossing the two splits the gap between them into
        # its inputs' size (one frame's stays in L2, 32 do not) and the
        # cotangent's values; the bench's 128-frame sweep and its last 32
        # poses split a change with the sweep's length into its count and
        # its poses. Each reading twice, in mirrored order. Then each pose of
        # the 32-frame sweep alone, repeated as the one frame above is: their
        # mean against the sweep's reading is the inputs' size at equal poses.
        sweep_in, sweep_aux, sweep_cot = [], [], []
        for y in sweep_yaws[:K2_LONG_SWEEP]:
            s_tables, s_kw = pack_frame(scene, camera(yaw=y), 0, scene.height)
            s_image, *s_aux = render_fwd(*s_tables, **s_kw, save_aux=True)
            sweep_in.append(tuple(s_tables[i] for i in (0, 2, 3, 4, 7)))
            sweep_aux.append(s_aux)
            sweep_cot.append((2.0 / s_image.numel()) * s_image)
        late = K2_LONG_SWEEP - TIMED_FRAMES
        picks = {"one frame, ramp (7e's)": (TIMED_FRAMES, lambda k: (0, args[5])),
                 "one frame, 2 img/N": (TIMED_FRAMES, lambda k: (0, sweep_cot[0])),
                 "sweep, ramp": (TIMED_FRAMES, lambda k: (k, args[5])),
                 "sweep, 2 img/N (the bench's)": (TIMED_FRAMES, lambda k: (k, sweep_cot[k])),
                 f"poses {late}-{K2_LONG_SWEEP - 1}, 2 img/N": (
                     TIMED_FRAMES, lambda k: (late + k, sweep_cot[late + k])),
                 f"sweep of {K2_LONG_SWEEP}, 2 img/N": (K2_LONG_SWEEP,
                                                        lambda k: (k, sweep_cot[k]))}
        k2_gap = {label: [] for label in picks}

        def k2_call(pick):
            def call(k):
                f, cot = pick(k)
                return render_bwd(*sweep_in[f], cot, *sweep_aux[f], **bkw)
            return call

        for label in [*picks, *reversed(picks)]:
            n, pick = picks[label]
            k2_gap[label].append(timed_ms(k2_call(pick), n, device_only=True))
        log(f"[k2-gap] {name} {scene.width}x{scene.height} render_bwd: "
            + "; ".join(f"{label} {a:.5f}, {b:.5f} ms" for label, (a, b) in k2_gap.items())
            + f" ({smi})")
        alone = [timed_ms(k2_call(lambda k, f=f: (f, sweep_cot[f])), TIMED_FRAMES,
                          device_only=True) for f in range(TIMED_FRAMES)]
        log(f"[k2-gap] {name} each pose of the sweep alone, 2 img/N: mean "
            f"{sum(alone) / len(alone):.5f} ms, pose {alone.index(min(alone))} "
            f"{min(alone):.5f}, pose {alone.index(max(alone))} {max(alone):.5f}; poses 0-3 "
            f"{', '.join(f'{a:.5f}' for a in alone[:4])}; poses 28-31 "
            f"{', '.join(f'{a:.5f}' for a in alone[-4:])} ({smi})")
        del sweep_in, sweep_aux, sweep_cot
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
    cli_pack = pack_tables.launches
    if rc != 0 or cli_launches != 1 or cli_variants != {"main": 1} or cli_pack != 1:
        raise RuntimeError(f"cli render: rc {rc}, render_fwd launches {cli_variants}; "
                           "expected one of the main instantiation")
    frac = bad_pixel_fraction(np.load(cli_npy), golden("dingdong"))
    log(f"[cli] render dingdong --backend kernel: launches {cli_variants}, bad-px vs golden "
        f"{frac:.6f} (gate {PARITY_GATES['dingdong']})")
    if frac > PARITY_GATES["dingdong"]:
        raise RuntimeError("cli render: dingdong over its parity gate")
    buf = io.StringIO()
    before = render_fwd.launches
    before_pack = pack_tables.launches
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", ding_yml, "--frames", str(TIMED_FRAMES)])
    torch.cuda.synchronize()
    for line in buf.getvalue().splitlines():
        log(f"[cli] {line}")
    fps = re.search(r"^FPS: \d+\.\d{4}, last render time: (\d+\.\d{4}) ms$", buf.getvalue(),
                    re.M)
    if (rc != 0 or fps is None or "backend kernel" not in buf.getvalue()
            or render_fwd.launches - before != TIMED_FRAMES + 1
            or pack_tables.launches - before_pack != TIMED_FRAMES + 1):
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
    select_by_path["fallback"] = 0
    for label, scene, fields in (("33 lights", many, ("light_color", "coefs")),
                                 ("0 objects", empty, ("light_color", "bg_color"))):
        zero_counts()
        got = fallback_grads(scene, fields)
        torch.cuda.synchronize()
        launches = {"render_fwd": render_fwd.launches, "render_bwd": render_bwd.launches,
                    "pack_frame": pack_tables.launches, "pack_vjp": pack_vjp.launches,
                    "select_rows": select_rows.launches}
        variants = {k: v for k, v in render_fwd.launches_by_variant.items() if v}
        fallback_launches += render_fwd.launches
        select_by_path["fallback"] += select_rows.launches
        ref = fallback_grads(scene, fields, fallback=False)
        log(f"[fallback] {label} 640x480 loss.backward(): launches {launches} {variants}")
        if {k: v for k, v in launches.items() if k != "select_rows"} != {
                "render_fwd": 1, "render_bwd": 0, "pack_frame": 1, "pack_vjp": 0} or variants != {
                "main": 1} or (select_rows.launches > 0) != (label == "33 lights"):
            raise RuntimeError(f"fallback {label}: expected one render_fwd (main) and one "
                               f"pack_frame, no render_bwd or pack_vjp, and select_rows for the "
                               f"coefficients' gradient alone; got {launches}")
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
    # eager, as in every earlier run: 9f times the graphs beside it
    from tpu_ray_tracer_torch.render import graphs

    pipe_frames = 8

    def pipe_fwd_bwd(k):
        (w * ttt.render_image(t_scene, t_cams[k])).sum().backward()

    fb_leaf = many.light_color.detach().clone().requires_grad_()
    fb_scene = dataclasses.replace(many, light_color=fb_leaf, coefs=many.coefs.clone()
                                   .requires_grad_())
    fb_cams = [camera(yaw=y) for y in yaws[:pipe_frames]]

    def fallback_step(k):
        ttt.render_image_kernel(fb_scene, fb_cams[k]).sum().backward()

    with graphs.eager():
        with torch.no_grad():
            ttt.render_image(ding, cams[0])
            fast_ms, fast_peak = peak_of(lambda: timed_ms(
                lambda k: ttt.render_image(ding, cams[k]), pipe_frames))
            golden_ms, golden_peak = peak_of(lambda: timed_ms(
                lambda k: ttt.render_image(ding, cams[k], ttt.GOLDEN_CONFIG), pipe_frames))
        pipe_fwd_bwd(0)
        fwd_bwd_pipe_ms, fwd_bwd_peak = peak_of(lambda: timed_ms(pipe_fwd_bwd, pipe_frames))
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
                    "render_bwd": render_bwd.launches, "pack_frame": pack_tables.launches,
                    "pack_vjp": pack_vjp.launches}
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
                        "render_bwd": FIT_STEPS, "pack_frame": FIT_STEPS + 1,
                        "pack_vjp": FIT_STEPS}:
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
        launches = (render_fwd.launches_save_aux, render_bwd.launches, pack_tables.launches,
                    pack_vjp.launches, select_rows.launches, solve_roots.launches,
                    roots_excluding_pair.launches)
        baseline_steps[label] = float(np.median(times))
        log(f"[fit] clebsch 800x600 coefs+light_color, {label} ({loss_fn.block_rows} rows a "
            f"block): losses {losses}, step ms {', '.join(f'{t:.4f}' for t in times)}, peak "
            f"{peak:.3f} GiB, kernel launches (fwd with aux, bwd, pack_frame, pack_vjp, "
            f"select_rows, solve_roots, roots_excluding_pair) {launches} ({smi})")
        # the soft route: one select_rows launch a row block, for the coefficients' gather,
        # two solve_roots launches (branch A's primary solve, both branches' shadows) and
        # one roots_excluding_pair launch (branch B's roots)
        row_blocks = -(-clebsch.height // loss_fn.block_rows)
        want = ((steps,) * 4 + (0, 0, 0) if backend == "kernel"
                else (0,) * 4 + (row_blocks * steps, 2 * row_blocks * steps,
                                 row_blocks * steps))
        if backend != "kernel":
            select_by_path["fit_soft"] = select_rows.launches
            solve_by_path["fit_soft"] = solve_roots.launches
            excluding_by_path["fit_soft"] = roots_excluding_pair.launches
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

    # --- 9e. frames, gradients and fit steps as replayed CUDA graphs ---
    from tpu_ray_tracer_torch.render import graphs, kernel_backend

    t_graphs = time.perf_counter()
    zero_counts()
    frames_cache = kernel_backend._FRAMES
    frames_cache.clear()
    captures_before = frames_cache.captures
    poses = {"reference": camera(), "yaw 91 pitch 2": camera(yaw=91.0, pitch=2.0),
             "off": camera(*OFF_POSE)}

    def eager_frame(scene, cam):
        with graphs.eager():
            return ttt.render_image_kernel(scene, cam)

    # (a) every scene: the first call of a new key warms up, the second
    # captures and replays; then replays at two further poses, each against
    # the eager frame at its pose, bit for bit. Scenes whose statics, size
    # and tables' shapes agree share a key, and so a graph, as two calls
    # with equal static arguments share a jitted executable
    capture_calls, keys = {}, {}
    for name, scene in scenes.items():
        key = kernel_backend._frame_key(
            scene, poses["reference"], 0, scene.height, 3,
            *kernel_backend._iteration_counts(scene, 3, None, None), False)
        shared = [other for other, k in keys.items() if k == key]
        keys[name] = key
        ttt.render_image_kernel(scene, poses["reference"])
        captured = frames_cache.captures
        for label, cam in poses.items():
            before = (render_fwd.launches, pack_tables.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ttt.render_image_kernel(scene, cam)
            torch.cuda.synchronize()
            if label == "reference" and not shared:  # the call that captured
                capture_calls[name] = time.perf_counter() - t0
            launched = (render_fwd.launches - before[0], pack_tables.launches - before[1])
            if launched != (1, 1):
                raise RuntimeError(f"graphs {name} {label}: (render_fwd, pack_frame) launches "
                                   f"{launched} for one frame")
            if not torch.equal(got, eager_frame(scene, cam)):
                raise RuntimeError(f"graphs {name} {label}: the graphed frame differs from the "
                                   "eager one")
        if frames_cache.captures != captured + (not shared):
            raise RuntimeError(f"graphs {name}: {frames_cache.captures - captured} captures, "
                               f"its key shared with {shared}")
        if shared:
            log(f"[graphs] {name} shares its frame's key, and graph, with {shared}")
    log(f"[graphs] forward: 8 scenes at full size, graphed frames equal the eager ones bit for "
        f"bit at {len(poses)} poses (captured at the first, replayed at the others); "
        f"{len(set(keys.values()))} keys, {frames_cache.captures - captures_before} captures; "
        f"the capturing "
        f"call's host ms (capture + first "
        f"replay + synchronize): "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in capture_calls.items()) + f" ({smi})")

    # (b) a kept frame is a fresh tensor: the next replay leaves it alone
    kept = ttt.render_image_kernel(ding, poses["yaw 91 pitch 2"])
    copy = kept.clone()
    after = ttt.render_image_kernel(ding, poses["off"])
    if not torch.equal(kept, copy) or kept.data_ptr() == after.data_ptr():
        raise RuntimeError("graphs: a kept frame changed when the next one rendered")
    log("[graphs] a kept frame is unchanged by the next replay")

    # (c) gradients, every group, graphed against eager, bit for bit
    def frame_grads_of(scene, cam, weights, eager=False):
        g_scene, g_cam, g_leaves = grad_leaves(scene, cam)
        with graphs.eager() if eager else contextlib.nullcontext():
            (weights * ttt.render_image_kernel(g_scene, g_cam)).sum().backward()
        return {n: leaf.grad for n, leaf in g_leaves.items()}

    for name in ("dingdong", "reflection_test", "20spheres"):
        scene = scenes[name]
        ramp = torch.linspace(0.1, 1.0, scene.height * scene.width * 3, device=dev).reshape(
            scene.height, scene.width, 3)
        captured = frames_cache.captures
        for k in range(3):  # warm-up, capture and replay, replay
            cam = camera(yaw=90.0 + 0.5 * k, pitch=5.0)
            before = (render_fwd.launches, render_bwd.launches, pack_tables.launches,
                      pack_vjp.launches)
            got = frame_grads_of(scene, cam, ramp)
            launched = (render_fwd.launches - before[0], render_bwd.launches - before[1],
                        pack_tables.launches - before[2], pack_vjp.launches - before[3])
            want = frame_grads_of(scene, cam, ramp, eager=True)
            differ = [n for n in want if not torch.equal(got[n], want[n])]
            if differ or launched != (1, 1, 1, 1):
                raise RuntimeError(f"graphs grad {name} call {k}: groups {differ} differ from "
                                   f"the eager ones, launches {launched}")
        if frames_cache.captures != captured + 1:
            raise RuntimeError(f"graphs grad {name}: {frames_cache.captures - captured} captures")
        log(f"[graphs] gradient {name} {scene.width}x{scene.height}: all {len(want)} groups "
            "equal the eager ones bit for bit (warm-up, capture, replay)")
    # a frame whose backward comes after the next frame's forward: its
    # forward is replayed again first
    first_scene, first_cam, first_leaves = grad_leaves(ding, camera(pitch=5.0))
    first = ttt.render_image_kernel(first_scene, first_cam)
    second_scene, second_cam, _ = grad_leaves(ding, camera(yaw=93.0, pitch=5.0))
    ttt.render_image_kernel(second_scene, second_cam)
    (w * first).sum().backward()
    want = frame_grads_of(ding, camera(pitch=5.0), w, eager=True)
    if any(not torch.equal(first_leaves[n].grad, want[n]) for n in want):
        raise RuntimeError("graphs: a backward after the next frame's forward differs")
    log("[graphs] a backward after the next frame's forward equals the eager one bit for bit")

    # (d) fit steps, graphed against eager with the same optimizer settings
    def fit_run(problem, target, eager, steps=FIT_STEPS, step=None):
        params = inverse.extract_params(problem.scene_template.astype(torch.float32),
                                        problem.param_fields)
        optimizer = problem.optimizer(params)
        step = inverse.make_train_step(problem) if step is None else step
        losses, host_ms = [], []
        with graphs.eager() if eager else contextlib.nullcontext():
            for _ in range(steps):
                t0 = time.perf_counter()
                losses.append(step(params, optimizer, camera(), target))  # float() syncs
                host_ms.append((time.perf_counter() - t0) * 1e3)
        return losses, params, step, host_ms

    baseline_problem, baseline_target = fit_case(clebsch, ["coefs", "light_color"], "kernel")
    graph_fits = {}
    for label, problem, target in (("dingdong 1280x720 light_color", ding_problem, ding_target),
                                   ("clebsch 800x600 coefs+light_color", baseline_problem,
                                    baseline_target)):
        eager_losses, eager_params, _, eager_ms = fit_run(problem, target, eager=True)
        before = (render_fwd.launches_save_aux, render_bwd.launches, pack_tables.launches,
                  pack_vjp.launches)
        losses, params, step, graphed_ms = fit_run(problem, target, eager=False)
        launched = (render_fwd.launches_save_aux - before[0], render_bwd.launches - before[1],
                    pack_tables.launches - before[2], pack_vjp.launches - before[3])
        differ = [k for k in params if not torch.equal(params[k], eager_params[k])]
        step_graphs = graph_fits[label] = step.graphs
        log(f"[graphs] fit {label}: {FIT_STEPS} graphed steps, losses {losses}, "
            f"{step_graphs.captures} captures ({', '.join(f'{t * 1e3:.1f}' for t in step_graphs.capture_s)} ms), "
            f"launches (fwd with aux, bwd, pack_frame, pack_vjp) {launched}; eager losses "
            f"{eager_losses}; host ms a "
            f"step, graphed {', '.join(f'{t:.3f}' for t in graphed_ms)}, eager "
            f"{', '.join(f'{t:.3f}' for t in eager_ms)} ({smi})")
        if losses != eager_losses or differ or launched != (FIT_STEPS,) * 4:
            raise RuntimeError(f"graphs fit {label}: graphed steps differ from the eager ones "
                               f"(params {differ}) or launched {launched}")
        # the same train step with new parameters and a new optimizer: its
        # keys have graphs, and the optimizer's state does not exist yet
        captures = step_graphs.captures
        again, again_params, _, _ = fit_run(problem, target, eager=False, step=step)
        if again != eager_losses or any(not torch.equal(again_params[k], eager_params[k])
                                        for k in again_params):
            raise RuntimeError(f"graphs fit {label}: the train step reused with a new optimizer "
                               f"differs from the eager steps: losses {again}")
        log(f"[graphs] fit {label}: the train step reused with new parameters and a new "
            f"optimizer equals {FIT_STEPS} eager steps bit for bit "
            f"({step_graphs.captures - captures} captures)")
    with graphs.eager():
        eager_whole, _ = inverse.fit(ding_problem, ding_target, camera(), steps=4, **quiet)
    if any(not torch.equal(eager_whole[k], whole[k]) for k in whole):
        raise RuntimeError("graphs: 9d's graphed 4-step fit differs from an eager one")
    log("[graphs] 9d's graphed fit (4 steps, and 2 + checkpoint + 2 resumed, bitwise) equals "
        "4 eager steps bit for bit")
    graph_launches = {"render_fwd": render_fwd.launches,
                      "render_fwd_save_aux": render_fwd.launches_save_aux,
                      "render_bwd": render_bwd.launches, "pack_frame": pack_tables.launches,
                      "pack_vjp": pack_vjp.launches}
    log(f"[graphs] launches in (a)-(d), graphed and eager: {graph_launches}")
    if graph_launches["pack_frame"] != graph_launches["render_fwd"]:
        raise RuntimeError(f"graphs: pack_frame and render_fwd launches differ: {graph_launches}")

    # (e) times by CUDA events, eager and graphed in turns, the host quiet
    # and busy; the captures' cost and the launches each replay adds
    def step_times(problem, target, eager, steps=FIT_TIMED_STEPS):
        params = inverse.extract_params(problem.scene_template.astype(torch.float32),
                                        problem.param_fields)
        optimizer = problem.optimizer(params)
        step = inverse.make_train_step(problem)
        times = []
        with graphs.eager() if eager else contextlib.nullcontext():
            for _ in range(steps):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                step(params, optimizer, camera(), target)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        return float(np.median(times[2:]))  # steps 3-8: the graph replays

    def forward_call(k):
        ttt.render_image_kernel(ding, cams[k])

    graph_times = {}
    for busy in (False, True):
        for mode in ("eager", "graphed", "graphed", "eager"):
            with busy_host() if busy else contextlib.nullcontext():
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    fwd_ms = timed_ms(forward_call, TIMED_FRAMES)
                    fb_ms = timed_ms(fwd_bwd, TIMED_FRAMES)
                step_ms = step_times(ding_problem, ding_target, mode == "eager")
            for what, ms in (("forward frame", fwd_ms), ("fwd+bwd frame", fb_ms),
                             ("fit step", step_ms)):
                graph_times.setdefault((what, mode, busy), []).append(ms)
                log(f"[graphs-time] dingdong 1280x720 {what}, {mode}, host "
                    f"{'busy' if busy else 'quiet'}: {ms:.4f} ms ({smi})")
    # the device's own time of a call, over DEVICE_ONLY_CALLS calls: 32
    # eager calls queue ~2,400 (forward) and ~4,800 (fwd+bwd) launches behind
    # the gate's sleep, and the host then blocked until the device woke; a
    # reading the gate refuses is logged as not measured
    for what, fn in (("forward frame", forward_call), ("fwd+bwd frame", fwd_bwd)):
        for mode in ("eager", "graphed"):
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                try:
                    ms = timed_ms(fn, DEVICE_ONLY_CALLS, device_only=True)
                except GateRefused as exc:
                    log(f"[graphs-time] dingdong 1280x720 {what} device-only, {mode}, "
                        f"{DEVICE_ONLY_CALLS} calls: not measured ({exc})")
                    continue
            log(f"[graphs-time] dingdong 1280x720 {what} device-only, {mode}, "
                f"{DEVICE_ONLY_CALLS} calls: {ms:.4f} ms ({smi})")
    # one multi-tensor copy of a frame's 11 inputs against one copy each
    # (the graphs used last: dingdong's forward and fwd+bwd frames)
    fwd_entry = [e for e in frames_cache.graphs() if e.backward is None][-1]
    src = [t.clone() for t in fwd_entry.inputs]
    copy_ms = {
        "torch._foreach_copy_": timed_ms(
            lambda k: torch._foreach_copy_(fwd_entry.inputs, src), GATE_FRAMES),
        "copy_ per tensor": timed_ms(
            lambda k: [d.copy_(t) for d, t in zip(fwd_entry.inputs, src)], GATE_FRAMES)}
    log("[graphs-time] a frame's 11 inputs into the graph's buffers: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in copy_ms.items()) + f" a call ({smi})")
    grad_entry = [e for e in frames_cache.graphs() if e.backward is not None][-1]
    step_entry = graph_fits["dingdong 1280x720 light_color"].graphs()[0].graph
    log(f"[graphs] launches each replay adds: forward frame {fwd_entry.forward.counts}; "
        f"gradient frame forward {grad_entry.forward.counts}, backward "
        f"{grad_entry.backward.counts}; fit step {step_entry.forward.counts}")
    log(f"[graphs] capture cost (host ms): frames "
        f"{', '.join(f'{t * 1e3:.1f}' for t in frames_cache.capture_s)}; fit steps "
        + "; ".join(f"{k} {', '.join(f'{t * 1e3:.1f}' for t in g.capture_s)}"
                    for k, g in graph_fits.items()) + f" ({smi})")
    # where the graphed calls' host time goes: torch.profiler over 8 calls
    profiled_problem_step = inverse.make_train_step(ding_problem)
    p_params = inverse.extract_params(ding_problem.scene_template.astype(torch.float32),
                                      ding_problem.param_fields)
    p_opt = ding_problem.optimizer(p_params)
    for _ in range(3):  # warm-up, capture, replay
        profiled_problem_step(p_params, p_opt, camera(), ding_target)
    for what, fn in (("forward frame", forward_call), ("fwd+bwd frame", fwd_bwd),
                     ("fit step", lambda k: profiled_problem_step(p_params, p_opt, camera(),
                                                                  ding_target))):
        fn(0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for k in range(8):
                fn(k)
            torch.cuda.synchronize()
        events = prof.key_averages()
        host = sum(e.self_cpu_time_total for e in events) / 8
        device = sum(e.self_device_time_total for e in events) / 8
        top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
        log(f"[graphs-profile] dingdong 1280x720 graphed {what}, per call: self host {host:.1f} "
            f"us, self device {device:.1f} us, {sum(e.count for e in events) / 8:.0f} events; "
            "top host: " + ", ".join(f"{e.key} {e.self_cpu_time_total / 8:.1f} us x"
                                     f"{e.count / 8:g}" for e in top) + f" ({smi})")
    # what one graph keeps on the card: the memory that returns to the
    # device when it is dropped (its private pool and what it holds)
    def released_mb(make, drop):
        make()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kept = torch.cuda.memory_reserved()
        drop()
        gc.collect()
        torch.cuda.empty_cache()
        return (kept - torch.cuda.memory_reserved()) / 2**20

    def drop_step_graph():
        profiled_problem_step.graphs.clear()
        for t in inverse.param_tensors(p_params):
            t.grad = None  # the replays' gradients live in the graph's pool

    frames_cache.clear()
    pool_mb = {
        "forward frame": released_mb(lambda: [forward_call(k) for k in range(2)],
                                     frames_cache.clear),
        "fwd+bwd frame": released_mb(lambda: [fwd_bwd(k) for k in range(2)],
                                     frames_cache.clear),
        "fit step": released_mb(lambda: None, drop_step_graph)}
    log("[graphs] memory one dingdong 1280x720 graph keeps on the card (reserved bytes freed "
        "when it is dropped): " + ", ".join(f"{k} {v:.1f} MiB" for k, v in pool_mb.items())
        + f" ({smi})")
    log(f"[graphs] phase 9e in {time.perf_counter() - t_graphs:.1f} s")

    # --- 9f. the pipeline route as replayed CUDA graphs ---
    # (a function of its own: its names must not rebind the earlier phases')
    def pipeline_graphs() -> int:
        """Phase 9f; returns the render_fwd launches it made (and as many
        pack_frame launches, no pack_vjp)."""
        from tpu_ray_tracer_torch import pipeline_profile

        t_pipe_graphs = time.perf_counter()
        zero_counts()

        # (a), (b) pipeline-route fit steps, graphed against eager with the same
        # capturable Adam: the soft fit annealed by tau_schedule through one
        # capture, and the hard pipeline route
        def pipeline_fit(problem, target, eager, taus):
            params = inverse.extract_params(problem.scene_template.astype(torch.float32),
                                            problem.param_fields)
            optimizer = problem.optimizer(params)
            step = inverse.make_train_step(problem)
            with graphs.eager() if eager else contextlib.nullcontext():
                losses = [step(params, optimizer, camera(), target, tau) for tau in taus]
            return losses, params, step.graphs

        soft_taus = inverse.tau_schedule(0.15, 0.05, FIT_STEPS)
        for label, (problem, target), taus in (
                ("soft clebsch 800x600 coefs+light_color, tau 0.15 -> 0.05",
                 fit_case(clebsch, ["coefs", "light_color"], "torch", soft_tau=0.15), soft_taus),
                ("hard dingdong 1280x720 light_color, backend torch",
                 fit_case(ding, ["light_color"], "torch"), [None] * FIT_STEPS)):
            if inverse.make_loss_fn(problem).use_kernel:
                raise RuntimeError(f"pipeline graphs fit {label}: not the pipeline route")
            loss_fn = inverse.make_loss_fn(problem)
            # one select_rows launch a row block where the coefficients are fitted
            gathers = (-(-problem.scene_template.height // loss_fn.block_rows) * FIT_STEPS
                       if "coefs" in problem.param_fields else 0)
            before = (render_fwd.launches_save_aux, render_bwd.launches, pack_vjp.launches,
                      select_rows.launches)
            want, want_params, _ = pipeline_fit(problem, target, True, taus)
            eager_gathers = select_rows.launches - before[3]
            losses, params, cache = pipeline_fit(problem, target, False, taus)
            launched = (render_fwd.launches_save_aux - before[0], render_bwd.launches - before[1],
                        pack_vjp.launches - before[2])
            graphed_gathers = select_rows.launches - before[3] - eager_gathers
            differ = [k for k in params if not torch.equal(params[k], want_params[k])]
            log(f"[pipeline-graphs] fit {label}: {FIT_STEPS} graphed steps, losses {losses}, "
                f"eager {want}; {cache.captures} captures "
                f"({', '.join(f'{t * 1e3:.1f}' for t in cache.capture_s)} ms), the graph keeps "
                f"{cache.bytes() / 2**30:.3f} GiB, {cache.over_bound} calls over the byte bound; "
                f"select_rows launches eager {eager_gathers}, graphed {graphed_gathers} (want "
                f"{gathers} each) ({smi})")
            if (losses != want or differ or cache.captures != 1 or launched != (0, 0, 0)
                    or (eager_gathers, graphed_gathers) != (gathers, gathers)):
                raise RuntimeError(f"pipeline graphs fit {label}: the graphed steps differ from "
                                   f"the eager ones (params {differ}), {cache.captures} "
                                   f"captures, kernel launches {launched}, select_rows "
                                   f"{(eager_gathers, graphed_gathers)} (want {gathers} each)")
            select_by_path["pipeline_graphs"] = (select_by_path.get("pipeline_graphs", 0)
                                                 + eager_gathers + graphed_gathers)

        # (c) pipeline frames: each key captured at its second call (the
        # reference pose) and replayed at two further poses, bitwise the eager
        # frame; a kept frame unchanged; 20spheres in one shot under the byte
        # bound, then held eager by a bound of one frame
        pipe_cache = pipeline._FRAMES
        pipe_cache.clear()
        captures_before, shared_keys = pipe_cache.captures, {}
        for name, config in (("dingdong", ttt.FAST_CONFIG), ("reflection_test", ttt.FAST_CONFIG),
                             ("clebsch", ttt.FAST_CONFIG), ("cayley", ttt.FAST_CONFIG),
                             ("dingdong", ttt.GOLDEN_CONFIG),
                             ("reflection_test", ttt.GOLDEN_CONFIG)):
            scene, kind = scenes[name], "FAST" if config is ttt.FAST_CONFIG else "GOLDEN"
            captured = pipe_cache.captures
            with torch.no_grad():
                ttt.render_image(scene, poses["reference"], config)
                for label, cam in poses.items():
                    got = ttt.render_image(scene, cam, config)
                    with graphs.eager():
                        want = ttt.render_image(scene, cam, config)
                    if not torch.equal(got, want):
                        raise RuntimeError(f"pipeline graphs {kind} {name} {label}: the graphed "
                                           "frame differs from the eager one")
            new = pipe_cache.captures - captured
            shared_keys[f"{kind} {name}"] = new == 0
            if new != 1 and not (name == "cayley" and new == 0):
                raise RuntimeError(f"pipeline graphs {kind} {name}: {new} captures")
        with torch.no_grad():
            kept = ttt.render_image(ding, poses["yaw 91 pitch 2"])
            copy = kept.clone()
            ttt.render_image(ding, poses["off"])
        if not torch.equal(kept, copy):
            raise RuntimeError("pipeline graphs: a kept frame changed when the next one rendered")
        log(f"[pipeline-graphs] frames: FAST dingdong, reflection_test, clebsch, cayley and "
            f"GOLDEN dingdong, reflection_test equal the eager ones bit for bit at "
            f"{len(poses)} poses ({pipe_cache.captures - captures_before} captures; sharing a "
            f"clebsch key: {[k for k, v in shared_keys.items() if v]}); a kept frame is unchanged "
            f"by the next replay; capture host ms "
            + ", ".join(f"{t * 1e3:.1f}" for t in pipe_cache.capture_s)
            + f"; the cache keeps {pipe_cache.bytes() / 2**30:.3f} GiB in {len(pipe_cache)} graphs "
            f"(bound {graphs.MAX_GRAPH_BYTES / 2**30:.0f} GiB) ({smi})")
        spheres, over = scenes["20spheres"], pipe_cache.over_bound
        keys, captured = set(pipe_cache._entries), pipe_cache.captures
        with torch.no_grad():
            big = [ttt.render_image(spheres, poses["reference"])]
            new_keys = set(pipe_cache._entries) - keys
            if len(new_keys) != 1:
                raise RuntimeError(f"pipeline graphs 20spheres: {len(new_keys)} new keys "
                                   "(want 1)")
            key = next(iter(new_keys))
            warm_bytes = pipe_cache.bytes(key) or 0  # its warm-up's, until it is captured
            big += [ttt.render_image(spheres, poses["reference"]) for _ in range(2)]
            graph_bytes = pipe_cache.bytes(key) or 0
            with graphs.eager():
                want = ttt.render_image(spheres, poses["reference"])
        log(f"[pipeline-graphs] 20spheres {spheres.width}x{spheres.height} FAST in one shot: its "
            f"key's warm-up held {warm_bytes} B ({warm_bytes / 2**30:.3f} GiB), under the "
            f"{graphs.MAX_GRAPH_BYTES / 2**30:.0f} GiB bound, its graph {graph_bytes} B "
            f"({graph_bytes / 2**30:.3f} GiB): {pipe_cache.captures - captured} capture, "
            f"{pipe_cache.over_bound - over} of its 3 calls counted in over_bound ({smi})")
        if (pipe_cache.over_bound - over != 0 or pipe_cache.captures - captured != 1
                or not all(torch.equal(b, want) for b in big)):
            raise RuntimeError(f"pipeline graphs 20spheres: {pipe_cache.over_bound - over} calls "
                               f"over the byte bound (want 0), {pipe_cache.captures - captured} "
                               "captures (want 1), or its frames differ")
        # the byte bound's eager path: with MAX_GRAPH_BYTES at one frame's
        # bytes, the same frame's warm-up is over it, so its next 2 calls run
        # eagerly, counted in over_bound, and nothing is captured
        saved = pipeline._FRAMES, graphs.MAX_GRAPH_BYTES
        pipeline._FRAMES = held_cache = graphs.GraphCache()
        graphs.MAX_GRAPH_BYTES = want.numel() * want.element_size()
        try:
            with torch.no_grad():
                held = [ttt.render_image(spheres, poses["reference"]) for _ in range(3)]
        finally:
            pipeline._FRAMES, graphs.MAX_GRAPH_BYTES = saved
        log(f"[pipeline-graphs] 20spheres FAST in one shot under a bound of one frame "
            f"({want.numel() * want.element_size()} B): {held_cache.over_bound} of its 3 calls "
            f"ran eagerly, counted in over_bound, {held_cache.captures} captures ({smi})")
        if (held_cache.over_bound != 2 or held_cache.captures != 0
                or not all(torch.equal(h, want) for h in held)):
            raise RuntimeError(f"pipeline graphs over the byte bound: {held_cache.over_bound} calls "
                               f"counted (want 2), {held_cache.captures} captures (want 0), or "
                               "its frames differ from the eager one")
        del held, held_cache
        del big, want

        # (d) the >31-light and 0-object gradients (8c's scenes): graphed
        # forward and backward against eager, bit for bit, one render_fwd a
        # frame and no render_bwd
        frames_cache.clear()
        for label, scene, fields in (("33 lights", many, ("light_color", "coefs")),
                                     ("0 objects", empty, ("light_color", "bg_color"))):
            captured = frames_cache.captures
            for k in range(3):  # warm-up, capture and replay, replay
                cam = camera(yaw=90.0 + 0.5 * k, pitch=3.0)
                before = (render_fwd.launches, render_bwd.launches,
                          render_fwd.launches_by_variant["main"], pack_tables.launches,
                          pack_vjp.launches)
                leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in fields}
                image = ttt.render_image_kernel(dataclasses.replace(scene, **leaves), cam)
                image.sum().backward()
                torch.cuda.synchronize()
                launched = (render_fwd.launches - before[0], render_bwd.launches - before[1],
                            render_fwd.launches_by_variant["main"] - before[2],
                            pack_tables.launches - before[3], pack_vjp.launches - before[4])
                with graphs.eager():
                    want_leaves = {f: getattr(scene, f).detach().clone().requires_grad_()
                                   for f in fields}
                    want_image = ttt.render_image_kernel(dataclasses.replace(scene, **want_leaves),
                                                         cam)
                    want_image.sum().backward()
                differ = [f for f in fields if leaves[f].grad is None
                          or not torch.equal(leaves[f].grad, want_leaves[f].grad)]
                if differ or launched != (1, 0, 1, 1, 0) or not torch.equal(image, want_image):
                    raise RuntimeError(f"pipeline graphs fallback {label} call {k}: gradients "
                                       f"{differ} or the frame differ from eager, launches "
                                       f"(fwd, bwd, main, pack_frame, pack_vjp) {launched}")
            if frames_cache.captures != captured + 1:
                raise RuntimeError(f"pipeline graphs fallback {label}: "
                                   f"{frames_cache.captures - captured} captures")
            log(f"[pipeline-graphs] fallback {label} 640x480: graphed frame and gradients "
                f"({', '.join(fields)}) equal the eager ones bit for bit over warm-up, capture and "
                f"replay; one render_fwd (main) and no render_bwd a frame; the cache's graphs "
                f"keep {frames_cache.bytes() / 2**30:.3f} GiB ({smi})")

        # (e) times: CUDA events with the host's gaps, in turns (eager, graphed,
        # graphed, eager), host quiet; then torch.profiler over the same calls
        # (pipeline_profile: device ops, host and device time, busy share) with
        # each graphed call's captures and the bytes its graphs keep
        cases = pipeline_profile.make_cases(dev, PIPE_TIMED_CALLS)
        for label, factory in cases.values():
            for mode in ("eager", "graphed", "graphed", "eager"):
                ms, _ = pipeline_profile.run_case(factory, mode, PIPE_TIMED_CALLS,
                                                  lambda call: timed_ms(call, PIPE_TIMED_CALLS))
                log(f"[pipeline-graphs-time] {label}, {mode}: {ms:.4f} ms a call ({smi})")
        readings = pipeline_profile.profile(
            cases, ("eager", "graphed"), PIPE_TIMED_CALLS,
            lambda line: log(f"[pipeline-graphs-profile] {line} ({smi})"))
        log("[pipeline-graphs-profile] " + json.dumps(readings))
        log(f"[pipeline-graphs] render_fwd launches in 9f: {render_fwd.launches}, pack_frame "
            f"{pack_tables.launches}, pack_vjp {pack_vjp.launches}")
        if (pack_tables.launches, pack_vjp.launches) != (render_fwd.launches, 0):
            raise RuntimeError("pipeline graphs: a render_fwd launch without its pack_frame, or "
                               "a pack_vjp launch")
        log(f"[pipeline-graphs] phase 9f in {time.perf_counter() - t_pipe_graphs:.1f} s")
        return render_fwd.launches

    pipe_graph_launches = pipeline_graphs()

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
                        "render_bwd": render_bwd.launches, "pack_frame": pack_tables.launches,
                        "pack_vjp": pack_vjp.launches}
    # where the world-1 step's time goes: torch.profiler over the same steps
    # without the group and with it, in turns (none, nccl, nccl, none)
    profiles = {"none": [], "nccl": []}
    for label in ("none", "nccl", "nccl", "none"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, prof_times, _ = fit_steps(ding_problem, ding_target, PROFILED_STEPS,
                                         group=group if label == "nccl" else None)
        per_key = {e.key: (e.count / PROFILED_STEPS, e.self_cpu_time_total / PROFILED_STEPS,
                           e.self_device_time_total / PROFILED_STEPS)
                   for e in prof.key_averages()}
        profiles[label].append(per_key)
        calls, host_us, device_us = (sum(v[i] for v in per_key.values()) for i in range(3))
        log(f"[profile] world-1 fit step, group {label}: step ms (profiled) "
            f"{', '.join(f'{t:.4f}' for t in prof_times)}; per step: self host {host_us:.1f} "
            f"us, self device {device_us:.1f} us, {calls:.0f} events ({smi})")

    def mean_of(runs, key):
        return [sum(run.get(key, (0, 0, 0))[i] for run in runs) / len(runs) for i in range(3)]

    keys = set().union(*profiles["none"], *profiles["nccl"])
    extra = sorted(((k, mean_of(profiles["nccl"], k), mean_of(profiles["none"], k))
                    for k in keys), key=lambda t: t[2][1] - t[1][1])
    for k, (n_g, cpu_g, dev_g), (n_0, cpu_0, dev_0) in extra:
        if n_g != n_0:
            log(f"[profile]   {k}: per step with the group {n_g:g} calls, {cpu_g:.1f} us host, "
                f"{dev_g:.1f} us device; without {n_0:g}, {cpu_0:.1f} us, {dev_0:.1f} us")
    dist.destroy_process_group()
    # a group of one all-reduces nothing, as JAX's psum over one device
    reduced = sorted({k for run in profiles["nccl"] for k in run
                      if "allreduce" in k.replace("_", "").lower()})
    if reduced:
        raise RuntimeError(f"sharded world 1: the fit step ran a collective: {reduced}")
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
                            "render_bwd": FIT_STEPS, "pack_frame": FIT_STEPS + 1,
                            "pack_vjp": FIT_STEPS}:
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
            "render_bwd": FIT_STEPS, "pack_frame": FIT_STEPS + 2, "pack_vjp": FIT_STEPS}
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

    # --- 11. the port's bench, at full size, as its user runs it ---
    t_bench = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRT_BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "tpu_ray_tracer_torch.bench"], cwd=REPO,
                          env={**env, "PYTHONPATH": REPO}, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    bench_s = time.perf_counter() - t_bench
    with open(os.path.join(out_dir, "bench.err"), "w") as f:
        f.write(proc.stderr)
    try:
        result = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        result = {}
    aux = result.get("aux", {})
    log(f"[bench] {json.dumps(result)}")
    want_launches = bench_launches(BENCH_FRAMES)
    bench_counts = aux.get("launches", {})
    parity_bench = aux.get("parity_bad_px_fraction", {})
    problems = [what for what, bad in (
        (f"exit {proc.returncode}", proc.returncode != 0),
        ("no headline line", result.get("metric") != "mrays_per_s_fwd_dingdong_1280x720"),
        (f"failed {aux.get('failed')}", "failed" in aux),
        (f"skipped {aux.get('skipped')}", "skipped" in aux or "pending" in aux),
        (f"parity {parity_bench}", set(parity_bench) != set(PARITY_GATES) or any(
            v > PARITY_GATES[k] for k, v in parity_bench.items())),
        (f"forward_backend {aux.get('forward_backend')}", aux.get("forward_backend") != "cuda"),
        (f"launches {bench_counts}, expected {want_launches}",
         any(bench_counts.get(k) != v for k, v in want_launches.items())),
    ) if bad]
    if problems:
        raise RuntimeError(f"bench: {'; '.join(problems)}\n{proc.stderr[-4000:]}")
    log(f"[bench] {result['metric']} {result['value']} {result['unit']} (vs_baseline "
        f"{result['vs_baseline']}); dingdong: frame_ms_fwd {aux['frame_ms_fwd_dingdong']}, "
        f"kernel_ms_fwd {aux['kernel_ms_fwd_dingdong']}, frame_ms_fwd_bwd "
        f"{aux['frame_ms_fwd_bwd_dingdong']}, kernel_ms_bwd {aux['kernel_ms_bwd_dingdong']}, "
        f"parity {parity_bench['dingdong']}; launches {bench_counts}; phase 11 in "
        f"{bench_s:.1f} s ({smi})")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # the sharded paths' launches: 10a in this process, 10b in both ranks
    sharded_fwd = sharded_launches["render_fwd"] + sum(r["launches"]["render_fwd"] for r in ranks)
    sharded_bwd = sharded_launches["render_bwd"] + sum(r["launches"]["render_bwd"] for r in ranks)
    sharded_pack = {k: sharded_launches[k] + sum(r["launches"][k] for r in ranks)
                    for k in ("pack_frame", "pack_vjp")}
    pack_by_path = {"forward": main_pack[0], "gradient": grad_launches["pack_frame"],
                    "cli": cli_pack, "fallback": fallback_launches,
                    "fit": fit_launches["pack_frame"], "graphs": graph_launches["pack_frame"],
                    "pipeline_graphs": pipe_graph_launches, "sharded": sharded_pack["pack_frame"],
                    "bench": bench_counts["pack_frame"]}
    vjp_by_path = {"gradient": grad_launches["pack_vjp"], "fit": fit_launches["pack_vjp"],
                   "graphs": graph_launches["pack_vjp"], "sharded": sharded_pack["pack_vjp"],
                   "bench": bench_counts["pack_vjp"]}
    pack_common = {"route": "cuda", "source": "tpu_ray_tracer_torch/csrc/pack.cu",
                   "library_ms": None, "frame_ops": pack["frame_ops"]}
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/render_fwd.cu",
        "replaces": "tpu_ray_tracer/render/pallas_backend.py:978",
        "launches": (main_launches + grad_launches["render_fwd"] + cli_launches
                     + fallback_launches + fit_launches["render_fwd"]
                     + graph_launches["render_fwd"] + pipe_graph_launches + sharded_fwd
                     + bench_counts["render_fwd"]),
        "launches_by_path": {"forward": main_launches, "gradient": grad_launches["render_fwd"],
                             "cli": cli_launches, "fallback": fallback_launches,
                             "fit": fit_launches["render_fwd"],
                             "graphs": graph_launches["render_fwd"],
                             "pipeline_graphs": pipe_graph_launches, "sharded": sharded_fwd,
                             "bench": bench_counts["render_fwd"]},
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
        "launches": (grad_launches["render_bwd"] + fit_launches["render_bwd"]
                     + graph_launches["render_bwd"] + sharded_bwd + bench_counts["render_bwd"]),
        "launches_by_path": {"gradient": grad_launches["render_bwd"],
                             "fit": fit_launches["render_bwd"],
                             "graphs": graph_launches["render_bwd"], "sharded": sharded_bwd,
                             "bench": bench_counts["render_bwd"]},
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
    }, {
        "name": "pack_frame",
        **pack_common,
        "replaces": "tpu_ray_tracer/render/pallas_backend.py:1464-1478, :1139 (XLA's fusion of "
                    "the packing in _render_pallas_jit; not a Pallas kernel)",
        "launches": sum(pack_by_path.values()),
        "launches_by_path": pack_by_path,
        "max_abs_err": pack["max_abs_err"]["pack_frame"],
        "worst_ulps_vs_plain": pack["worst_ulps"],
        **{k: pack["pack_frame"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "share_of_bound": pack["pack_frame"]["bound_ms"] / pack["pack_frame"]["ms"],
        "frame_ms_fwd_dingdong": aux["frame_ms_fwd_dingdong"],
        "mrays_fwd_dingdong": result["value"],
    }, {
        "name": "pack_vjp",
        **pack_common,
        "replaces": "tpu_ray_tracer/render/pallas_backend.py:2073-2118 (XLA's fusion of the "
                    "packing's VJP after _packed_bwd; not a Pallas kernel)",
        "launches": sum(vjp_by_path.values()),
        "launches_by_path": vjp_by_path,
        "max_abs_err": pack["max_abs_err"]["pack_vjp"],
        "angle_relerr_vs_plain": pack["vjp_angle_rel"],
        **{k: pack["pack_vjp"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "share_of_bound": pack["pack_vjp"]["bound_ms"] / pack["pack_vjp"]["ms"],
        "frame_ms_fwd_bwd_dingdong": aux["frame_ms_fwd_bwd_dingdong"],
    }, {
        "name": "select_rows",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/select_rows.cu",
        "replaces": "tpu_ray_tracer/render/pipeline.py:93, :95, :150, :187 (the scatter-add XLA "
                    "emits for the transpose of the pipeline's gathers; not a Pallas kernel)",
        "launches": sum(select_by_path.values()),
        "launches_by_path": select_by_path,
        "relerr_vs_f64": select["rel_err"],
        "relerr_vs_f64_aten": select["rel_err_aten"],
        # clebsch 800x600's first soft row block; the second beside it
        **{k: select["blocks"][SELECT_ROWS[0]][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "aten index_put_(accumulate=True), autograd's backward of table[idx]",
        "share_of_bound": (select["blocks"][SELECT_ROWS[0]]["bound_ms"]
                           / select["blocks"][SELECT_ROWS[0]]["ms"]),
        "rows": SELECT_ROWS[0],
        "second_block": {"rows": SELECT_ROWS[1], **select["blocks"][SELECT_ROWS[1]]},
    }, {
        "name": "solve_roots",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/solve_roots.cu",
        "replaces": "tpu_ray_tracer/ops/intersect.py:37-54 (XLA's fusion of intersect_all; not "
                    "a Pallas kernel)",
        "launches": sum(solve_by_path.values()),
        "launches_by_path": solve_by_path,
        "worst_ulps_vs_plain": 0,
        "library_ms": None,
        # clebsch 800x600's soft render by row blocks, its four calls
        "calls": solve["solve_roots"]["calls"],
    }, {
        "name": "roots_excluding_pair",
        "route": "cuda",
        "source": "tpu_ray_tracer_torch/csrc/solve_roots.cu",
        "replaces": "tpu_ray_tracer/diff/soft.py _roots_excluding_pair (plain JAX; not a "
                    "Pallas kernel)",
        "launches": sum(excluding_by_path.values()),
        "launches_by_path": excluding_by_path,
        "worst_ulps_vs_plain": 0,
        "library_ms": None,
        # branch B's two calls, one a row block
        "calls": solve["roots_excluding_pair"]["calls"],
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
    from tpu_ray_tracer_torch.render.pack_kernel import pack_tables, pack_vjp

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
    pack_tables.launches = pack_vjp.launches = 0
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
                "render_bwd": render_bwd.launches, "pack_frame": pack_tables.launches,
                "pack_vjp": pack_vjp.launches}
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
