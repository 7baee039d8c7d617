"""Benchmark of the port: forward and forward+backward Mrays/s of the kernel
path on the bundled scenes, with a parity gate, printed as one JSON line.

    python -m tpu_ray_tracer_torch.bench [--device cuda|cpu]

The counterpart of the JAX package's ``bench.py`` (the repository root),
under its contract: the headline ``mrays_per_s_fwd_dingdong_1280x720`` is
scenes/dingdong.yml at 1280x720 (the reference's published datapoint,
~25 ms / ~36.9 Mrays/s for its CUDA backend on an unnamed NVIDIA GPU,
BASELINE.md), ``vs_baseline`` its ratio to that figure; monkey_saddle,
20spheres, the 5-bounce reflection scene and the remaining four scenes are
aux figures, as is forward+backward throughput (gradients of mean(img^2)
with respect to the surface coefficients and light colours through the
fused backward kernel).

A complete cumulative JSON line is printed after every stage, headline
first; a wall-clock budget (``TRT_BENCH_BUDGET_S``, default 1500 s) is
checked between stages and the stages that would not fit are listed under
``aux.skipped``; progress and a heartbeat go to stderr. ``TRT_BENCH_FRAMES``
(default 32) sets the frames of each sweep and ``TRT_BENCH_SCALE`` (default
1) scales every scene's resolution, which replaces the committed goldens by
live ones from the port's NumPy oracle.

Timing: the JAX bench's yaw sweep 90 + 1e-3 k, pitch 0, from the origin.
A forward frame is the whole ``render_image_kernel`` call (statics,
packing, the launch), each reduced to a sum kept on the device. As the JAX
bench times one executable over the sweep (``fwd_many``, ``fwdbwd_many``),
the sweep (its frames plus the parity frame; or its ``frame_grads``) is
captured as one CUDA graph after its eager warm-up on a side stream
(``render/graphs.py``), replayed once warm, and timed by CUDA events around
one more replay, divided by its frames. Beside each whole-call reading,
``kernel_ms_fwd_<scene>`` and ``kernel_ms_bwd_<scene>`` give the kernel
alone: the device time of the sweep's launches, proven to have run back to
back (``kernel_bench.timed_ms``, whose gate reruns a reading that host gaps
could have entered). ``launches`` counts the kernels' launches that
executed over the run (the warm-ups' and each replay's, none for a
capture), so a run that missed a kernel shows it; it leaves out the
launches of each kernel reading's sizing pass and discarded runs, which go
to stderr.
On the CPU (``--device cpu``) every call runs the kernels' plain versions,
the host clock times the sweeps after one warm-up frame, no graph is
captured, and there is no kernel reading.

Parity is a gate: each forward stage's frame at the reference pose against
the f64 golden ``bench_goldens/<scene>.npz`` within
``parity.PARITY_GATES``. The process exits nonzero when no headline was
measured, when a parity gate is exceeded, or when any stage raised (the
other stages still run and the failed one is listed under ``aux.failed``);
the JAX bench exits 0 in that last case.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.metadata
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .diff.inverse import apply_params, extract_params
from .kernel_bench import timed_ms
from .models.loader import load_from_file
from .ops.camera import Camera
from .parity import PARITY_GATES, bad_pixel_fraction
from .render import _build, graphs
from .render.bwd_kernel import render_bwd
from .render.fwd_kernel import render_fwd
from .render.kernel_backend import pack_frame, render_image_kernel
from .render.reference_cpu import render_image_np
from .utils.device import smi_line

REPO = Path(__file__).resolve().parents[1]
BASELINE_MRAYS = 36.864  # 921600 px / 25 ms (BASELINE.md, derived row 1)
BASELINE_MRAYS_MONKEY = 28.235  # 480000 px / 17 ms (BASELINE.md, derived row 2)
POLISH_ITERS = 3
HEARTBEAT_S = 60.0
# the reflective scene runs its full 5-bounce chain -> distinct key
DISPLAY = {"reflection_test": "reflection5b"}
EXTRA_SCENES = ("quadratic", "cubic", "clebsch", "cayley")


class _Progress:
    """Elapsed time, the current stage, and the stderr log with a heartbeat
    thread that runs while the object is entered."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.stage = "startup"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def log(self, msg: str) -> None:
        print(f"[bench t={self.elapsed():7.1f}s] {msg}", file=sys.stderr, flush=True)

    def _beat(self):
        while not self._stop.wait(HEARTBEAT_S):
            self.log(f"heartbeat: stage={self.stage}")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def load_scene(name: str, scale: float, device):
    """A bundled scene on ``device``, its resolution scaled (at least 8x8)."""
    scene = load_from_file(REPO / "scenes" / f"{name}.yml", device=device)
    if scale != 1:
        scene = dataclasses.replace(scene, width=max(8, int(scene.width * scale)),
                                    height=max(8, int(scene.height * scale)))
    return scene


def sweep_cameras(frames: int, device) -> list:
    """The JAX bench's poses: yaw 90 + 1e-3 k (in f32), pitch 0, origin."""
    yaws = 90.0 + 1e-3 * torch.arange(frames, dtype=torch.float32, device=device)
    zeros = torch.zeros(3, dtype=torch.float32, device=device)
    return [Camera(position=zeros, yaw_deg=yaws[k], pitch_deg=zeros[0]) for k in range(frames)]


def frame(scene, camera, bounces: int) -> torch.Tensor:
    """One forward frame as the bench times it: the whole
    ``render_image_kernel`` call at polish 3 and an explicit bounce count."""
    return render_image_kernel(scene, camera, polish_iters=POLISH_ITERS, bounces=bounces)


def frame_grads(template, params: dict, camera, bounces: int) -> dict:
    """{field: gradient} of mean(img^2) with respect to ``params`` (leaves
    grafted onto ``template``), through ``frame`` and the fused backward.
    ``autograd.grad`` leaves ``.grad`` alone, so frames do not accumulate."""
    with torch.enable_grad():
        image = frame(apply_params(template, params), camera, bounces)
        grads = torch.autograd.grad((image * image).mean(), list(params.values()))
    return dict(zip(params, grads))


def sweep_graph(device, body) -> graphs.Captured:
    """The CUDA graph of a sweep ``body()``: its eager warm-up on a side
    stream, its capture, one warm replay."""
    graphs.warmup(device, body)
    sweep = graphs.capture(device, body)
    graphs.replay(sweep)
    torch.cuda.synchronize(device)
    return sweep


def _sweep_s(device, body, warmup):
    """(seconds, outputs) of one sweep ``body()``. On the card the body's
    graph (``sweep_graph``) is replayed once more between CUDA events, and
    the outputs are a fresh copy of that replay's; on the CPU ``warmup()``
    runs, then the body under the host clock."""
    if device.type != "cuda":
        warmup()
        t0 = time.perf_counter()
        out = body()
        return time.perf_counter() - t0, out
    sweep = sweep_graph(device, body)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graphs.replay(sweep)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3, graphs.fresh(sweep.outputs)


def _kernel_ms(progress: _Progress, fn, frames: int, extra_launches: dict) -> float:
    """``timed_ms(fn, frames, device_only=True)``. Its sizing pass and
    discarded runs call ``fn`` ``Gate.extra_calls`` more times, each
    launching what a call of the accepted run does: those launches are added
    to ``extra_launches`` (by ``launch_counts`` key) and logged."""
    before = graphs.launch_counts()
    ms = timed_ms(fn, frames, device_only=True)
    gate = timed_ms.last_gate
    after = graphs.launch_counts()
    added = {k: (after[k] - before[k]) * gate.extra_calls // (frames + gate.extra_calls)
             for k in after}
    for k, v in added.items():
        extra_launches[k] = extra_launches.get(k, 0) + v
    left_out = {k: v for k, v in added.items() if v}
    progress.log(f"gate: sleep {gate.cycles} cycles, {gate.reruns} reruns, host enqueue "
                 f"{gate.enqueue_ms:.4f} ms a call; launches left out of the count: {left_out}")
    return ms


def _load_golden(progress: _Progress, name: str, scene, scale: float) -> np.ndarray:
    """The committed f16 golden when unscaled and of the scene's shape, else
    the port's f64 NumPy oracle, live."""
    path = REPO / "bench_goldens" / f"{name}.npz"
    if scale == 1 and path.exists():
        golden = np.load(path)["image"].astype(np.float32)
        if golden.shape == (scene.height, scene.width, 3):
            return golden
        progress.log(f"golden {name}: committed shape {golden.shape} stale, recomputing")
    progress.log(f"golden {name}: computing live (NumPy f64)")
    return render_image_np(scene)


def _bench_fwd(progress: _Progress, name: str, scene, *, frames: int, scale: float,
               extra_launches: dict, bounces: int = 0) -> dict:
    """Forward throughput over the sweep plus the parity frame at the
    reference pose (one graph replay of frames + 1 frames on the card), the
    kernel alone over the sweep's tables on the card (``_kernel_ms``), and
    the parity frame's bad-pixel fraction."""
    device = scene.coefs.device
    scene32 = scene.astype(torch.float32)
    n_px = scene.width * scene.height
    cams = sweep_cameras(frames, device)
    ref_cam = Camera.initial(torch.float32, device)

    def sweep():
        sums = [frame(scene32, c, bounces).sum() for c in cams]
        image = frame(scene32, ref_cam, bounces)
        sums.append(image.sum())
        return torch.stack(sums), image

    with torch.no_grad():
        progress.stage = f"{name}:fwd measure"
        progress.log(f"{name}: warm-up (builds the kernel at first use), then the sweep")
        seconds, (sums, image) = _sweep_s(device, sweep,
                                          lambda: frame(scene32, ref_cam, bounces))
        fwd_s = seconds / (frames + 1)
        if not torch.isfinite(sums).all():
            raise RuntimeError(f"{name}: a frame of the sweep is not finite")
        progress.log(f"{name}: fwd {fwd_s * 1e3:.3f} ms/frame ({n_px / fwd_s / 1e6:.1f} Mrays/s)")
        out = {"frame_ms_fwd": fwd_s * 1e3, "mrays_fwd": n_px / fwd_s / 1e6}
        if device.type == "cuda":
            packed = [pack_frame(scene32, c, 0, scene.height, polish_iters=POLISH_ITERS,
                                 bounces=bounces) for c in cams]
            out["kernel_ms_fwd"] = _kernel_ms(
                progress, lambda k: render_fwd(*packed[k][0], **packed[k][1]), frames,
                extra_launches)
            progress.log(f"{name}: render_fwd alone {out['kernel_ms_fwd']:.4f} ms/frame")

    progress.stage = f"{name}:parity"
    golden = _load_golden(progress, name, scene, scale)
    out["parity_bad_px_fraction"] = bad_pixel_fraction(image.cpu().numpy(), golden)
    progress.log(f"{name}: parity bad-px fraction {out['parity_bad_px_fraction']:.6f}")
    return out


def _bench_fwdbwd(progress: _Progress, name: str, scene, *, frames: int,
                  extra_launches: dict, bounces: int = 0) -> dict:
    """Forward+backward throughput over the sweep (``frame_grads`` of the
    coefficients and light colours, each frame's gradients reduced to one
    device scalar; one graph replay on the card), and the backward kernel
    alone on the sweep's aux on the card (``_kernel_ms``).

    The JAX bench fixes the kernel's degree partition from the concrete
    scene before ``jax.grad`` (where the coefficients are abstract); here
    ``render_image_kernel`` always derives it from the tables, memoised on
    the leaves, which stay the same tensors across the frames."""
    device = scene.coefs.device
    template = scene.astype(torch.float32)
    params = extract_params(template)
    n_px = scene.width * scene.height
    cams = sweep_cameras(frames, device)

    def step(camera):
        return sum(g.sum() for g in frame_grads(template, params, camera, bounces).values())

    progress.stage = f"{name}:fwdbwd measure"
    progress.log(f"{name}: fwd+bwd warm-up, then the sweep")
    seconds, sums = _sweep_s(device, lambda: torch.stack([step(c) for c in cams]),
                             lambda: step(cams[0]))
    if not torch.isfinite(sums).all():
        raise RuntimeError(f"{name}: a gradient of the sweep is not finite")
    fwdbwd_s = seconds / frames
    progress.log(f"{name}: fwd+bwd {fwdbwd_s * 1e3:.3f} ms/frame "
                 f"({n_px / fwdbwd_s / 1e6:.1f} Mrays/s)")
    out = {"frame_ms_fwd_bwd": fwdbwd_s * 1e3, "mrays_fwd_bwd": n_px / fwdbwd_s / 1e6}
    if device.type == "cuda":
        with torch.no_grad():
            calls = []
            for c in cams:
                tables, kw = pack_frame(template, c, 0, scene.height, polish_iters=POLISH_ITERS,
                                        bounces=bounces)
                image, *aux = render_fwd(*tables, **kw, save_aux=True)
                cotangent = (2.0 / image.numel()) * image  # d mean(img^2) / d img
                calls.append(((tables[0], tables[2], tables[3], tables[4], tables[7], cotangent,
                               *aux),
                              dict(width=kw["width"], height=kw["height"], rows=kw["rows"],
                                   n_lights=tables[4].shape[0], bounces=kw["bounces"])))
            out["kernel_ms_bwd"] = _kernel_ms(
                progress, lambda k: render_bwd(*calls[k][0], **calls[k][1]), frames,
                extra_launches)
        progress.log(f"{name}: render_bwd alone {out['kernel_ms_bwd']:.4f} ms/frame")
    return out


def _nvcc_version():
    try:
        proc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                              timeout=60)
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[-1] if proc.returncode == 0 else None


def _triton_version():
    try:
        return importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        return None


def run_info(device) -> dict:
    """The aux keys that name what ran: ``forward_backend``, ``device`` (the
    card's name and power limit as nvidia-smi gives them) and ``versions``."""
    if device.type == "cuda":
        where, backend = smi_line(torch.cuda.current_device()), "cuda"
    else:
        where, backend = "cpu", "plain"
    return {"forward_backend": backend, "device": where,
            "versions": {"torch": torch.__version__, "cuda": torch.version.cuda,
                         "nvcc": _nvcc_version(), "triton": _triton_version()}}


def _emit(results: dict, pending, skipped, elapsed_s: float, run: dict) -> None:
    """Print one complete cumulative JSON line from whatever is measured so
    far (nothing before the headline): the JAX bench's keys, then
    ``kernel_ms_*`` and ``run``'s keys (``launches`` and ``run_info``'s)."""
    ding = results.get("dingdong", {})
    if "mrays_fwd" not in ding:
        return
    aux = {"frame_ms_fwd_dingdong": round(ding["frame_ms_fwd"], 3)}
    for key, r in results.items():
        name = DISPLAY.get(key, key)
        if key != "dingdong" and "mrays_fwd" in r:
            aux[f"mrays_per_s_fwd_{name}"] = round(r["mrays_fwd"], 2)
        if "mrays_fwd_bwd" in r:
            aux[f"mrays_per_s_fwd_bwd_{name}"] = round(r["mrays_fwd_bwd"], 2)
    if "mrays_fwd_bwd" in ding:
        aux["frame_ms_fwd_bwd_dingdong"] = round(ding["frame_ms_fwd_bwd"], 3)
    monkey = results.get("monkey_saddle", {})
    if "mrays_fwd" in monkey:
        aux["monkey_saddle_vs_baseline"] = round(monkey["mrays_fwd"] / BASELINE_MRAYS_MONKEY, 3)
    spheres = results.get("20spheres", {})
    if "mrays_fwd" in spheres:
        aux["frame_ms_fwd_20spheres"] = round(spheres["frame_ms_fwd"], 3)
    aux["parity_bad_px_fraction"] = {k: round(v["parity_bad_px_fraction"], 6)
                                     for k, v in results.items()
                                     if "parity_bad_px_fraction" in v}
    failed = sorted(s for v in results.values() for s in v.get("failed_stages", ()))
    if failed:
        aux["failed"] = failed
    if pending:
        aux["pending"] = list(pending)
    if skipped:
        aux["skipped"] = list(skipped)
    aux["elapsed_s"] = round(elapsed_s, 1)
    for key, r in results.items():
        for which in ("fwd", "bwd"):
            if f"kernel_ms_{which}" in r:
                aux[f"kernel_ms_{which}_{DISPLAY.get(key, key)}"] = round(
                    r[f"kernel_ms_{which}"], 5)
    aux.update(run)
    print(json.dumps({
        "metric": "mrays_per_s_fwd_dingdong_1280x720",
        "value": round(ding["mrays_fwd"], 2),
        "unit": "Mrays/s",
        "vs_baseline": round(ding["mrays_fwd"] / BASELINE_MRAYS, 3),
        "aux": aux,
    }), flush=True)


def stages(scene_for, frames: int, scale: float, progress: _Progress,
           extra_launches: dict) -> list:
    """The JAX bench's 12 stages in its order, headline first:
    (stage name, scene key, callable)."""
    refl = "reflection_test"
    fwd = functools.partial(_bench_fwd, progress, frames=frames, scale=scale,
                            extra_launches=extra_launches)
    fwdbwd = functools.partial(_bench_fwdbwd, progress, frames=frames,
                               extra_launches=extra_launches)
    out = []
    for name in ("dingdong", "monkey_saddle"):
        out.append((f"{name}.fwd", name, lambda n=name: fwd(n, scene_for(n))))
        out.append((f"{name}.fwdbwd", name, lambda n=name: fwdbwd(n, scene_for(n))))
    # the reflective scene runs its full 5-bounce chain, forward and backward
    out.append((f"{refl}.fwd", refl, lambda: fwd(
        refl, scene_for(refl), bounces=scene_for(refl).max_reflections)))
    out.append((f"{refl}.fwdbwd", refl, lambda: fwdbwd(
        refl, scene_for(refl), bounces=scene_for(refl).max_reflections)))
    # 20 objects x 19 lights: the backward's widest accumulator
    out.append(("20spheres.fwd", "20spheres", lambda: fwd("20spheres", scene_for("20spheres"))))
    out.append(("20spheres.fwdbwd", "20spheres",
                lambda: fwdbwd("20spheres", scene_for("20spheres"))))
    for name in EXTRA_SCENES:
        out.append((f"{name}.fwd", name, lambda n=name: fwd(n, scene_for(n))))
    return out


def _run(progress: _Progress, device, frames: int, budget_s: float, scale: float) -> int:
    progress.log(f"starting: budget={budget_s:.0f}s scale={scale} frames={frames} "
                 f"device={device}")
    progress.stage = "device probe"
    info = run_info(device)
    progress.log(f"device: {info['device']} ({info['forward_backend']}) {info['versions']}")
    scenes = {}

    def scene_for(name):
        if name not in scenes:
            scenes[name] = load_scene(name, scale, device)
        return scenes[name]

    start_counts = graphs.launch_counts()
    extra_launches = {}  # the kernel readings' sizing passes and discarded runs
    results = {}

    def emit(pending, skipped):
        now = graphs.launch_counts()
        _emit(results, pending, skipped, progress.elapsed(),
              {"launches": {k: now[k] - start_counts[k] - extra_launches.get(k, 0)
                            for k in now}, **info})

    stage_list = stages(scene_for, frames, scale, progress, extra_launches)
    skipped = []
    for i, (stage_name, scene_key, run) in enumerate(stage_list):
        remaining = [s[0] for s in stage_list[i + 1:]]
        if progress.elapsed() > budget_s and "dingdong" in results:
            progress.log(f"budget exhausted ({progress.elapsed():.0f}s > {budget_s:.0f}s): "
                         f"skipping {stage_name} and the rest")
            skipped = [stage_name] + remaining
            break
        progress.stage = stage_name
        try:
            out = run()
        except Exception as exc:  # one broken stage must not stop the rest
            progress.log(f"STAGE FAILED {stage_name}: {type(exc).__name__}: {exc}")
            traceback.print_exc(file=sys.stderr)
            results.setdefault(scene_key, {}).setdefault("failed_stages", []).append(stage_name)
            emit(remaining, [])
            continue
        results.setdefault(scene_key, {}).update(out)
        emit(remaining, [])
    emit([], skipped)

    if "mrays_fwd" not in results.get("dingdong", {}):
        print("BENCH FAILED: headline stage dingdong.fwd produced no result", file=sys.stderr)
        return 1
    rc = 0
    failed = sorted(s for v in results.values() for s in v.get("failed_stages", ()))
    if failed:
        print(f"BENCH FAILED: stages raised: {', '.join(failed)}", file=sys.stderr)
        rc = 1
    over = [f"{k}: {v['parity_bad_px_fraction']:.6f} > {PARITY_GATES[k]}"
            for k, v in results.items()
            if "parity_bad_px_fraction" in v and v["parity_bad_px_fraction"] > PARITY_GATES[k]]
    if over:
        print("PARITY GATE FAILED: " + "; ".join(over), file=sys.stderr)
        rc = 1
    progress.log("done" if rc == 0 else "done, with failures")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a CUDA device) or cpu, which "
                         "runs the kernels' plain versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is false; run on a CUDA device or "
                         "pass --device cpu")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"bench: no kernel path for device {device}")
    frames = int(os.environ.get("TRT_BENCH_FRAMES", "32"))
    budget_s = float(os.environ.get("TRT_BENCH_BUDGET_S", "1500"))
    scale = float(os.environ.get("TRT_BENCH_SCALE", "1"))
    with _Progress() as progress:
        return _run(progress, device, frames, budget_s, scale)


if __name__ == "__main__":
    sys.exit(main())
