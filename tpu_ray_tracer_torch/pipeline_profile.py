"""Where the pipeline route's time goes on the card, eager and as replayed
CUDA graphs.

    python -m tpu_ray_tracer_torch.pipeline_profile

Five calls at full size, from the bundled scenes:

* ``soft_step``: a soft-visibility fit step on the pipeline route, the
  BASELINE.json problem (clebsch 800x600, coefs and light colours x0.6, the
  temperature annealed 0.15 -> 0.05 over the calls by ``tau_schedule``);
* ``hard_step``: a hard fit step on the pipeline route (dingdong 1280x720,
  ``backend="torch"``, light colours x0.6, polish 2);
* ``fast_frame`` and ``golden_frame``: ``render_image`` of dingdong
  1280x720 at ``FAST_CONFIG`` and ``GOLDEN_CONFIG``, without a gradient;
* ``fallback``: a 33-light 640x480 scene through ``render_image_kernel``
  and ``backward()`` (one K1 launch, the gradient recomputed through the
  pipeline).

Each call runs at the yaws 90 + 1e-3 k. For each mode (``eager`` runs
inside ``graphs.eager()``; ``graphed`` as a user calls it, its graph cache
emptied first) the call is made twice untimed (a key's warm-up and its
capture), then ``CALLS`` times by the host's clock around the calls and a
synchronize (the wall time a call, and the peak device memory above what
was allocated before them), then ``CALLS`` times under torch.profiler: the
device's operations a call (kernels, copies and fills), the CUDA runtime's
calls a call by name, the device time a call, and the device's busy share,
device time over wall time. A graphed reading adds its cache's captures,
each capture's host time, the bytes its graphs keep (what their captures
reserved) and the calls the byte bound held eager. ``profile`` makes the
readings for any cases and modes. Needs one CUDA device; prints one line a
reading and, as its last line, one JSON object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .utils.device import smi_line
from .utils.timing import events_by_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 5  # the calls timed, and profiled, a reading


def _camera(dev, yaw=90.0, pitch=0.0):
    from .ops.camera import Camera

    return Camera(position=torch.zeros(3, dtype=torch.float32, device=dev),
                  yaw_deg=torch.tensor(yaw, dtype=torch.float32, device=dev),
                  pitch_deg=torch.tensor(pitch, dtype=torch.float32, device=dev))


def many_lights_scene(dev, n_lights: int = 33, width: int = 640, height: int = 480):
    """A sphere over a plane lit by ``n_lights`` directional lights in a
    fan: more lights than the fused backward encodes."""
    from .models import light as tlight
    from .models import surface as tsurface
    from .models.scene import Object, build_scene

    objects = [Object(tsurface.sphere((0.0, 0.0, 6.0), 2.0), 0.0, np.float32([0.8, 0.3, 0.2])),
               Object(tsurface.plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0)), 0.0,
                      np.float32([0.2, 0.6, 0.9]))]
    lights = [tlight.directional(
        0.08, (np.cos(2 * np.pi * i / n_lights) * 0.5, -1.0,
               np.sin(2 * np.pi * i / n_lights) * 0.5 + 0.3),
        (1.0, 1.0 - 0.5 * (i % 3) / 2.0, 0.5 + 0.5 * (i % 2))) for i in range(n_lights)]
    return build_scene(width, height, 60.0, objects, lights, bg_color=(0.1, 0.1, 0.1),
                       device=dev)


def fit_problem(scene, fields, backend, soft_tau=None):
    """(problem, target) of a self-recovery fit as the CLI's fit builds
    it: the target rendered by the kernels at the reference pose, the
    optimized fields perturbed by 0.6, polish 2, learning rate 5e-2."""
    from . import cli
    from .diff.inverse import InverseProblem
    from .render.kernel_backend import render_image_kernel
    from .render.pipeline import RenderConfig

    with torch.no_grad():
        target = render_image_kernel(scene, _camera(scene.coefs.device), polish_iters=2,
                                     bounces=0)
    problem = InverseProblem(
        scene_template=cli._perturb_scene(scene, fields, 0.6),
        config=RenderConfig("float32", polish_iters=2, chunk_px=None),
        param_fields=tuple(fields), learning_rate=5e-2, backend=backend, soft_tau=soft_tau)
    return problem, target


def step_call(problem, target, taus=None):
    """``call(k)``: one train step of a fresh train step, parameters and
    optimizer, at ``taus[k % len(taus)]`` when given; returns the loss."""
    from .diff.inverse import extract_params, make_train_step

    params = extract_params(problem.scene_template.astype(problem.config.dtype),
                            problem.param_fields)
    optimizer = problem.optimizer(params)
    step = make_train_step(problem)
    cam = _camera(target.device)

    def call(k):
        return step(params, optimizer, cam, target,
                    None if taus is None else taus[k % len(taus)])

    call.cache = lambda: step.graphs
    return call


def make_cases(dev, calls: int) -> dict:
    """name -> (label, factory): ``factory()`` returns a fresh ``call(k)``
    whose ``cache()`` is the ``GraphCache`` it replays from, read only for a
    graphed reading."""
    from .diff.inverse import tau_schedule
    from .models.loader import load_from_file
    from .render import kernel_backend, pipeline
    from .render.kernel_backend import render_image_kernel
    from .render.pipeline import FAST_CONFIG, GOLDEN_CONFIG, render_image

    def load(name):
        return load_from_file(os.path.join(REPO, "scenes", name + ".yml"), device=dev)

    ding, clebsch = load("dingdong"), load("clebsch")
    cams = [_camera(dev, 90.0 + 1e-3 * k) for k in range(calls + 2)]
    soft = fit_problem(clebsch, ["coefs", "light_color"], "torch", soft_tau=0.15)
    hard = fit_problem(ding, ["light_color"], "torch")
    many = many_lights_scene(dev)

    def frame(config):
        def call(k):
            with torch.no_grad():
                return render_image(ding, cams[k], config)
        call.cache = lambda: pipeline._FRAMES
        return call

    def fallback():
        scene = dataclasses.replace(many, light_color=many.light_color.clone().requires_grad_(),
                                    coefs=many.coefs.clone().requires_grad_())

        def call(k):
            render_image_kernel(scene, cams[k]).sum().backward()
        call.cache = lambda: kernel_backend._FRAMES
        return call

    return {
        "soft_step": ("clebsch 800x600 soft pipeline fit step (coefs+light_color, tau 0.15 -> "
                      "0.05)", lambda: step_call(*soft, tau_schedule(0.15, 0.05, calls))),
        "hard_step": ("dingdong 1280x720 hard pipeline fit step (light_color, polish 2)",
                      lambda: step_call(*hard)),
        "fast_frame": ("dingdong 1280x720 FAST frame", lambda: frame(FAST_CONFIG)),
        "golden_frame": ("dingdong 1280x720 GOLDEN frame", lambda: frame(GOLDEN_CONFIG)),
        "fallback": ("33-light 640x480 fallback fwd+bwd", fallback),
    }


def profile_call(call, calls: int) -> dict:
    """``call(k)`` for k in range(calls), timed by the host's clock and then
    under torch.profiler (see the module's docstring); the caller has made
    its untimed calls."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for k in range(calls):
        call(k)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(calls):
            call(k)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / calls
    ops = events_by_name(prof).values()
    device_ms = sum(us for _, us in ops) / 1e3 / calls
    runtime = {name: v for name, v in events_by_name(prof, DeviceType.CPU).items()
               if name.startswith(("cuda", "cuLaunch", "cuGraph"))}
    return {
        "wall_ms": wall_ms,
        "profiled_wall_ms": profiled_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "device_ops": sum(n for n, _ in ops) / calls,
        "runtime_calls": {k: n / calls for k, (n, _) in sorted(
            runtime.items(), key=lambda item: -item[1][0])[:8]},
        "runtime_ms": sum(us for _, us in runtime.values()) / 1e3 / calls,
        "peak_gib": peak_gib,
    }


def run_case(factory, mode: str, calls: int, measure):
    """(``measure(call)``, the cache's reading or None) of a fresh call of a
    case in ``mode`` (``eager``: inside ``graphs.eager()``; ``graphed``: as
    a user calls it, its graph cache emptied first) after two untimed calls,
    a key's warm-up and its capture. A graphed reading is what the cache did
    over those calls and ``measure``'s: its captures, each capture's host
    ms, the bytes its graphs keep and the calls the byte bound held eager."""
    from .render import graphs

    with graphs.eager() if mode == "eager" else contextlib.nullcontext():
        call = factory()
        cache = None if mode == "eager" else call.cache()
        if cache is not None:
            cache.clear()
            captures, over_bound = cache.captures, cache.over_bound
        call(calls)
        call(calls + 1)
        reading = measure(call)
    if cache is None:
        return reading, None
    return reading, {"captures": cache.captures - captures,
                     "capture_ms": [t * 1e3 for t in cache.capture_s[captures:]],
                     "graph_gib": cache.bytes() / 2**30,
                     "over_bound": cache.over_bound - over_bound}


def describe(label: str, mode: str, reading: dict) -> str:
    """One line of a reading."""
    line = (f"{label}, {mode}: wall {reading['wall_ms']:.3f} ms a call, device "
            f"{reading['device_ms']:.3f} ms (busy {reading['busy_share']:.3f}), "
            f"{reading['device_ops']:.0f} device ops a call, runtime "
            f"{reading['runtime_ms']:.3f} ms in {reading['runtime_calls']}, under the "
            f"profiler {reading['profiled_wall_ms']:.3f} ms, peak {reading['peak_gib']:.3f} GiB")
    if "captures" in reading:
        line += (f"; {reading['captures']} captures ("
                 + ", ".join(f"{t:.1f}" for t in reading["capture_ms"])
                 + f" ms), graphs keep {reading['graph_gib']:.3f} GiB, "
                 f"{reading['over_bound']} calls over the byte bound")
    return line


def profile(cases: dict, modes, calls: int, print_fn=print) -> dict:
    """``"<case> <mode>"`` -> the reading of ``profile_call`` (with the
    cache's, graphed) for every case of ``make_cases`` and mode;
    ``print_fn`` gets each reading's line (``describe``)."""
    readings = {}
    for name, (label, factory) in cases.items():
        for mode in modes:
            reading, cached = run_case(factory, mode, calls,
                                       lambda call: profile_call(call, calls))
            reading.update(cached or {})
            readings[f"{name} {mode}"] = reading
            print_fn(describe(label, mode, reading))
    return readings


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("pipeline_profile: needs a CUDA device (torch.cuda.is_available() "
                         "is false)")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    readings = profile(make_cases(dev, CALLS), ("eager", "graphed"), CALLS,
                       lambda line: print(f"[profile] {line} ({smi})", flush=True))
    print(json.dumps({"device": smi, "calls": CALLS, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
