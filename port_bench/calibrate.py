"""The readings that a cell's limits are set from, on the chip, in one process.

    python3 -m port_bench.calibrate --workload <cell> --seeds S1,S2,... \
        [--control-seeds C1,C2,C3] [--seconds 2]

For each of ``--seeds``: the cell's set-up and a short window at its own load
(``--seconds``; a fit cell needs none: its numbers are read from the set-up
steps), then each number compared, as a run computes it: the program's
readings, whose largest over sound seeds is a number's lower reading.

For each of ``--control-seeds``, beside the program's readings, the same
numbers with the control in the program's place: the plain reference
computed in the precision below the configuration's (its ``control``: the
same frames, or the same first fit steps, in bfloat16). A fit cell also reads
its faults there, the reference put in the program's place with the fault
planted: ``half_batch`` (half of the rows left out, the mean taken over the
rest). A step that returns its state unchanged reads 1 on ``change_gap`` and
needs no run; one chip has no exchange to leave out.

A view cell also reads the share of pixels that hit a surface over the
session (``hit_share``, on ``--hit-poses`` poses spread over it).

Prints one JSON line a seed and, last, a summary: each number's largest
program reading and smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import harness, run


def hit_share(drv, poses: int) -> float:
    """The share of the frame's pixels that hit a surface, over ``poses``
    poses spread evenly over the session (the plain reference, float32)."""
    import numpy as np
    import torch

    from .reference.ops import camera as camera_ops
    from .reference.render.pipeline import trace_and_shade

    scene = drv.reference_scene(torch.float32)
    hits = total = 0
    for i in np.linspace(0, len(drv.poses) - 1, poses).round().astype(int).tolist():
        position, yaw, pitch = drv.poses[i]
        cam = camera_ops.Camera(torch.tensor(position.tolist(), device=drv.device),
                                torch.tensor(yaw, device=drv.device),
                                torch.tensor(pitch, device=drv.device))
        rotation, eye = camera_ops.camera_frame(cam)
        dirs = camera_ops.pixel_directions(rotation, scene.width, scene.height,
                                           scene.aspect_ratio, scene.tan_half_fov).reshape(-1, 3)
        with torch.no_grad():
            for k in range(0, dirs.shape[0], 65536):
                d = dirs[k:k + 65536]
                hits += int(trace_and_shade(scene, eye.expand(d.shape), d, 3).hit.sum())
        total += dirs.shape[0]
    return hits / total


def readings(cell, seed: int, seconds: float, device, control: bool, hit_poses: int) -> dict:
    """The program's numbers for one seed, and with ``control`` the
    control's and the faults'."""
    import torch

    drv = harness.driver(cell).Driver(cell, seed, device)
    start, n = time.perf_counter(), 0
    while n == 0 or time.perf_counter() - start < seconds:
        drv.run_unit(harness.no_span)
        n += 1
    drv.free()
    torch.cuda.empty_cache()
    out = {"seed": seed, "units": n}
    if cell.mix["driver"] == "view":
        out["program_frames"] = drv.readings()
        out["program"] = {"bad_px_share": max(out["program_frames"])}
        if control:
            scene = drv.reference_scene(getattr(torch, cell.setting["control"]["dtype"]))
            images = [drv.reference_frame(scene, i, cell.setting["control"]["polish_iters"])
                      for i, _ in drv.kept]
            out["control_frames"] = drv.readings(images=images)
            out["control"] = {"bad_px_share": max(out["control_frames"])}
            out["hit_share"] = hit_share(drv, hit_poses)
    else:
        from .drivers.fit import gaps

        truth = drv.follow()
        out["program"] = gaps(drv.first, truth)
        if not control:
            return out
        out["control"] = gaps(drv.follow(reference=cell.setting["control"]), truth)
        out["half_batch"] = gaps(drv.follow(rows=drv.target.shape[0] // 2), truth)
    return out


def summary(rows: list) -> dict:
    """Each number's largest program reading and smallest control and fault
    readings."""
    out = {}
    for key in ("program", "control", "half_batch"):
        seen = [r[key] for r in rows if key in r]
        if seen:
            pick = max if key == "program" else min
            out[key] = {k: pick(s[k] for s in seen) for k in seen[0]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate",
                                     description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--hit-poses", type=int, default=64)
    args = parser.parse_args(argv)
    root = Path.cwd()
    run.cache_env(root)
    cell = harness.resolve(root, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("port_bench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    rows = []
    for seed in seeds + sorted(controls - set(seeds)):
        row = readings(cell, seed, args.seconds, device, seed in controls, args.hit_poses)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": cell.name, "smi": harness.smi(), "summary": summary(rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
