"""Where a graphed kernel-route frame's device time goes, and what it costs.

    python -m tpu_ray_tracer_torch.frame_profile

On the card, dingdong 1280x720 (the headline scene) at the bench's yaw
sweep 90 + 1e-3 k:

* ``ops``: the bench's forward sweep (``bench.frame`` over ``FRAMES``
  poses plus the reference pose) and its forward+backward sweep
  (``bench.frame_grads`` of the coefficients and light colours over
  ``FRAMES`` poses), each captured as one CUDA graph as the bench captures
  it, then one replay under torch.profiler: every device operation by name
  with its count and its device time a frame, the operations a frame and
  the device time a frame;
* ``bench``: the bench's own dingdong stages (``bench._bench_fwd`` and
  ``bench._bench_fwdbwd``): ``frame_ms_fwd``, the headline Mrays/s,
  ``kernel_ms_fwd``, ``frame_ms_fwd_bwd`` and ``kernel_ms_bwd``.

The host's side of a user's graphed call and fit step is the benchmark's
traced run (``python3 -m port_bench.run --trace 1``): the port's spans and
the ``program_*`` metrics that read them.

The packing kernels alone are timed by ``chip_smoke.py`` (phase 5b). Needs
one CUDA device; prints one line a reading and, as its last line, one JSON
object.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from .utils.device import smi_line
from .utils.timing import events_by_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 32       # the bench's sweep (TRT_BENCH_FRAMES)
TOP_OPS = 40      # device operations listed, by device time


def _device_ops(fn, frames: int) -> dict:
    """One ``fn()`` under torch.profiler: the device's operations by name
    (count and device us, each a frame), their number and device ms a
    frame."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = events_by_name(prof)
    ops = sorted(((name, n / frames, us / frames) for name, (n, us) in by_name.items()),
                 key=lambda t: -t[2])
    return {"ops_a_frame": sum(n for n, _ in by_name.values()) / frames,
            "device_ms_a_frame": sum(us for _, us in by_name.values()) / 1e3 / frames,
            "by_name": [{"name": name[:120], "count": n, "us": us}
                        for name, n, us in ops[:TOP_OPS]]}


def profile_ops(dev, scene) -> dict:
    """``ops``: the forward and forward+backward sweeps' device operations."""
    from . import bench
    from .diff.inverse import extract_params
    from .ops.camera import Camera
    from .render import graphs

    scene32 = scene.astype(torch.float32)
    cams = bench.sweep_cameras(FRAMES, dev)
    ref_cam = Camera.initial(torch.float32, dev)

    def fwd_sweep():
        with torch.no_grad():
            sums = [bench.frame(scene32, c, 0).sum() for c in cams]
            sums.append(bench.frame(scene32, ref_cam, 0).sum())
            return torch.stack(sums)

    params = extract_params(scene32)

    def fwdbwd_sweep():
        return torch.stack([sum(g.sum() for g in bench.frame_grads(scene32, params, c,
                                                                   0).values())
                            for c in cams])

    out = {}
    for what, body, frames in (("forward", fwd_sweep, FRAMES + 1),
                               ("fwd+bwd", fwdbwd_sweep, FRAMES)):
        sweep = bench.sweep_graph(dev, body)
        out[what] = _device_ops(lambda: graphs.replay(sweep), frames)
        del sweep
    return out


def bench_stages(scene) -> dict:
    """``bench``: the bench's dingdong forward and forward+backward stages."""
    from . import bench

    with bench._Progress() as progress:
        fwd = bench._bench_fwd(progress, "dingdong", scene, frames=FRAMES, scale=1,
                               extra_launches={})
        fwdbwd = bench._bench_fwdbwd(progress, "dingdong", scene, frames=FRAMES,
                                     extra_launches={})
    return {"frame_ms_fwd_dingdong": fwd["frame_ms_fwd"], "mrays_fwd_dingdong": fwd["mrays_fwd"],
            "kernel_ms_fwd_dingdong": fwd["kernel_ms_fwd"],
            "parity_dingdong": fwd["parity_bad_px_fraction"],
            "frame_ms_fwd_bwd_dingdong": fwdbwd["frame_ms_fwd_bwd"],
            "kernel_ms_bwd_dingdong": fwdbwd["kernel_ms_bwd"]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile: needs a CUDA device (torch.cuda.is_available() is "
                         "false)")
    from .models.loader import load_from_file

    dev = torch.device("cuda", 0)
    smi = smi_line()
    scene = load_from_file(os.path.join(REPO, "scenes", "dingdong.yml"), device=dev)
    result = {"device": smi, "frames": FRAMES, "ops": profile_ops(dev, scene)}
    for what, r in result["ops"].items():
        print(f"[frame-profile] graphed {what} sweep, dingdong 1280x720: "
              f"{r['ops_a_frame']:.2f} device ops a frame, {r['device_ms_a_frame']:.4f} ms "
              f"device a frame ({smi})", flush=True)
        for op in r["by_name"]:
            print(f"[frame-profile]   {what}: {op['count']:.3f} x {op['name']}: "
                  f"{op['us']:.3f} us a frame", flush=True)
    result["bench"] = bench_stages(scene)
    for key, value in result["bench"].items():
        print(f"[frame-profile] {key}: {value} ({smi})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
