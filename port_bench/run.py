"""The benchmark of the port (``tpu_ray_tracer_torch``) on one cell.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with at least the cell's CUDA
devices. The run:

1. set-up, timed from the process's start as ``setup_s``: torch and the
   card, the cell's inputs made from ``--seed``, the program's scene and
   entry, and the calls that build, warm up and capture every shape the
   window uses (the cell's driver, ``port_bench/drivers/``); the seconds
   the plain reference spends on an input (a fit's target) are left out;
2. the window: the driver's units (a frame or a fit step, each ending in a
   synchronize or a loss read back) until ``--seconds`` have passed, the last
   unit finished, with the garbage collector off; nvidia-smi's clocks, power
   and temperature are read before and after it. With ``--trace 1`` the first units run under
   ``torch.profiler``, and the per-layer metrics are read from that trace
   (``port_bench/metrics/``) in place of the end-to-end ones;
3. the device's peak memory is read, the program's state freed, and the
   outputs that the window produced are compared with the plain reference
   (``port_bench/reference/``): each number compared is printed beside its
   limit as the last lines on standard error, and under ``compared``, the
   last key of the result's line.

The process runs on one CPU core, the last of those it may use, and so do
the threads that torch and the CUDA driver start, so that the host path
never migrates between cores inside a window.

The last line on standard output is the result, one JSON object. The run
exits 2, printing no result, without enough CUDA devices, and 3 when JAX or
the JAX package was loaded; any other failure raises.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here, before torch is imported

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import harness, tracing  # noqa: E402


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, and
    one thread for the host's math libraries."""
    build = root / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def pin_to_one_core() -> None:
    """Keep this process, and every thread it starts later, on one core."""
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0) -> dict:
    """One run of ``cell`` on ``device``: the result's keys but ``device``'s
    card fields (see the module's docstring). Raises ``ForbiddenModules``
    when JAX or the JAX package is loaded once the window has closed."""
    import torch

    t_driver = time.perf_counter()
    drv = harness.driver(cell).Driver(cell, seed, device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0 - drv.reference_s
    phases = {"before_driver": t_driver - t0, **drv.phases}
    smi_before = harness.smi() if on_card else {}
    trace_units = int(cell.mix["trace_units"]) if trace else 0
    span = torch.profiler.record_function if trace else harness.no_span
    prof = None
    n = 0
    gc.collect()
    gc.disable()
    start = time.perf_counter()
    while True:
        if n == 0 and trace:
            drv.before_trace()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA]
                                             if on_card else []))
            prof.__enter__()
        drv.run_unit(span)
        n += 1
        if prof is not None and n == trace_units:
            prof.__exit__(None, None, None)
        end = time.perf_counter()
        if end - start >= seconds and n >= trace_units:
            break
    window_s = end - start
    gc.enable()
    smi_after = harness.smi() if on_card else {}
    loaded = harness.forbidden_loaded()
    if loaded:
        raise ForbiddenModules(loaded)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e = drv.end_to_end(window_s, n)
    drv.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared = drv.check()
    result = {"correct": harness.within(compared), "attempted": n, "failed": drv.failures}
    if not trace:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        extra = {}
    else:
        tr = tracing.from_profiler(prof, drv.unit)
        tr.least_fn = drv.least
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(cell.root, m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s, "breakdown": tr.breakdown()}
    result.update(metrics=metrics, peak=peak, extra=extra, setup_s=setup_s, window_s=window_s,
                  smi={"before": smi_before, "after": smi_after}, phases=phases,
                  compared=compared)
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.run", description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    cell = harness.resolve(root, args.workload)
    pin_to_one_core()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"port_bench: the cell {cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() is {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    except ForbiddenModules as exc:
        log(f"port_bench: loaded in this process once the window closed: {', '.join(exc.args[0])}")
        return 3
    log(f"port_bench: {cell.name} seed {args.seed}: set-up {out['setup_s']:.3f} s, window "
        f"{out['window_s']:.3f} s, {out['attempted']} units")
    log("port_bench: set-up phases (s): " + json.dumps(out["phases"]))
    log("port_bench: nvidia-smi before the window: " + json.dumps(out["smi"]["before"]))
    log("port_bench: nvidia-smi after the window: " + json.dumps(out["smi"]["after"]))
    print("nvidia-smi: " + json.dumps(out["smi"]), flush=True)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": out["peak"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device_info}
    if args.trace:
        device_info.update(busy_s=out["extra"]["busy_s"], window_s=out["extra"]["window_s"])
        line["breakdown"] = out["extra"]["breakdown"]
    line["compared"] = out["compared"]
    for name, c in out["compared"].items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
