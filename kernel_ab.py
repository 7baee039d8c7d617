#!/usr/bin/env python3
"""Time the port's kernels on one NVIDIA GPU against an earlier version of
their sources, and against edited copies of the current ones.

    python3 kernel_ab.py [--parent DIR] [--sweep] [--lanes] [--json PATH]

``--parent DIR``: DIR holds an earlier version's ``render_fwd.cu``,
``render_bwd.cu`` and ``poly.cuh``
(``git show <commit>:tpu_ray_tracer_torch/csrc/<file>``). Both versions run
on the same frames, timed in turns (old, new, new, old), and their outputs
are compared: the images (equal bits, max |diff|, pixels over 2/255) and
the gradient vectors (max |diff| over the largest entry).

``--sweep``: copies of the current sources with other block shapes and
min-blocks values (their ``constexpr`` lines edited), each timed in turns
with the shipped build; each forward instantiation; the backward forced to
each row placement (``PLACEMENT_ORDER`` edited to that one).

``--lanes``: copies with a counter at the entry of each part of a pixel's
work (the forward: the pixel, each traced ray, each cubic and quadric root
solve, the polish, the shading of a hit, each cubic and quadric shadow
test; the backward: the pixel, each stage's reverse, the object rows of a
hit). Each counter adds, once per warp that reaches it, one pass and the
number of lanes active there, so lanes / passes is the mean active lanes of
a warp in that part and lanes / pixels its calls per pixel.

Copies are built under ``build/kernel_ab/`` (gitignored). Frames: dingdong
at 1280x720 and 20spheres at 800x600, 32 camera yaws 90 + 1e-3 k (the JAX
bench's sweep); times are device time per launch (``kernel_bench.timed_ms``).
Prints one JSON object as its last line, and writes it to ``--json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent
SCENES = ("dingdong", "20spheres")
FRAMES = 32
# (block x, block y, min blocks) of the forward; (block, min blocks) of the
# backward's one-stage kernels. The shipped values are 16x8 at 6 and 64 at 8.
FWD_SWEEP = [(8, 8, 1), (8, 8, 12), (16, 8, 4), (16, 8, 5), (16, 8, 7), (32, 4, 6), (16, 16, 3)]
BWD_SWEEP = [(128, 4), (64, 10), (64, 12), (32, 16)]
FWD_PROBES = ("float solve_cubic(", "float solve_quadric(", "float polish(", "Hit trace(",
              "uint32_t shade(", "bool cubic_occ(", "bool quadlin_occ(")
BWD_PROBES = ("void stage_bwd(",)
PROBE_HEADER = r'''
__device__ unsigned long long trt_probe_counts[64];
// once per warp that reaches probe k: one pass, and the lanes active there
#define TRT_PROBE(k) do { const unsigned m_ = __activemask(); unsigned lane_; \
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane_)); \
  if (lane_ == (unsigned)(__ffs(m_) - 1)) { atomicAdd(&trt_probe_counts[2 * (k)], 1ull); \
    atomicAdd(&trt_probe_counts[2 * (k) + 1], (unsigned long long)__popc(m_)); } } while (0)
extern "C" int trt_probe_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, trt_probe_counts, sizeof(trt_probe_counts));
}
extern "C" int trt_probe_reset() {
  static const unsigned long long zero[64] = {};
  return (int)cudaMemcpyToSymbol(trt_probe_counts, zero, sizeof(zero));
}
'''

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def log(msg: str) -> None:
    print(msg, flush=True)


def edit(text: str, pattern: str, repl: str) -> str:
    """``text`` with the one match of ``pattern`` replaced (raises unless
    there is exactly one)."""
    out, n = re.subn(pattern, repl, text)
    if n != 1:
        raise RuntimeError(f"kernel_ab: {pattern!r} matched {n} times")
    return out


def fwd_edits(bx: int, by: int, mb: int) -> list:
    return [(r"constexpr int BLOCK_X = \d+;", f"constexpr int BLOCK_X = {bx};"),
            (r"constexpr int BLOCK_Y = \d+;", f"constexpr int BLOCK_Y = {by};"),
            (r"constexpr int MIN_BLOCKS = \d+;", f"constexpr int MIN_BLOCKS = {mb};")]


def bwd_edits(block: int, mb: int) -> list:
    return [(r"constexpr int BLOCK = \d+;", f"constexpr int BLOCK = {block};"),
            (r"constexpr int MIN_BLOCKS = \d+;", f"constexpr int MIN_BLOCKS = {mb};")]


def placement_edits(placement: str) -> list:
    return [(r"constexpr int PLACEMENT_ORDER\[\] = \{[^}]*\};",
             f"constexpr int PLACEMENT_ORDER[] = {{{placement}}};"),
            (r"constexpr int MIN_RESIDENT = [^;]*;", "constexpr int MIN_RESIDENT = 1;")]


def probe_edits(anchors, extra=()) -> list:
    """A counter at the start of each function named by ``anchors`` (from
    probe 1 on), probe 0 where each pixel's work starts, and ``extra``."""
    out = [(r'(#include "poly.cuh"\n)', lambda m: m.group(1) + PROBE_HEADER)]
    for k, anchor in enumerate(anchors, start=1):
        out.append((r"(" + re.escape(anchor) + r"[^{;]*\{)",
                    lambda m, k=k: m.group(1) + f" TRT_PROBE({k});"))
    return out + list(extra)


FWD_PIXEL_PROBE = (r"(if \(x >= width \|\| y_local >= rows\) return;\n)",
                   lambda m: m.group(1) + "  TRT_PROBE(0);\n")
BWD_PIXEL_PROBE = (r"(const PixelCtx px\{[^}]*\};\n)",
                   lambda m: m.group(1) + "    if (valid) TRT_PROBE(0);\n")
BWD_HIT_PROBE = (r"(    if \(a\.slot >= 0\) \{\n)",
                 lambda m: m.group(1) + f"      TRT_PROBE({len(BWD_PROBES) + 1});\n")


def build_copy(label: str, src_dir: pathlib.Path, name: str, edits=()) -> pathlib.Path:
    """Copy ``src_dir``'s ``<name>.cu`` and headers to
    ``build/kernel_ab/<label>/``, apply ``edits`` to the ``.cu`` and build
    it with the port's nvcc flags."""
    from tpu_ray_tracer_torch.render import _build

    work = _build.BUILD_ROOT.parent / "kernel_ab" / label
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    for header in src_dir.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    text = (src_dir / f"{name}.cu").read_text()
    for pattern, repl in edits:
        text = edit(text, pattern, repl)
    (work / f"{name}.cu").write_text(text)
    return _build.compile_source(work / f"{name}.cu", work / f"lib{name}.so")


class Frames:
    """Packed tables, outputs and aux of FRAMES yaws of one scene."""

    def __init__(self, name: str, dev):
        import torch

        import tpu_ray_tracer_torch as ttt
        from tpu_ray_tracer_torch.render.kernel_backend import pack_frame

        scene = ttt.load_from_file(REPO / "scenes" / f"{name}.yml", device=dev)
        self.name = name
        self.packed = []
        for k in range(FRAMES):
            cam = ttt.Camera(position=torch.zeros(3, device=dev),
                             yaw_deg=torch.tensor(90.0 + 1e-3 * k, device=dev),
                             pitch_deg=torch.tensor(0.0, device=dev))
            self.packed.append(pack_frame(scene, cam, 0, scene.height))
        self.kw = kw = self.packed[0][1]
        self.n_px = kw["rows"] * kw["width"]
        self.out = torch.empty((kw["rows"], kw["width"], 3), device=dev)
        shape = (kw["bounces"] + 1, kw["rows"], kw["width"])
        self.aux = [(torch.empty(shape, device=dev),
                     torch.empty(shape, dtype=torch.int32, device=dev),
                     torch.empty(shape, dtype=torch.int32, device=dev)) for _ in range(FRAMES)]
        self.grad = torch.linspace(0.1, 1.0, self.n_px * 3, device=dev).reshape(
            kw["rows"], kw["width"], 3)
        self.n_obj, self.n_lights = self.packed[0][0][0].shape[0], self.packed[0][0][4].shape[0]


def _stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


class FwdLib:
    """A built render_fwd library, with the instantiation argument of the
    current launcher or without it (an earlier version's)."""

    def __init__(self, path: pathlib.Path, source: pathlib.Path):
        self.lib = ctypes.CDLL(str(path))
        self.current = "int variant" in source.read_text()
        self.fn = self.lib.trt_render_fwd
        self.fn.argtypes = [_PTR] * 12 + [_INT] * (11 if self.current else 10) + [_PTR]
        self.fn.restype = _INT

    def run(self, fr: Frames, k: int, aux: bool = False, variant: str | None = None):
        from tpu_ray_tracer_torch.render.fwd_kernel import FWD_VARIANTS, fwd_variant

        tables, kw = fr.packed[k]
        ptrs = [t.data_ptr() for t in fr.aux[k]] if aux else [None] * 3
        ints = [kw["width"], kw["height"], kw["rows"], fr.n_obj, kw["n_cubic"], fr.n_lights,
                kw["polish_iters"], kw["shadow_iters"], kw["screen_iters"], kw["bounces"]]
        if self.current:
            ints.append(FWD_VARIANTS.index(variant or fwd_variant(
                kw["polish_iters"], kw["screen_iters"], kw["shadow_iters"], kw["bounces"])))
        rc = self.fn(*(t.data_ptr() for t in tables), fr.out.data_ptr(), *ptrs, *ints,
                     _stream())
        if rc != 0:
            raise RuntimeError(f"render_fwd launch failed: CUDA error {rc}")


class BwdLib:
    """A built render_bwd library: the current launcher (a plan, then the
    launch with the plan's placement and blocks) or an earlier one (a
    scratch-size function, then the launch)."""

    def __init__(self, path: pathlib.Path):
        self.lib = ctypes.CDLL(str(path))
        self.current = hasattr(self.lib, "trt_render_bwd_plan")
        self.fn = self.lib.trt_render_bwd
        self.fn.argtypes = [_PTR] * 11 + [_INT] * (8 if self.current else 6) + [_PTR]
        self.fn.restype = _INT
        self.plans = {}

    def plan(self, fr: Frames):
        """(placement index or None, blocks or None, floats of scratch)."""
        import torch

        if fr.name not in self.plans:
            kw = fr.kw
            if self.current:
                out = (ctypes.c_longlong * 4)()
                self.lib.trt_render_bwd_plan.argtypes = [_INT] * 5 + [
                    ctypes.POINTER(ctypes.c_longlong)]
                self.lib.trt_render_bwd_plan.restype = _INT
                rc = self.lib.trt_render_bwd_plan(kw["width"], kw["rows"], fr.n_obj,
                                                  fr.n_lights, kw["bounces"], out)
                if rc != 0:
                    raise RuntimeError(f"render_bwd plan failed: CUDA error {rc}")
                plan = (int(out[0]), int(out[1]), int(out[2]))
            else:
                self.lib.trt_render_bwd_scratch.argtypes = [_INT] * 4
                self.lib.trt_render_bwd_scratch.restype = ctypes.c_longlong
                plan = (None, None, self.lib.trt_render_bwd_scratch(
                    kw["width"], kw["rows"], fr.n_obj, fr.n_lights))
            self.plans[fr.name] = (*plan, torch.empty(max(plan[2], 1), device=fr.grad.device))
        return self.plans[fr.name]

    def run(self, fr: Frames, k: int, out):
        placement, blocks, _, scratch = self.plan(fr)
        tables, kw = fr.packed[k]
        ptrs = [t.data_ptr() for t in (tables[0], tables[2], tables[3], tables[4], tables[7],
                                       fr.grad, *fr.aux[k], scratch, out)]
        ints = [kw["width"], kw["height"], kw["rows"], fr.n_obj, fr.n_lights, kw["bounces"]]
        if self.current:
            ints += [placement, blocks]
        rc = self.fn(*ptrs, *ints, _stream())
        if rc != 0:
            raise RuntimeError(f"render_bwd launch failed: CUDA error {rc}")


def read_probes(lib, names, n_px: int) -> dict:
    """{part: {passes, lanes, lanes_per_pass, per_pixel}} from a probe build."""
    counts = (ctypes.c_ulonglong * 64)()
    lib.trt_probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.trt_probe_read.restype = _INT
    if lib.trt_probe_read(counts) != 0:
        raise RuntimeError("kernel_ab: reading the probe counters failed")
    out = {}
    for k, name in enumerate(names):
        passes, lanes = counts[2 * k], counts[2 * k + 1]
        out[name] = {"passes": passes, "lanes": lanes,
                     "lanes_per_pass": lanes / passes if passes else None,
                     "per_pixel": lanes / n_px}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, help="csrc directory of an earlier version")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--lanes", action="store_true")
    ap.add_argument("--json", type=pathlib.Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    sys.path.insert(0, str(REPO))
    from tpu_ray_tracer_torch.kernel_bench import ptxas_report, sass_mix, timed_ms
    from tpu_ray_tracer_torch.parity import bad_pixel_fraction
    from tpu_ray_tracer_torch.render import _build
    from tpu_ray_tracer_torch.render.bwd_kernel import BWD_PLACEMENTS, acc_layout
    from tpu_ray_tracer_torch.render.fwd_kernel import FWD_VARIANTS

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"[device] {smi}")
    result = {"device": smi}
    csrc = _build._CSRC
    placements = {"warp": "WARP", "light_columns": "LIGHT_COLUMNS", "columns": "COLUMNS"}
    jobs = {"fwd": ("render_fwd", csrc, ()), "bwd": ("render_bwd", csrc, ())}
    if args.parent:
        jobs["fwd_parent"] = ("render_fwd", args.parent, ())
        jobs["bwd_parent"] = ("render_bwd", args.parent, ())
    if args.sweep:
        for bx, by, mb in FWD_SWEEP:
            jobs[f"fwd_{bx}x{by}_mb{mb}"] = ("render_fwd", csrc, fwd_edits(bx, by, mb))
        for b, mb in BWD_SWEEP:
            jobs[f"bwd_{b}_mb{mb}"] = ("render_bwd", csrc, bwd_edits(b, mb))
        for p, enum in placements.items():
            jobs[f"bwdplace_{p}"] = ("render_bwd", csrc, placement_edits(enum))
    if args.lanes:
        jobs["fwdlanes"] = ("render_fwd", csrc, probe_edits(FWD_PROBES, [FWD_PIXEL_PROBE]))
        jobs["bwdlanes"] = ("render_bwd", csrc,
                            probe_edits(BWD_PROBES, [BWD_PIXEL_PROBE, BWD_HIT_PROBE]))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        futs = {label: (pool.submit(_build.build, name) if not edits and src == csrc
                        else pool.submit(build_copy, label, src, name, edits))
                for label, (name, src, edits) in jobs.items()}
        paths = {label: f.result() for label, f in futs.items()}
    result["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(paths)} libraries in {result['build_s']:.1f} s")
    result["ptxas"] = {label: ptxas_report(p) for label, p in paths.items()}
    for label, rep in result["ptxas"].items():
        for r in rep:
            log(f"[ptxas] {label}: {r['kernel'][:90]} regs {r.get('registers')} "
                f"stack {r.get('stack')} spill {r.get('spill_stores')}/{r.get('spill_loads')}")
    result["sass_mix"] = {label: sass_mix(paths[label]) for label in ("fwd", "bwd")}
    log(f"[sass] {json.dumps(result['sass_mix'])}")

    fwd = {label: FwdLib(p, pathlib.Path(jobs[label][1]) / "render_fwd.cu")
           for label, p in paths.items() if label.startswith("fwd")}
    bwd = {label: BwdLib(p) for label, p in paths.items() if label.startswith("bwd")}
    frames = {name: Frames(name, dev) for name in SCENES}
    out_bwd = torch.zeros(acc_layout(20, 19)[-1], device=dev)
    result["times"] = {}

    def vec(fr):
        return out_bwd[:acc_layout(fr.n_obj, fr.n_lights)[-1]]

    def time_fwd(label, fr, aux=False, variant=None):
        return timed_ms(lambda k: fwd[label].run(fr, k, aux, variant), FRAMES, device_only=True)

    def time_bwd(label, fr):
        out = vec(fr)
        return timed_ms(lambda k: bwd[label].run(fr, k, out), FRAMES, device_only=True)

    for fr in frames.values():
        for k in range(FRAMES):  # every frame's aux, from the shipped forward
            fwd["fwd"].run(fr, k, aux=True)
        for label in fwd:  # warm-up
            if "lanes" not in label:
                fwd[label].run(fr, 0)
        for label in bwd:  # warm-up, and each plan's scratch allocated before timing
            if "lanes" not in label:
                try:
                    bwd[label].run(fr, 0, vec(fr))
                except RuntimeError:  # a forced placement that does not fit: timed below
                    pass
        torch.cuda.synchronize()
        times = result["times"].setdefault(fr.name, {})
        if args.parent:
            for label in ("fwd_parent", "fwd", "fwd", "fwd_parent"):
                times.setdefault(label, []).append(time_fwd(label, fr))
            for label in ("fwd_parent", "fwd", "fwd", "fwd_parent"):
                times.setdefault(f"{label}_aux", []).append(time_fwd(label, fr, aux=True))
            for label in ("bwd_parent", "bwd", "bwd", "bwd_parent"):
                times.setdefault(label, []).append(time_bwd(label, fr))
            # outputs of the last frame: the image, then the gradient vector
            fwd["fwd"].run(fr, FRAMES - 1)
            new_img = fr.out.clone()
            fwd["fwd_parent"].run(fr, FRAMES - 1)
            diff = (new_img - fr.out).abs()
            times["fwd_vs_parent"] = {
                "equal": bool(torch.equal(new_img, fr.out)), "max_abs_diff": float(diff.max()),
                "px_differing": int((diff.amax(-1) > 0).sum()),
                "bad_px": bad_pixel_fraction(new_img.cpu().numpy(), fr.out.cpu().numpy())}
            bwd["bwd"].run(fr, FRAMES - 1, vec(fr))
            new_vec = vec(fr).clone()
            bwd["bwd_parent"].run(fr, FRAMES - 1, vec(fr))
            times["bwd_vs_parent"] = {
                "equal": bool(torch.equal(new_vec, vec(fr))),
                "max_abs_diff_over_scale": float((new_vec - vec(fr)).abs().max())
                / float(new_vec.abs().max())}
        if args.sweep:
            order = ["fwd"] + [lbl for lbl in fwd if lbl.startswith("fwd_") and "x" in lbl]
            for label in order + order[::-1]:
                times.setdefault(f"sweep_{label}", []).append(time_fwd(label, fr))
            for v in FWD_VARIANTS:
                if fr.kw["bounces"] == 0 or v != "main":
                    times.setdefault(f"variant_{v}", []).append(time_fwd("fwd", fr, variant=v))
            order = ["bwd"] + [lbl for lbl in bwd if lbl.startswith("bwd_") and "parent" not in lbl]
            order += [lbl for lbl in bwd if lbl.startswith("bwdplace_")]
            for label in order + order[::-1]:
                try:
                    times.setdefault(f"sweep_{label}", []).append(time_bwd(label, fr))
                except RuntimeError as err:  # a forced placement that does not fit
                    times[f"sweep_{label}"] = f"does not fit: {err}"
            times["placement_shipped"] = BWD_PLACEMENTS[bwd["bwd"].plan(fr)[0]]
        if args.lanes:
            lib = fwd["fwdlanes"].lib
            lib.trt_probe_reset.restype = _INT
            lib.trt_probe_reset()
            fwd["fwdlanes"].run(fr, 0)
            torch.cuda.synchronize()
            times["lanes_fwd"] = read_probes(
                lib, ["pixel", *(a.split()[1].rstrip("(") for a in FWD_PROBES)], fr.n_px)
            lib = bwd["bwdlanes"].lib
            lib.trt_probe_reset.restype = _INT
            lib.trt_probe_reset()
            bwd["bwdlanes"].run(fr, 0, vec(fr))
            torch.cuda.synchronize()
            times["lanes_bwd"] = read_probes(
                lib, ["pixel", *(a.split()[1].rstrip("(") for a in BWD_PROBES), "object_rows"],
                fr.n_px)
        for key, val in times.items():
            log(f"[time] {fr.name} {key}: {val}")
    print(json.dumps(result))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
