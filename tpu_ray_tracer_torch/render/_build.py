"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/tpu_ray_tracer_torch/<hash>/lib<name>.so`` at the repository root,
at first use; the hash covers the sources and the flags, so an edited source
is rebuilt and an unchanged one is reused. The library has a plain C
interface and is loaded with ``ctypes``: every pointer and the stream travel
as ``c_void_p``, and each launcher returns ``cudaGetLastError()``, which the
wrapper turns into an exception when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpu_ray_tracer_torch"

# No --use_fast_math: the kernel follows the reference's IEEE f32 arithmetic
# (correctly rounded division and sqrt, denormals kept). nvcc's default
# -fmad=true contracts multiply-adds into FMAs.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=true", "-Xptxas", "-v")

# ctypes signatures of the C launchers, by library name
_SIGNATURES = {
    "render_fwd": {
        # 8 tables, out, aux t/slot/occ (null without save_aux) | width height
        # rows n_obj n_cubic n_lights polish shadow screen bounces variant | stream
        "trt_render_fwd": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                           + [ctypes.c_void_p], ctypes.c_int),
    },
    "render_bwd": {
        # coefs colors refl lights cam, cotangent, aux t/slot/occ, scratch, out
        # | width height rows n_obj n_lights bounces placement blocks | stream
        "trt_render_bwd": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p], ctypes.c_int),
        # width rows n_obj n_lights bounces, out[3] (placement, blocks,
        # floats of scratch) -> CUDA error
        "trt_render_bwd_plan": ([ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)],
                                ctypes.c_int),
    },
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def compile_source(source: Path, out: Path) -> Path:
    """Compile ``source`` (a ``.cu`` file, its headers beside it) with
    ``NVCC_FLAGS`` into the library ``out``; the compiler's report
    (registers, spills per kernel) is kept beside it in ``ptxas.txt``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    (out.parent / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of the same sources and
    flags exists; return the library's path."""
    source = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"
    if out.is_file():
        return out
    return compile_source(source, out)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its launchers' signatures set."""
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.trt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.trt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(name: str, code: int) -> str:
    return load(name).trt_cuda_error_string(code).decode()
