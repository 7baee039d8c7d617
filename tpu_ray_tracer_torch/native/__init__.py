"""Native (C++) scene loader with a ctypes binding.

Counterpart of ``tpu_ray_tracer/native/__init__.py``. ``scene_loader.cpp``
(the port's own copy of the JAX package's source, byte for byte) is a
dependency-free C++ scene parser, validator and surface/light factory that
emits the same flat tables as the Python loader; this binding turns them
into a port ``Scene``. The library is built with ``g++`` at first use into
``build/tpu_ray_tracer_torch/<hash>/libtrtscene.so`` at the repository root,
the hash covering the source and the flags (the JAX package's Makefile
flags), as ``render/_build.py`` builds the CUDA kernels. The Python loader
(``models/loader.py``) is the behavioural oracle. Host code, off the frame
loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..models import light as light_mod
from ..models.errors import SceneError
from ..models.scene import Scene, build_scene
from ..render._build import BUILD_ROOT

_SOURCE = Path(__file__).resolve().parent / "scene_loader.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")


class _TrtScene(ctypes.Structure):
    _fields_ = [
        ("ok", ctypes.c_int),
        ("error", ctypes.c_char * 512),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("fov_deg", ctypes.c_double),
        ("max_reflections", ctypes.c_int),
        ("bg", ctypes.c_float * 3),
        ("n_objects", ctypes.c_int),
        ("coefs", ctypes.POINTER(ctypes.c_double)),
        ("colors", ctypes.POINTER(ctypes.c_float)),
        ("reflection", ctypes.POINTER(ctypes.c_float)),
        ("n_lights", ctypes.c_int),
        ("is_spherical", ctypes.POINTER(ctypes.c_int)),
        ("light_p", ctypes.POINTER(ctypes.c_double)),
        ("light_color", ctypes.POINTER(ctypes.c_float)),
    ]


def build_library() -> Path:
    """Compile ``scene_loader.cpp`` unless a build of the same source and
    flags exists; return the library's path. Raises ``RuntimeError`` with
    the compiler's output where ``g++`` fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(_SOURCE.read_bytes())
    out = BUILD_ROOT / digest.hexdigest()[:16] / "libtrtscene.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


@functools.cache
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.trt_load_scene.restype = ctypes.POINTER(_TrtScene)
    lib.trt_load_scene.argtypes = [ctypes.c_char_p]
    lib.trt_free_scene.restype = None
    lib.trt_free_scene.argtypes = [ctypes.POINTER(_TrtScene)]
    return lib


def available() -> bool:
    """Whether the library builds (a C++ toolchain is present) and loads."""
    try:
        _load_library()
        return True
    except (RuntimeError, OSError):
        return False


def _array(ptr, shape, dtype):
    """A copy of ``shape`` elements at ``ptr``: the struct's memory is freed
    once the scene is read."""
    if not shape[0]:
        return np.zeros(shape, dtype)
    return np.ctypeslib.as_array(ptr, shape=shape).astype(dtype, copy=True)


def load_from_file(path, device: str | torch.device = "cuda") -> Scene:
    """Load a scene YAML file through the native C++ loader into a ``Scene``
    on ``device``: the GPU unless the caller asks for another, as the other
    loaders do (without a CUDA device the default raises). An invalid scene
    raises ``SceneError`` with the C++ loader's message."""
    lib = _load_library()
    ptr = lib.trt_load_scene(str(path).encode())
    if not ptr:
        raise SceneError("native loader returned null")
    try:
        raw = ptr.contents
        if not raw.ok:
            raise SceneError(raw.error.decode())
        n, n_lights = raw.n_objects, raw.n_lights
        sph = _array(raw.is_spherical, (n_lights,), np.int32).astype(bool)
        light_p = _array(raw.light_p, (n_lights, 3), np.float64)
        light_c = _array(raw.light_color, (n_lights, 3), np.float32)
        lights = [light_mod.Light(is_spherical=bool(sph[i]), p=light_p[i], color=light_c[i])
                  for i in range(n_lights)]
        scene = build_scene(
            width=raw.width, height=raw.height, fov_deg=raw.fov_deg, objects=[],
            lights=lights, max_reflections=raw.max_reflections,
            bg_color=np.array([raw.bg[0], raw.bg[1], raw.bg[2]], dtype=np.float32),
            device=device)
        tables = {"coefs": _array(raw.coefs, (n, 20), np.float64),
                  "colors": _array(raw.colors, (n, 3), np.float32),
                  "reflection": _array(raw.reflection, (n,), np.float32)}
    finally:
        lib.trt_free_scene(ptr)
    return dataclasses.replace(
        scene, **{k: torch.as_tensor(v, device=scene.coefs.device) for k, v in tables.items()})
