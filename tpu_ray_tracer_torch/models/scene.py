"""Scene model: a dataclass of stacked object and light tensors.

Counterpart of ``tpu_ray_tracer/models/scene.py``. The tables are
struct-of-arrays: one ``[N, 20]`` coefficient matrix for all objects, ``[N, 3]``
colors, ``[N]`` reflection ratios and a struct-of-arrays light table, with the
same dtypes as the JAX package's (f64 geometry, f32 colors, bool light kinds).
Image size and ``max_reflections`` are plain Python ints.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from ..ops.camera import Camera
from . import light as light_mod
from . import surface as surface_mod
from .errors import validate_color, validate_positive

# Reference defaults (reference: src/scene.cpp:6-7): the reference's README
# claims a black default background but its code says white; the code wins.
DEFAULT_MAX_REFLECTIONS = 5
DEFAULT_BG_COLOR = (1.0, 1.0, 1.0)

_TENSOR_FIELDS = ("coefs", "colors", "reflection", "light_p", "light_color",
                  "light_is_spherical", "bg_color", "tan_half_fov")


@dataclasses.dataclass(frozen=True)
class Object:
    """One object prior to stacking (reference: include/scene.h:8-15)."""

    surface: np.ndarray        # [20] f64 coefficient vector
    reflection_ratio: float
    color: np.ndarray          # [3] f32

    def __post_init__(self):
        validate_positive("object reflection ratio", self.reflection_ratio)
        validate_color(self.color)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Stacked scene tables plus the image parameters."""

    coefs: torch.Tensor              # [N, 20] surface coefficients
    colors: torch.Tensor             # [N, 3] object albedo
    reflection: torch.Tensor         # [N] reflection ratios
    light_p: torch.Tensor            # [L, 3] direction-to-light (unit) or position
    light_color: torch.Tensor        # [L, 3] intensity-premultiplied color
    light_is_spherical: torch.Tensor  # [L] bool
    bg_color: torch.Tensor           # [3] background color
    tan_half_fov: torch.Tensor       # 0-d: tan(fov_rad / 2) (reference update-cpu.cpp:28)
    width: int
    height: int
    max_reflections: int

    @property
    def n_objects(self) -> int:
        return self.coefs.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_p.shape[0]

    @property
    def aspect_ratio(self) -> float:
        """width/height as a double (reference: include/scene.h:32-33)."""
        return float(self.width) / float(self.height)

    def astype(self, geom_dtype, color_dtype=torch.float32) -> "Scene":
        """Cast the geometry tables (coefs, light positions, tan_half_fov) and
        the color tables."""
        return dataclasses.replace(
            self,
            coefs=self.coefs.to(geom_dtype),
            light_p=self.light_p.to(geom_dtype),
            tan_half_fov=self.tan_half_fov.to(geom_dtype),
            colors=self.colors.to(color_dtype),
            reflection=self.reflection.to(color_dtype),
            light_color=self.light_color.to(color_dtype),
            bg_color=self.bg_color.to(color_dtype),
        )

    def to(self, device) -> "Scene":
        """Move every table to ``device``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})


def build_scene(
    width: int,
    height: int,
    fov_deg: float,
    objects: Sequence[Object],
    lights: Sequence[light_mod.Light],
    max_reflections: int = DEFAULT_MAX_REFLECTIONS,
    bg_color=DEFAULT_BG_COLOR,
    device: str | torch.device = "cuda",
) -> Scene:
    """Assemble a ``Scene`` on ``device`` (the GPU unless the caller asks for
    another) from parsed objects and lights.

    Performs the reference's constructor-time validation (src/scene.cpp:9-22):
    color range checks and the degrees-to-radians fov conversion. Empty object
    or light sequences are legal and give ``[0, ...]`` tables. Without a CUDA
    device the default raises (``resolve_device``); pass ``device="cpu"``
    for a CPU scene.
    """
    bg = np.asarray(bg_color, dtype=np.float32)
    validate_color(bg)
    if not objects:
        coefs = np.zeros((0, surface_mod.N_COEFS), dtype=np.float64)
        obj_colors = np.zeros((0, 3), dtype=np.float32)
        refl = np.zeros((0,), dtype=np.float32)
    else:
        coefs = np.stack([np.asarray(o.surface, dtype=np.float64) for o in objects])
        obj_colors = np.stack([np.asarray(o.color, dtype=np.float32) for o in objects])
        refl = np.asarray([o.reflection_ratio for o in objects], dtype=np.float32)
    if not lights:
        light_p = np.zeros((0, 3), dtype=np.float64)
        light_color = np.zeros((0, 3), dtype=np.float32)
        light_sph = np.zeros((0,), dtype=bool)
    else:
        light_p = np.stack([l.p for l in lights])
        light_color = np.stack([l.color for l in lights])
        light_sph = np.asarray([l.is_spherical for l in lights], dtype=bool)

    fov_rad = math.radians(float(fov_deg))
    return scene_from_arrays(
        coefs, obj_colors, refl, light_p, light_color, light_sph, bg,
        np.float64(math.tan(0.5 * fov_rad)), width, height, max_reflections,
        device=device,
    )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it names CUDA and no
    CUDA device is present, so that a scene never lands on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for the scene tables (device={str(device)!r}, "
            "torch.cuda.is_available() is false); pass device=\"cpu\" to load "
            "or build the scene on the CPU")
    return dev


def scene_from_arrays(coefs, colors, reflection, light_p, light_color,
                      light_is_spherical, bg_color, tan_half_fov, width: int,
                      height: int, max_reflections: int, device) -> Scene:
    """A ``Scene`` on ``device`` from numpy arrays, keeping their dtypes.

    This is how a scene crosses from the JAX package: ``np.asarray`` of each
    field of a ``tpu_ray_tracer`` ``Scene`` gives these arguments.
    """
    t = functools.partial(_tensor, device=resolve_device(device))
    return Scene(
        coefs=t(coefs), colors=t(colors), reflection=t(reflection),
        light_p=t(light_p), light_color=t(light_color),
        light_is_spherical=t(light_is_spherical), bg_color=t(bg_color),
        tan_half_fov=t(tan_half_fov), width=int(width), height=int(height),
        max_reflections=int(max_reflections),
    )


def camera_from_arrays(position, yaw_deg, pitch_deg, device) -> Camera:
    """A ``Camera`` on ``device`` from numpy values, keeping their dtypes;
    ``np.asarray`` of a ``tpu_ray_tracer`` ``Camera``'s fields gives them."""
    t = functools.partial(_tensor, device=device)
    return Camera(position=t(position), yaw_deg=t(yaw_deg), pitch_deg=t(pitch_deg))


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def static_bounce_count(scene: Scene) -> int:
    """Trip count of the reflection chain.

    0 when no object is reflective (all ratios <= EPS, the loop-entry test
    of reference src/update-cpu.cpp:97); otherwise ``scene.max_reflections``
    traced bounces, followed by the at-cap background blend
    (src/update-cpu.cpp:98-101). Reads the reflection table on the host.
    """
    refl = scene.reflection
    if refl.numel() == 0 or float(refl.max()) <= 1e-7:
        return 0
    return scene.max_reflections
