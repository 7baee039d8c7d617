"""Light sources.

Counterpart of ``tpu_ray_tracer/models/light.py`` (reference: include/light.h:6-13,
src/light.cpp:4-26):

* ``directional(intensity, dir, color)`` stores ``p = -normalize(dir)``, the
  unit vector toward the light, and ``color = intensity * color``;
* ``spherical(intensity, pos, color)`` stores the position and the same
  premultiplied color; its irradiance falls off as inverse-square.

A light is a host-side record of numpy values; ``build_scene`` stacks a
scene's lights into struct-of-arrays tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import validate_color, validate_positive


@dataclasses.dataclass(frozen=True)
class Light:
    is_spherical: bool
    p: np.ndarray          # [3] f64: unit direction toward the light, or position
    color: np.ndarray      # [3] f32: intensity premultiplied


def directional(intensity: float, direction, color) -> Light:
    """Directional light (reference: src/light.cpp:4-14)."""
    validate_positive("light intensity", intensity)
    color = np.asarray(color, dtype=np.float32)
    validate_color(color)
    d = np.asarray(direction, dtype=np.float64)
    d = d / np.linalg.norm(d)
    return Light(is_spherical=False, p=-d, color=np.float32(intensity) * color)


def spherical(intensity: float, position, color) -> Light:
    """Spherical (point, inverse-square) light (reference: src/light.cpp:16-26)."""
    validate_positive("light intensity", intensity)
    color = np.asarray(color, dtype=np.float32)
    validate_color(color)
    return Light(
        is_spherical=True,
        p=np.asarray(position, dtype=np.float64),
        color=np.float32(intensity) * color,
    )
