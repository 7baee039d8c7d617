"""Shading math: shadow rays, Lambertian surface response, reflections.

Counterpart of ``tpu_ray_tracer/ops/shading.py``. Vectorized over rays *and*
lights; the spherical/directional split is a mask instead of a branch.
Mirrors reference include/light_impl.h:17-49:

* ``shadow_ray``: spherical light -> the *unnormalized* vector to the light
  with max_t = 1 (t parametrizes [surface, light]); directional -> the stored
  unit direction with max_t = 1e6. The reference returns a single-precision
  ``glm::vec3`` here even from double inputs (light_impl.h:17) — that
  quantization is kept, for bit parity of the golden path.
* ``surface_color``: Lambertian albedo/pi * light color * max(0, n.l);
  spherical lights add an inverse-square 1/(4 pi r^2) falloff
  (light_impl.h:29-44). Color math is f32 (glm vec3), geometry dots are
  computed in the geometry dtype then cast, as in the reference.
* ``reflect_ray``: d - 2 (d.n) n (light_impl.h:46-49).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import MAX_T

# f32 roundings of the constants, as jnp.float32(...) gives them
_INV_PI = float(np.float32(1.0 / math.pi))
_FOUR_PI = float(np.float32(4.0 * math.pi))


def shadow_ray_dirs(light_p, light_is_spherical, point):
    """Shadow-ray directions and parametric range for all lights.

    Args:
      light_p: [L, 3] (geometry dtype).
      light_is_spherical: [L] bool.
      point: [..., 3] surface points.

    Returns:
      (shadow_dir [..., L, 3], max_t [L]) — shadow_dir is passed through f32
      as in the reference (vec3 return type, light_impl.h:17).
    """
    to_light = light_p - point[..., None, :]                      # [..., L, 3]
    sdir = torch.where(light_is_spherical[..., None], to_light, light_p)
    sdir = sdir.to(torch.float32).to(point.dtype)
    max_t = torch.where(light_is_spherical, torch.ones((), dtype=point.dtype,
                                                       device=point.device),
                        torch.full((), MAX_T, dtype=point.dtype, device=point.device))
    return sdir, max_t


def surface_color(light_p, light_is_spherical, light_color, point, normal,
                  object_color):
    """Per-light Lambertian contribution (reference: light_impl.h:29-44).

    Args:
      light_p: [L, 3], light_is_spherical: [L], light_color: [L, 3] f32.
      point/normal: [..., 3] geometry dtype.
      object_color: [..., 3] f32.

    Returns:
      [..., L, 3] f32 contributions (not yet shadow-masked or clamped).
    """
    to_light = light_p - point[..., None, :]                      # [..., L, 3]
    dist2 = (to_light * to_light).sum(-1)                          # geometry dtype
    norm = torch.sqrt(dist2)
    unit_to_light = to_light / torch.where(norm > 0, norm, torch.ones_like(norm))[..., None]
    ldir = torch.where(light_is_spherical[..., None], unit_to_light, light_p)

    falloff = light_color / (_FOUR_PI * dist2.to(torch.float32)[..., None])
    color = torch.where(light_is_spherical[..., None], falloff, light_color)

    ndotl = (normal[..., None, :] * ldir).sum(-1)
    lambert = torch.maximum(torch.zeros((), dtype=torch.float32, device=ndotl.device),
                            ndotl.to(torch.float32))
    return object_color[..., None, :] * _INV_PI * color * lambert[..., None]


def reflect_ray(dir, normal):
    """Mirror reflection d - 2 (d.n) n (reference: light_impl.h:46-49)."""
    return dir - 2.0 * (dir * normal).sum(-1, keepdim=True) * normal
