"""Algebraic surfaces: degree-<=3 trivariate polynomials as 20-coefficient vectors.

Counterpart of ``tpu_ray_tracer/models/surface.py``. A surface is the zero set
of ``F(x, y, z) = sum_m coef[m] * monomial_m(x, y, z)`` with the monomials in
the reference's order (reference: include/surface.h:10-15)::

    x3 y3 z3 x2y xy2 x2z xz2 y2z yz2 xyz   (degree 3)
    x2 y2 z2 xy xz yz                      (degree 2)
    x  y  z                               (degree 1)
    c                                     (degree 0)

The constructors are host-side parsing helpers and return ``[20]`` float64
numpy vectors, exactly as the JAX package builds them; ``build_scene`` stacks
them into the scene's ``[N, 20]`` tensor. Keeping the construction in numpy
makes the loaded tables bit-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np

COEF_NAMES = (
    "x3", "y3", "z3", "x2y", "xy2", "x2z", "xz2", "y2z", "yz2", "xyz",
    "x2", "y2", "z2", "xy", "xz", "yz",
    "x", "y", "z", "c",
)
COEF_INDEX = {name: i for i, name in enumerate(COEF_NAMES)}
N_COEFS = len(COEF_NAMES)

# Monomial exponents (px, py, pz) per coefficient, same order as COEF_NAMES.
# csrc/render_fwd.cu carries the same table (mono_code); keep them in step.
MONOMIAL_POWERS = (
    (3, 0, 0), (0, 3, 0), (0, 0, 3), (2, 1, 0), (1, 2, 0), (2, 0, 1), (1, 0, 2),
    (0, 2, 1), (0, 1, 2), (1, 1, 1),
    (2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (0, 0, 0),
)


def _zeros() -> np.ndarray:
    return np.zeros(N_COEFS, dtype=np.float64)


def from_named(**coefs: float) -> np.ndarray:
    """Coefficient vector from named monomials (unnamed ones are 0), as the
    reference's ``polynomial`` scene type reads them (src/scene.cpp:126-147)."""
    vec = _zeros()
    for name, value in coefs.items():
        if name not in COEF_INDEX:
            raise KeyError(f"Unknown surface coefficient: {name!r}")
        vec[COEF_INDEX[name]] = float(value)
    return vec


def sphere(center, radius: float) -> np.ndarray:
    """Sphere |p - center|^2 = r^2 (reference: src/surface.cpp:4-15)."""
    from .errors import validate_positive

    validate_positive("sphere radius", radius)
    cx, cy, cz = (float(v) for v in center)
    vec = _zeros()
    vec[COEF_INDEX["x2"]] = vec[COEF_INDEX["y2"]] = vec[COEF_INDEX["z2"]] = 1.0
    vec[COEF_INDEX["x"]] = -2.0 * cx
    vec[COEF_INDEX["y"]] = -2.0 * cy
    vec[COEF_INDEX["z"]] = -2.0 * cz
    vec[COEF_INDEX["c"]] = cx * cx + cy * cy + cz * cz - float(radius) * float(radius)
    return vec


def plane(origin, normal) -> np.ndarray:
    """Plane through `origin` with normal `normal` (reference: src/surface.cpp:17-25)."""
    ox, oy, oz = (float(v) for v in origin)
    nx, ny, nz = (float(v) for v in normal)
    vec = _zeros()
    vec[COEF_INDEX["x"]] = nx
    vec[COEF_INDEX["y"]] = ny
    vec[COEF_INDEX["z"]] = nz
    vec[COEF_INDEX["c"]] = -(ox * nx + oy * ny + oz * nz)
    return vec


def ding_dong(origin) -> np.ndarray:
    """Ding-dong cubic x^2 + y^3 - y^2 + z^2, translated (reference: src/surface.cpp:27-39)."""
    ox, oy, oz = (float(v) for v in origin)
    vec = _zeros()
    vec[COEF_INDEX["x2"]] = vec[COEF_INDEX["y3"]] = vec[COEF_INDEX["z2"]] = 1.0
    vec[COEF_INDEX["y2"]] = -1.0 - 3.0 * oy
    vec[COEF_INDEX["x"]] = -2.0 * ox
    vec[COEF_INDEX["z"]] = -2.0 * oz
    vec[COEF_INDEX["y"]] = (2.0 + 3.0 * oy) * oy
    vec[COEF_INDEX["c"]] = ox**2 + oz**2 - oy**2 * (1.0 + oy)
    return vec


def clebsch() -> np.ndarray:
    """Clebsch cubic, with the reference's z3=0 typo preserved.

    Reference src/surface.cpp:44 writes ``coef.x3 = coef.y3 = coef.x3 = 81.0``:
    ``x3`` is assigned twice and ``z3`` never, so ``z3`` stays 0. The rendered
    surface is therefore not the symmetric Clebsch cubic; these are the
    values the reference renders.
    """
    vec = _zeros()
    vec[COEF_INDEX["x3"]] = vec[COEF_INDEX["y3"]] = 81.0
    # z3 intentionally 0 (reference typo, see docstring)
    for name in ("x2y", "x2z", "xy2", "y2z", "xz2", "yz2"):
        vec[COEF_INDEX[name]] = -189.0
    vec[COEF_INDEX["xyz"]] = 54.0
    for name in ("xy", "yz", "xz"):
        vec[COEF_INDEX[name]] = 126.0
    for name in ("x2", "y2", "z2"):
        vec[COEF_INDEX[name]] = -9.0
    for name in ("x", "y", "z"):
        vec[COEF_INDEX[name]] = 9.0
    vec[COEF_INDEX["c"]] = 1.0
    return vec


def cayley() -> np.ndarray:
    """Cayley cubic (reference: src/surface.cpp:54-60)."""
    vec = _zeros()
    for name in ("x2y", "x2z", "xy2", "y2z", "xz2", "yz2"):
        vec[COEF_INDEX[name]] = -5.0
    for name in ("xy", "yz", "xz"):
        vec[COEF_INDEX[name]] = 2.0
    return vec
