"""Trivariate polynomial evaluation and ray-restriction expansion, vectorized.

Counterpart of ``tpu_ray_tracer/ops/poly.py``. ``_EXPANSION[k][m]`` lists
``(binomial weight, origin powers, direction powers)`` such that the
coefficient of ``t^k`` in ``monomial_m(o + t d)`` is
``sum w * o_x^ix o_y^iy o_z^iz * d_x^jx d_y^jy d_z^jz`` with jx+jy+jz = k, in
the binomial-theorem order the reference's macros expand
(reference: include/surface_impl.h:25-41). csrc/render_fwd.cu walks the same
entries in the same order.

Every contraction over the 20 monomials is a multiply-and-add loop in the
inputs' dtype, never a matrix product: a TF32 or reduced-precision matmul
setting (``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision``) cannot reach it, where the JAX
package has to ask for ``Precision.HIGHEST``. The loops also keep the
[..., N] shape of their results: ``eval_poly`` and ``poly_gradient`` on
points [..., N, 3] never build the [..., N, 20] monomial basis, which for
a shadow solve is 20 times the solve's own size.
"""

from __future__ import annotations

from math import comb

import torch

from ..models.surface import MONOMIAL_POWERS, N_COEFS


def _build_expansion():
    table = [[[] for _ in range(N_COEFS)] for _ in range(4)]
    for m, (px, py, pz) in enumerate(MONOMIAL_POWERS):
        for jx in range(px + 1):
            for jy in range(py + 1):
                for jz in range(pz + 1):
                    k = jx + jy + jz
                    coeff = comb(px, jx) * comb(py, jy) * comb(pz, jz)
                    table[k][m].append(
                        (float(coeff), (px - jx, py - jy, pz - jz), (jx, jy, jz))
                    )
    return table


_EXPANSION = _build_expansion()


def _powers(x, y, z, max_pow=3):
    """Cache x^e, y^e, z^e for e in [1, max_pow]."""
    cache = [[None] * (max_pow + 1) for _ in range(3)]
    for axis, comp in enumerate((x, y, z)):
        cache[axis][1] = comp
        for e in range(2, max_pow + 1):
            cache[axis][e] = cache[axis][e - 1] * comp
    return cache


def _product(cache, powers, scalar_one):
    """Product of cached powers; returns `scalar_one` for the empty product."""
    out = None
    for axis, e in enumerate(powers):
        if e == 0:
            continue
        term = cache[axis][e]
        out = term if out is None else out * term
    return scalar_one if out is None else out


def _contract(terms, coefs):
    """sum_m terms[m] * coefs[..., m], in m order (a multiply-and-add loop
    that consumes ``terms`` one at a time; a None term is a zero column)."""
    acc = None
    for m, term in enumerate(terms):
        if term is None:
            continue
        prod = term * coefs[..., m]
        acc = prod if acc is None else acc + prod
    return acc


def _basis_columns(origin, dir):
    """For k = 3, 2, 1, 0 the 20 columns [...] of the t^k basis (None for a
    zero one), one k at a time."""
    o = _powers(origin[..., 0], origin[..., 1], origin[..., 2])
    d = _powers(dir[..., 0], dir[..., 1], dir[..., 2])
    one = torch.ones_like(origin[..., 0])
    for k in range(3, -1, -1):
        cols = []
        for m in range(N_COEFS):
            acc = None
            for coeff, o_pows, d_pows in _EXPANSION[k][m]:
                term = _product(o, o_pows, one) * _product(d, d_pows, one)
                if coeff != 1.0:
                    term = term * coeff
                acc = term if acc is None else acc + term
            cols.append(acc)
        yield cols


def ray_basis(origin, dir):
    """Per-ray expansion basis.

    Args:
      origin: [..., 3] ray origins.
      dir: [..., 3] ray directions (need not be normalized).

    Returns:
      (b3, b2, b1, b0), each [..., 20]: coefficient of t^k in each monomial
      restricted to the ray, matching reference surface_impl.h:25-41.
    """
    origin, dir = torch.broadcast_tensors(origin, dir)
    zero = torch.zeros_like(origin[..., 0])
    return tuple(torch.stack([zero if c is None else c for c in cols], dim=-1)
                 for cols in _basis_columns(origin, dir))


def ray_poly_coeffs(coefs, origin, dir):
    """Cubic-in-t coefficients of F(origin + t*dir) for every object.

    Args:
      coefs: [N, 20] object coefficient matrix.
      origin: [..., 3], dir: [..., 3].

    Returns:
      (t3, t2, t1, t0), each [..., N] — the reference's t3/t2/t1/t0
      (surface_impl.h:44-103) for all ray x object pairs, contracted in true
      f32 (f64) whatever the matmul precision settings say.
    """
    origin, dir = torch.broadcast_tensors(origin, dir)
    out = []
    for cols in _basis_columns(origin, dir):
        acc = _contract((None if c is None else c[..., None] for c in cols), coefs)
        out.append(acc if acc is not None else
                   torch.zeros(origin.shape[:-1] + coefs.shape[:1], dtype=origin.dtype,
                               device=origin.device))
    return tuple(out)


def _monomials(point):
    """The 20 monomials at `point` [..., 3], each [...], one at a time."""
    p = _powers(point[..., 0], point[..., 1], point[..., 2])
    one = torch.ones_like(point[..., 0])
    return (_product(p, pows, one) for pows in MONOMIAL_POWERS)


def monomial_basis(point):
    """[..., 20] values of every monomial at `point` (for F evaluation and
    the coefficient-gradient of the implicit function theorem VJP)."""
    return torch.stack(list(_monomials(point)), dim=-1)


def eval_poly(coefs, point):
    """F(point) per object: coefs [..., 20] (possibly gathered per ray),
    point [..., 3] -> [...]."""
    return _contract(_monomials(point), coefs)


def eval_poly_magnitude(coefs, point):
    """sum_m |coef_m * monomial_m(point)| — the evaluation's absolute
    magnitude, the natural scale for root-residual tests (a genuine root has
    |F| of order eps * magnitude; a fake candidate does not)."""
    acc = None
    for m, mono in enumerate(_monomials(point)):
        term = torch.abs(coefs[..., m] * mono)
        acc = term if acc is None else acc + term
    return acc


def _gradient_columns(cache, one, axis):
    """The 20 columns d monomial_m / d axis at the cached point powers (None
    for a zero one), one at a time."""
    for pows in MONOMIAL_POWERS:
        e = pows[axis]
        if e == 0:
            yield None
            continue
        dpows = list(pows)
        dpows[axis] = e - 1
        term = _product(cache, dpows, one)
        yield term * float(e) if e != 1 else term


def _gradient_axes(coefs, point, cache=None):
    """[dF/dx, dF/dy, dF/dz], each [...] (``cache``: the point's powers)."""
    p = cache or _powers(point[..., 0], point[..., 1], point[..., 2])
    one = torch.ones_like(point[..., 0])
    return [_contract(_gradient_columns(p, one, axis), coefs) for axis in range(3)]


def poly_gradient(coefs, point):
    """Unnormalized gradient of F at `point` (closed form, matching
    reference normal_vector before normalization, surface_impl.h:157-172).

    Args:
      coefs: [..., 20] per-ray gathered coefficients (or broadcastable).
      point: [..., 3].

    Returns:
      [..., 3] gradient dF/d(x, y, z).
    """
    return torch.stack(_gradient_axes(coefs, point), dim=-1)


def eval_poly_and_slope(coefs, point, dir):
    """(F(point), grad F(point) . dir), each [...], from one cache of the
    point's powers: ``eval_poly`` and ``(poly_gradient * dir).sum(-1)`` in
    the same order, for the Newton steps of ``roots.make_newton_polisher``."""
    p = _powers(point[..., 0], point[..., 1], point[..., 2])
    one = torch.ones_like(point[..., 0])
    f = _contract((_product(p, pows, one) for pows in MONOMIAL_POWERS), coefs)
    g = _gradient_axes(coefs, point, p)
    return f, g[0] * dir[..., 0] + g[1] * dir[..., 1] + g[2] * dir[..., 2]


def normal_vector(coefs, point):
    """Unit surface normal = normalized gradient (reference:
    surface_impl.h:157-172)."""
    grad = poly_gradient(coefs, point)
    norm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    return grad / torch.where(norm > 0, norm, torch.ones_like(norm))
