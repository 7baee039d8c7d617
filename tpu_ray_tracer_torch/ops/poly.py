"""Ray-restriction expansion table of the 20-monomial basis.

Counterpart of the ``_EXPANSION`` table of ``tpu_ray_tracer/ops/poly.py``
(the rest of that module belongs to the plain pipeline, not yet ported).
``_EXPANSION[k][m]`` lists ``(binomial weight, origin powers, direction
powers)`` such that the coefficient of ``t^k`` in ``monomial_m(o + t d)`` is
``sum w * o_x^ix o_y^iy o_z^iz * d_x^jx d_y^jy d_z^jz`` with jx+jy+jz = k, in
the binomial-theorem order the reference's macros expand
(reference: include/surface_impl.h:25-41). csrc/render_fwd.cu walks the same
entries in the same order.
"""

from __future__ import annotations

from math import comb

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
