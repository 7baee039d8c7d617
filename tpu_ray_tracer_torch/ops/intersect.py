"""Ray-surface intersection with an implicit-function-theorem backward.

Counterpart of ``tpu_ray_tracer/ops/intersect.py``, whose ``custom_vjp``
becomes a ``torch.autograd.Function``.

Forward: expand F(o + t*d) per object into a cubic in t (``poly.ray_poly_coeffs``)
and select the reference's root (``roots.min_positive_root``), optionally
polished by Newton steps — the vectorized analogue of reference
``intersect_ray`` (include/surface_impl.h:21-155).

Backward: rather than differentiating through Cardano/acos (numerically
fragile near branch points), the implicit function theorem at the root:
with g(t; coefs, o, d) = F(o + t*d),

    dt/dtheta = -(dg/dtheta) / (dg/dt)        at g(t) = 0

where dg/dt = grad F . d, dg/dcoefs_m = monomial_m(o + t*d),
dg/do = grad F, dg/dd = t * grad F. Lanes with no valid positive root or a
grazing hit (|dg/dt| below a clamp) receive zero gradient — the discrete
branch/selection structure is treated as locally constant, the standard
differentiable-rendering treatment for visibility.
"""

from __future__ import annotations

import torch

from .constants import EPS, MAX_T
from .poly import _gradient_axes, _monomials, ray_poly_coeffs
from .roots import make_newton_polisher, min_positive_root

# Below this |dF/dt| the hit is grazing and dt/dtheta blows up; zero it out.
_GRAZING_CLAMP = 1e-6


def _solve(coefs, origin, dir, polish_iters):
    # the coefficients pass straight in, so that the solve can drop them
    # once spent
    return min_positive_root(*ray_poly_coeffs(coefs, origin, dir),
                             make_newton_polisher(coefs, origin, dir, polish_iters))


def _intersect_bwd(res, g, needs):
    """The IFT rule at the roots ``t``: cotangents of (coefs, origin, dir)
    for the root table's cotangent ``g`` [..., N], each None where ``needs``
    (three flags) does not ask for it. ``res`` is (coefs, origin, dir, t).
    The counterpart of the JAX package's ``_intersect_bwd``; the soft
    render's reattached roots (``diff/soft.py``) use it too."""
    coefs, origin, dir, t = res
    want_coefs, want_origin, want_dir = needs
    # Point on each object's candidate hit: [..., N, 3]
    point = origin[..., None, :] + t[..., None] * dir[..., None, :]
    gx, gy, gz = _gradient_axes(coefs, point)                  # each [..., N]
    d = dir[..., None, :]
    df_dt = gx * d[..., 0] + gy * d[..., 1] + gz * d[..., 2]   # [..., N]

    valid = (t >= EPS) & (t < MAX_T) & (torch.abs(df_dt) > _GRAZING_CLAMP)
    inv = torch.where(valid, -1.0 / torch.where(valid, df_dt, torch.ones_like(df_dt)),
                      torch.zeros_like(df_dt))
    scale = g * inv                                            # [..., N]

    d_coefs = d_origin = d_dir = None
    if want_coefs:
        # dg/dcoefs_m = monomial_m(point), summed over rays column by
        # column: [N, 20] without the [..., N, 20] basis
        n_obj = coefs.shape[0]
        d_coefs = torch.stack(
            [(scale * mono).reshape(-1, n_obj).sum(0) for mono in _monomials(point)],
            dim=-1).to(coefs.dtype)
    # dg/do = grad F, dg/dd = t * grad F: reduce over objects -> [..., 3]
    if want_origin or want_dir:
        grad_f = torch.stack([gx, gy, gz], dim=-1)             # [..., N, 3]
    if want_origin:
        d_origin = (scale[..., None] * grad_f).sum(-2).sum_to_size(origin.shape)
        d_origin = d_origin.to(origin.dtype)
    if want_dir:
        d_dir = ((scale * t)[..., None] * grad_f).sum(-2).sum_to_size(dir.shape)
        d_dir = d_dir.to(dir.dtype)
    return d_coefs, d_origin, d_dir


class _IntersectAll(torch.autograd.Function):
    """The solve forward, the IFT rule of ``_intersect_bwd`` backward."""

    @staticmethod
    def forward(ctx, coefs, origin, dir, polish_iters):
        t = _solve(coefs, origin, dir, polish_iters)
        ctx.save_for_backward(coefs, origin, dir, t)
        return t

    @staticmethod
    def backward(ctx, g):
        return (*_intersect_bwd(ctx.saved_tensors, g, ctx.needs_input_grad[:3]), None)


def intersect_all(coefs, origin, dir, polish_iters: int = 0):
    """Ray parameters for all (ray, object) pairs.

    Args:
      coefs: [N, 20] object coefficients.
      origin: [..., 3] ray origins.
      dir: [..., 3] ray directions.
      polish_iters: Newton refinement steps (0 for the f64 golden path, ~2-3
        for the f32 fast path).

    Returns:
      t: [..., N] per the reference's return-value semantics (may be
      negative / -1 on miss; validity is decided by the caller via
      ``EPS <= t < MAX_T``, reference src/update-cpu.cpp:52). Differentiable
      in coefs, origin and dir by the implicit function theorem.
    """
    return _IntersectAll.apply(coefs, origin, dir, int(polish_iters))


def valid_hit_mask(t):
    """Primary-hit validity: ``EPS <= t < MAX_T`` (reference:
    src/update-cpu.cpp:52)."""
    return (t >= EPS) & (t < MAX_T)


def occluder_mask(t, max_t):
    """Shadow-ray occlusion validity: ``EPS < t < max_t`` — note the strict
    lower bound, unlike primary hits (reference: src/update-cpu.cpp:68)."""
    return (t > EPS) & (t < max_t)
