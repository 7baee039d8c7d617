"""Branch-free vectorized polynomial root selection.

Counterpart of ``tpu_ray_tracer/ops/roots.py``: the reference's
``intersect_ray`` root-finding tail (reference: include/surface_impl.h:106-154)
as masked tensor math that solves every (ray, object) pair at once:

* degree 3 (|t3| > EPS): depressed-cubic Cardano when the discriminant is
  positive (single real root, returned unconditionally even if negative —
  reference surface_impl.h:114-120); trigonometric (Viete) formula when three
  real roots exist, with the reference's *asymmetric* selection: start from
  the k=0 candidate without checking >= EPS, replace only by candidates that
  are >= EPS and strictly smaller (surface_impl.h:121-135).
* degree 2 (|t2| > EPS): smaller quadratic root if >= EPS, else the larger
  root even if negative; -1 on negative discriminant (surface_impl.h:138-149).
* degree 1 (|t1| > EPS): -t0/t1 (surface_impl.h:150-153).
* else: -1 (surface_impl.h:154).

All branches are evaluated with sanitized operands and combined with
``torch.where``; classification thresholds use the reference's EPS = 1e-7
on the raw (unnormalized) coefficients. Nothing here is differentiated:
``ops/intersect.py`` replaces the roots' backward by the implicit function
theorem, so a NaN in an unselected branch cannot reach a gradient.
"""

from __future__ import annotations

import torch

from .constants import EPS, TWO_THIRD_PI
from .poly import eval_poly, eval_poly_and_slope, eval_poly_magnitude


def cbrt(x):
    """Real cube root that keeps the sign (torch has no ``cbrt``).

    sign(x) |x|^(1/3), then one Newton step y + (x/y^2 - y)/3, written so
    that no intermediate overflows: the power's rounded exponent is off by
    up to |ln x| * 1e-8 relative in f32, and the step brings the result to
    within 2 ulp of ``np.cbrt`` in f32 and f64 (tests/test_torch_ops.py).
    0, +-inf and NaN pass through as ``np.cbrt`` gives them."""
    ax = torch.abs(x)
    y = torch.pow(ax, 1.0 / 3.0)
    ok = (y > 0) & torch.isfinite(y)
    ys = torch.where(ok, y, torch.ones_like(y))
    y = torch.where(ok, ys + (ax / (ys * ys) - ys) / 3.0, y)
    return torch.copysign(y, x)


def _safe_div(num, den):
    """num/den with 1.0 substituted for zero denominators; callers mask the
    result out of the final select."""
    return num / torch.where(den == 0, torch.ones_like(den), den)


def min_positive_root(t3, t2, t1, t0, polish_fn=None):
    """Select a ray parameter following the reference's branch semantics.

    Args/returns are broadcast-compatible tensors; the result contains the
    reference's per-pair return value (possibly negative or -1 for miss).

    polish_fn: optional ``t -> refined t`` applied to every *candidate*
    root before the selection comparisons. The f32 fast path passes a
    direct-evaluation Newton refiner here: candidate accuracy (not branch
    algebra) is what decides the >= EPS / strictly-smaller comparisons, so
    polishing candidates first makes f32 selection agree with f64.

    The values are the JAX function's, operation for operation; the order
    differs where eager torch would otherwise hold every intermediate of
    the solve at once (a shadow solve's are [rays, lights, objects] each):
    intermediates are dropped as soon as they are spent, each polished
    cubic candidate enters the selection as soon as it is made, and the
    dominant-balance quadratic roots of the polished selection are the
    quadratic branch's own (the same operations on the same values).
    """
    t3, t2, t1, t0 = torch.broadcast_tensors(t3, t2, t1, t0)
    polished = polish_fn is not None
    if polish_fn is None:
        polish_fn = lambda t: t  # noqa: E731
    one = torch.ones_like(t3)
    neg_one = -one

    is_cubic = torch.abs(t3) > EPS
    is_quad = torch.abs(t2) > EPS
    is_lin = torch.abs(t1) > EPS

    # --- linear branch (reference surface_impl.h:150-153) ---
    lin_root = -_safe_div(t0, torch.where(is_lin, t1, one))

    # --- cubic branch (reference surface_impl.h:107-136), its seeds ---
    s3 = torch.where(is_cubic, t3, one)
    a = t2 / s3
    b = t1 / s3
    c = t0 / s3
    # --- quadratic branch (reference surface_impl.h:138-149), unpolished ---
    s2 = torch.where(is_quad, t2, one)
    disc = t1 * t1 - 4.0 * t2 * t0
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    lo = (-t1 - sqrt_disc) / (2.0 * s2)
    hi = (-t1 + sqrt_disc) / (2.0 * s2)
    del t3, t2, t1, t0, s3, s2, sqrt_disc
    # Scale-normalize t = s*u before the discriminant: near-degenerate
    # cubics (|t3| barely above EPS) give |a| ~ 1e6+, and q^3 + r^2 then
    # overflows f32. The substitution keeps q, r, delta O(1) and preserves
    # the discriminant's sign exactly (delta scales by s^-6 > 0), so branch
    # selection matches the reference's unscaled double math.
    s = torch.maximum(
        torch.maximum(torch.abs(a), torch.sqrt(torch.abs(b))),
        torch.maximum(cbrt(torch.abs(c)), torch.full_like(c, 1e-30)),
    )
    a = a / s
    b = b / (s * s)
    c = c / (s * s * s)
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a * a * a) / 54.0
    del b, c
    delta = q * q * q + r * r

    # delta > 0: Cardano, single real root, returned unconditionally.
    sqrt_delta = torch.sqrt(torch.clamp(delta, min=0.0))
    cardano = s * (cbrt(r + sqrt_delta) + cbrt(r - sqrt_delta) - a / 3.0)
    del sqrt_delta

    # delta <= 0: three real roots via the trigonometric formula. Here
    # q <= 0 (since q^3 <= -r^2 <= 0), so -q >= 0.
    q_neg = torch.clamp(-q, min=0.0)
    denom = torch.sqrt(q_neg * q_neg * q_neg)
    ratio = torch.clamp(_safe_div(r, denom), -1.0, 1.0)
    del q, r, denom
    theta = torch.arccos(ratio) / 3.0
    two_sqrt_q = 2.0 * torch.sqrt(q_neg)
    a_third = a / 3.0
    del ratio, q_neg, a

    def trig(k):
        return s * (two_sqrt_q * torch.cos(theta + k * TWO_THIRD_PI) - a_third)

    lo, hi = polish_fn(lo), polish_fn(hi)
    quad_root = torch.where(disc < 0, neg_one, torch.where(lo >= EPS, lo, hi))
    del disc

    if polished:
        # Robust selection for the refined fast path. With candidates
        # polished onto the true real-root set (and non-roots rejected),
        # the reference's asymmetric rule — start from the largest trig
        # root, replace by strictly-smaller candidates >= EPS; Cardano
        # returned unconditionally — reduces exactly to "smallest genuine
        # root >= EPS, else miss": every sub-EPS outcome is a miss either
        # way. Taking the min over *all* candidates removes the f32
        # sensitivity to the sign of delta (near-degenerate cubics flip it),
        # while agreeing with the branch form wherever f64 agrees with
        # itself. For |t3| barely above EPS the trig/Cardano seeds are
        # garbage, so the roots of the dominant-balance quadratic
        # t2 t^2 + t1 t + t0 (the quadratic branch's lo and hi) are extra
        # candidates — for such cubics the true small roots are near them
        # (the third root is ~ -t2/t3, huge), and for well-conditioned
        # cubics they either converge to genuine roots or get rejected.
        # The minimum does not depend on the order the candidates enter.
        def candidates():
            yield polish_fn(cardano)
            for k in (0.0, 1.0, 2.0):
                yield polish_fn(trig(k))
            yield lo
            yield hi

        big = torch.full_like(one, 2.0 * _FAKE_ROOT)
        cubic_root = big
        for cand in candidates():
            take = (cand >= EPS) & (cand < cubic_root)
            cubic_root = torch.where(take, cand, cubic_root)
        cubic_root = torch.where(cubic_root >= big, neg_one, cubic_root)
    else:
        # Exact reference branching (golden path, f64).
        x = trig(0.0)
        for k in (1.0, 2.0):
            cand = trig(k)
            x = torch.where((cand >= EPS) & (cand < x), cand, x)
        cubic_root = torch.where(delta > 0, cardano, x)

    return torch.where(
        is_cubic,
        cubic_root,
        torch.where(is_quad, quad_root, torch.where(is_lin, lin_root, neg_one)),
    )


# Sanitized value for candidates that fail the genuine-root residual test:
# past MAX_T so hit-validity rejects them, and larger than any real candidate
# so the strictly-smaller selection never picks them.
_FAKE_ROOT = 2e6
# |F(p)| must be below this fraction of the evaluation magnitude for a
# polished candidate to count as a root. Genuine roots polish to ~1e-7
# relative; grazing near-misses bottom out around 1e-4..1e-5 relative.
_RESIDUAL_TOL = 1e-5


def make_newton_polisher(coefs, origin, dir, iters: int):
    """Build a candidate refiner ``t [..., N] -> t`` for ``min_positive_root``.

    Newton steps against a *direct* evaluation of F(origin + t*dir) — not the
    expanded t-polynomial — so the refinement is free of the expansion's
    cancellation error. This is the core of the f32 fast path: the analytic
    solver supplies branch structure and seeds, direct Newton supplies the
    final bits.

    After refinement a residual test rejects candidates that are not genuine
    roots (f32 branch misclassification on near-degenerate cubics produces
    phantom candidates the f64 reference never returns); rejects are mapped
    past MAX_T so they read as misses, which is what the reference's f64
    arithmetic yields in those lanes. Negative candidates are left untouched
    — the reference's semantics (e.g. Cardano's unconditional return) rely
    on their sign only.

    Args:
      coefs: [N, 20]; origin/dir: [..., 3] (broadcast against candidates).
    """
    if iters <= 0:
        return None

    def polish(t):
        seed = t
        for _ in range(iters):
            point = origin[..., None, :] + t[..., None] * dir[..., None, :]
            f, df = eval_poly_and_slope(coefs, point, dir[..., None, :])
            ok_df = torch.abs(df) > 1e-12
            step = torch.where(ok_df, f / torch.where(ok_df, df, torch.ones_like(df)),
                               torch.zeros_like(df))
            t_new = t - step
            t = torch.where(torch.isfinite(t_new), t_new, t)
        point = origin[..., None, :] + t[..., None] * dir[..., None, :]
        residual = torch.abs(eval_poly(coefs, point))
        magnitude = eval_poly_magnitude(coefs, point)
        genuine = residual <= _RESIDUAL_TOL * magnitude
        # Genuine roots keep their polished value. Non-roots: a negative
        # seed stays negative (it reads as a miss and sign-based reference
        # semantics survive); a positive fake candidate is pushed past
        # MAX_T so neither validity nor strictly-smaller selection takes it.
        return torch.where(genuine, t, torch.where(seed < 0, seed,
                                                   torch.full_like(seed, _FAKE_ROOT)))

    return polish
