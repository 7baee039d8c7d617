"""Soft-visibility rendering for inverse problems on multi-sheet surfaces.

Counterpart of ``tpu_ray_tracer/diff/soft.py``. The pipeline's gradients are
implicit-function-theorem gradients at the selected root: exact almost
everywhere, but blind to the jumps where the set of real roots itself
changes. For multi-sheet cubics (Clebsch) the loss trend over large
surface-coefficient perturbations is carried almost entirely by those jumps,
and plain first-order descent stalls.

The jump events are root PAIR creation and annihilation. They happen where
the depressed cubic's discriminant crosses zero (for a quadric, the
quadratic discriminant: its silhouette), a smooth function of the surface
coefficients:

* ``pair_coverage`` returns the normalized discriminant ``delta_n`` in
  [-1, 1] per (ray, object): negative iff a root pair exists ahead.
* ``render_rays_soft`` renders two hard images, branch A with the normal
  root selection and branch B with the merging pair excluded, and blends
  them per pixel with ``alpha = sigmoid(-delta_n / tau)`` of the pixel's
  governing object. As tau -> 0 the soft render converges to the hard one.

Branch B's roots come from non-differentiable machinery (acos/cbrt seeds,
candidate masking) computed without autograd; ``_IftRoot`` reattaches their
gradients by the implicit function theorem, the backward of
``ops.intersect``. On the card that root table is one launch of a
hand-written kernel (``ops/solve_kernel.roots_excluding_pair``), bit for bit
its plain version. Shadow booleans stay hard, as in the pipeline.
"""

from __future__ import annotations

import torch

from ..models.scene import Scene
from ..ops.constants import EPS, TWO_THIRD_PI
from ..ops.intersect import _intersect_bwd, intersect_all
from ..ops.poly import ray_poly_coeffs
from ..ops.roots import _FAKE_ROOT, cbrt, make_newton_polisher
from ..ops.solve_kernel import roots_excluding_pair
from ..render.pipeline import shade_roots


class _IftRoot(torch.autograd.Function):
    """Identity on a detached root table ``t`` that reattaches gradients to
    (coefs, origin, dir) by the implicit function theorem, the backward of
    ``intersect_all``; ``t`` itself gets none."""

    @staticmethod
    def forward(ctx, coefs, origin, dir, t):
        ctx.save_for_backward(coefs, origin, dir, t)
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return (*_intersect_bwd(ctx.saved_tensors, g, ctx.needs_input_grad[:3]), None)


def _normalized_qr(t3, t2, t1, t0):
    """Scale-normalized depressed-cubic (q, r, s, a, is_cubic) per (ray,
    object), the normalization of ``ops.roots.min_positive_root``."""
    is_cubic = torch.abs(t3) > EPS
    s3 = torch.where(is_cubic, t3, torch.ones_like(t3))
    a = t2 / s3
    b = t1 / s3
    c = t0 / s3
    # The scale only fixes signs and structure (delta scales by s^-6 > 0):
    # detached, so that autograd never meets cbrt or sqrt at zero.
    s = torch.maximum(
        torch.maximum(torch.abs(a), torch.sqrt(torch.abs(b))),
        torch.maximum(cbrt(torch.abs(c)), torch.full_like(c, 1e-30)),
    ).detach()
    a = a / s
    b = b / (s * s)
    c = c / (s * s * s)
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a * a * a) / 54.0
    return q, r, s, a, is_cubic


def _kinds_tensor(pair_kinds, like):
    """The per-object cubic-class mask on ``like``'s device: a bool tensor as
    given, or one made from a tuple (a copy from the host, which a CUDA graph
    cannot capture: a graphed caller passes the tensor)."""
    if isinstance(pair_kinds, torch.Tensor):
        return pair_kinds
    return torch.tensor([bool(k) for k in pair_kinds], dtype=torch.bool, device=like.device)


def pair_coverage(coefs, origin, dir, pair_kinds=None, quad_width: float = 0.01):
    """Normalized pair discriminant ``delta_n`` in [-1, 1] per (ray, object),
    [..., N]: < 0 iff a root pair exists ahead, crossing 0 smoothly at pair
    creation and annihilation.

    Cubic rays use the depressed cubic's discriminant; quadric rays the
    quadratic discriminant ``t1^2 - 4 t2 t0`` with a transition width of
    ``quad_width`` of the coefficient scale; linear rays +1 (no pair).
    ``pair_kinds`` (per object, True = cubic class, derived from the
    problem's template: a tuple, or the same as a bool tensor on the
    coefficients' device) pins which discriminant each object uses while its
    coefficients drift during descent; None classifies per ray by
    ``|t3| > EPS``."""
    t3, t2, t1, t0 = ray_poly_coeffs(coefs, origin, dir)
    q, r, _s, _a, is_cubic = _normalized_qr(t3, t2, t1, t0)
    r2 = r * r
    q3 = q * q * q
    delta_n = (r2 + q3) / (r2 + torch.abs(q3) + 1e-30)
    # Self-referential normalization: |disc| dominates away from the event
    # (delta -> -sign(disc)), the small coefficient-scale share sets the
    # transition width.
    qdisc = t1 * t1 - 4.0 * t2 * t0
    qscale = t1 * t1 + torch.abs(4.0 * t2 * t0)
    delta_q = -qdisc / (torch.abs(qdisc) + quad_width * qscale + 1e-30)
    ones = torch.ones_like(delta_n)
    is_quad = torch.abs(t2) > EPS
    quad_col = torch.where(is_quad, delta_q, ones)
    if pair_kinds is None:
        return torch.where(is_cubic, delta_n, quad_col)
    cubic_col = torch.where(is_cubic, delta_n, ones)
    return torch.where(_kinds_tensor(pair_kinds, coefs), cubic_col, quad_col)


@torch.no_grad()
def _raw_roots_excluding_pair(coefs, origin, dir, polish_iters: int, pair_kinds=None,
                              t_normal=None):
    """The root table of ``_roots_excluding_pair``, without autograd:
    ``_excluding_pair_plain`` on CPU tensors, one launch of
    ``solve_kernel.roots_excluding_pair`` on CUDA tensors (or a ValueError).
    ``t_normal`` is ``intersect_all``'s table for the same rays, if the
    caller has it."""
    if all(t.device.type == "cpu" for t in (coefs, origin, dir)):
        return _excluding_pair_plain(coefs, origin, dir, polish_iters, pair_kinds, t_normal)
    if t_normal is None:
        t_normal = intersect_all(coefs, origin, dir, polish_iters)
    kinds = None if pair_kinds is None else _kinds_tensor(pair_kinds, coefs)
    return roots_excluding_pair(coefs, origin, dir, polish_iters, kinds, t_normal)


@torch.no_grad()
def _excluding_pair_plain(coefs, origin, dir, polish_iters: int, pair_kinds=None,
                          t_normal=None):
    """``_raw_roots_excluding_pair`` in plain PyTorch, one tensor operation
    at a time."""
    t3, t2, t1, t0 = ray_poly_coeffs(coefs, origin, dir)
    q, r, s, a, is_cubic = _normalized_qr(t3, t2, t1, t0)
    polish = make_newton_polisher(coefs, origin, dir, max(1, polish_iters))

    delta = q * q * q + r * r
    sqrt_delta = torch.sqrt(torch.clamp(delta, min=0.0))
    cardano = s * (cbrt(r + sqrt_delta) + cbrt(r - sqrt_delta) - a / 3.0)
    q_neg = torch.clamp(-q, min=0.0)
    denom = torch.sqrt(q_neg * q_neg * q_neg)
    ratio = torch.clamp(r / torch.where(denom == 0, torch.ones_like(denom), denom), -1.0, 1.0)
    theta = torch.acos(ratio) / 3.0
    two_sqrt_q = 2.0 * torch.sqrt(q_neg)
    a_third = a / 3.0
    trig = [s * (two_sqrt_q * torch.cos(theta + k * TWO_THIRD_PI) - a_third)
            for k in (0.0, 1.0, 2.0)]
    # Which two trig candidates merge at delta -> 0^-: theta -> 0 (r > 0)
    # merges k=1,2 (survivor k=0); theta -> pi/3 (r < 0) merges k=0,2
    # (survivor k=1).
    r_pos = r >= 0
    survivor = torch.where(r_pos, trig[0], trig[1])
    pair_a = torch.where(r_pos, trig[1], trig[0])
    pair_b = trig[2]
    # Dominant-balance quadratic candidates (kept for near-degenerate |t3|),
    # masked out where they polish onto a pair root.
    sq2 = torch.where(torch.abs(t2) > EPS, t2, torch.ones_like(t2))
    qdisc = t1 * t1 - 4.0 * t2 * t0
    qsq = torch.sqrt(torch.clamp(qdisc, min=0.0))
    # the four seeds polished in one call (elementwise, so each value is the
    # one a call of its own gives)
    cardano, survivor, *sub = polish(torch.stack(
        [cardano, survivor, (-t1 - qsq) / (2.0 * sq2), (-t1 + qsq) / (2.0 * sq2)]))
    pair_tol = 1e-3 * s + 1e-6
    big = torch.full_like(t3, 2.0 * _FAKE_ROOT)

    cubic_root = big
    candidates = [cardano, survivor] + [
        torch.where((torch.abs(c_ - pair_a) < pair_tol) | (torch.abs(c_ - pair_b) < pair_tol),
                    big, c_)
        for c_ in sub
    ]
    for cand in candidates:
        take = (cand >= EPS) & (cand < cubic_root)
        cubic_root = torch.where(take, cand, cubic_root)
    miss = torch.full_like(t3, -1.0)
    cubic_root = torch.where(cubic_root >= big, miss, cubic_root)

    # quadric rays: the pair-annihilated world has no root from this object
    # (both intersections are the pair); linear rays keep the normal
    # selection (no pair)
    if t_normal is None:
        t_normal = intersect_all(coefs, origin, dir, polish_iters)
    t_normal = t_normal.detach()
    is_quad = torch.abs(t2) > EPS
    if pair_kinds is None:
        return torch.where(is_cubic, cubic_root, torch.where(is_quad, miss, t_normal))
    cubic_sel = torch.where(is_cubic, cubic_root, t_normal)
    quad_sel = torch.where(is_quad, miss, t_normal)
    return torch.where(_kinds_tensor(pair_kinds, coefs), cubic_sel, quad_sel)


def _roots_excluding_pair(coefs, origin, dir, polish_iters: int, pair_kinds=None,
                          t_normal=None):
    """Per-(ray, object) root [..., N] as if the merging pair had already
    annihilated: cubic-class objects get the polished selection with the two
    pair candidates removed; quadric-class objects contribute no root. For
    delta > 0 (and for linear rays) this equals the normal selection.
    Differentiable by the implicit function theorem at the selected root."""
    raw = _raw_roots_excluding_pair(coefs, origin, dir, polish_iters, pair_kinds, t_normal)
    return _IftRoot.apply(coefs, origin, dir, raw)


def _shade_at(scene: Scene, origin, dir, t_all, polish_iters: int):
    """Hard nearest hit and shading for a root table -> (image, hit, idx)."""
    res = shade_roots(scene, origin, dir, t_all, polish_iters)
    bg = scene.bg_color.to(torch.float32)
    return torch.where(res.hit[..., None], res.lit_color, bg), res.hit, res.idx


def render_rays_soft(scene: Scene, origin, dir, *, polish_iters: int = 3, tau=0.05,
                     pair_kinds=None, quad_width: float = 0.01):
    """Soft-visibility render -> [..., 3] f32 (bounce-free).

    The alpha blend of the normal render (branch A) and the pair-annihilated
    render (branch B), with ``alpha = sigmoid(-delta_n / tau)`` of the
    pixel's governing object: the selected hit where A hits, else the object
    closest to producing a pair. Converges to the hard render as tau -> 0.
    ``tau`` is a float or a 0-d tensor on the scene's device (the
    counterpart of JAX's traced temperature: a CUDA graph reads it from a
    buffer, so one capture serves any value); either divides as a tensor of
    the geometry's dtype, so both give the same bits. ``pair_kinds`` the
    static per-object cubic-class mask, a tuple or a bool tensor (pass it
    whenever coefficients are optimized); ``quad_width`` the quadric
    silhouette transition width."""
    if scene.n_objects == 0:
        # no objects, no roots, no pair events: the background, as the hard
        # pipeline's short-circuit, differentiable in bg_color
        return scene.bg_color.to(torch.float32).expand(origin.shape[:-1] + (3,))
    t_a = intersect_all(scene.coefs, origin, dir, polish_iters)
    t_b = _roots_excluding_pair(scene.coefs, origin, dir, polish_iters, pair_kinds=pair_kinds,
                                t_normal=t_a)
    # both branches shaded in one call, stacked on a leading axis
    img, hit, idx = _shade_at(scene, origin.expand((2,) + origin.shape),
                              dir.expand((2,) + dir.shape), torch.stack([t_a, t_b]),
                              polish_iters)
    img_a, img_b, hit_a, idx_a = img[0], img[1], hit[0], idx[0]

    delta_n = pair_coverage(scene.coefs, origin, dir, pair_kinds=pair_kinds,
                            quad_width=quad_width)                   # [..., N]
    # the selection index is discrete: no gradient
    idx_gov = torch.where(hit_a, idx_a, torch.argmin(delta_n, dim=-1)).detach()
    d_sel = torch.gather(delta_n, -1, idx_gov[..., None])[..., 0]
    tau = torch.as_tensor(tau, dtype=d_sel.dtype, device=d_sel.device)
    alpha = torch.sigmoid(-d_sel / tau)[..., None]
    return alpha * img_a + (1.0 - alpha) * img_b
