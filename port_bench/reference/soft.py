"""The soft-visibility render, written out on its own from its definition.

The plain reference of the ``fit_soft`` mix. It shares no code with the
port's pipeline or soft visibility, nor with this package's frozen copy of
them: the rays, the polynomial along a ray, the roots, the shading and the
blend are computed here from what the render is defined to be, by other
means.

Definition (the JAX package's ``diff/soft.py``, upstream semantics of the
hard render: CUDA-ray-tracer ``include/surface_impl.h``, ``src/update-cpu.cpp``):

* a ray hits an object at the smallest real root of ``F(o + t d)`` in
  ``[EPS, MAX_T)``, where the polynomial's degree is read from its
  coefficients against ``EPS``; the nearest object wins, the first on a tie;
* a hit is lit by each light that no object occludes (a root in
  ``(EPS, max_t)`` of the shadow ray from ``point + SHADOW_BIAS n``), by
  ``albedo / pi * colour * max(0, n . l)`` with an inverse-square falloff for
  a spherical light, summed and clamped at 1; a miss is the background;
* branch B renders the same with the merging root pair removed: for a
  cubic-class object whose cubic has three real roots, the two roots on
  either side of the critical point whose value is nearer zero go, and the
  third is its root; with one real root, that root; a quadric-class object
  with a quadratic has no root; otherwise the normal root;
* ``delta_n`` of a (ray, object) measures how near the pair event is: for a
  cubic with two critical values ``v1``, ``v2``, ``2 v1 v2 / (v1^2 + v2^2)``
  (-1 for three well-separated roots, 0 at the event, +1 with no pair), +1
  with no critical point; for a quadric-class object the normalized
  quadratic discriminant ``-disc / (|disc| + w (t1^2 + |4 t2 t0|))``;
* the pixel is ``alpha A + (1 - alpha) B``, ``alpha = sigmoid(-delta_n /
  tau)`` of the object that A hits, or where A misses of the object with the
  least ``delta_n``.

Roots are isolated between the critical points and bisected, without
autograd; their gradient is the implicit function theorem's, attached by
``t* - (G - G*) / G'(t*)`` with ``G`` the polynomial evaluated at the point,
and none at a grazing hit (``|G'| <= 1e-6``). Shadows carry no gradient.
Everything computes in the scene's dtype.
"""

from __future__ import annotations

import math

import torch

from .models.scene import Scene
from .models.surface import MONOMIAL_POWERS
from .ops.constants import EPS, MAX_T, SHADOW_BIAS

GRAZING = 1e-6
BISECTIONS = 110
QUAD_WIDTH = 0.01


def rays(scene: Scene, position, yaw_deg: float, pitch_deg: float, y0: int, rows: int):
    """Origins and unit directions [rows * W, 3] of image rows [y0, y0 + rows)
    (row 0 the bottom), for the fly camera at ``position`` looking along
    (cos yaw cos pitch, sin pitch, sin yaw cos pitch)."""
    dtype, device = scene.coefs.dtype, scene.coefs.device
    yaw, pitch = math.radians(yaw_deg), math.radians(pitch_deg)
    look = torch.tensor([math.cos(yaw) * math.cos(pitch), math.sin(pitch),
                         math.sin(yaw) * math.cos(pitch)], dtype=torch.float64)
    look = look / look.norm()
    # right = normalize((-look) x up), up' = right x (-look)
    back = -look
    right = torch.stack([-back[2], torch.zeros((), dtype=torch.float64), back[0]])
    right = right / right.norm()
    up = torch.stack([right[1] * back[2] - right[2] * back[1],
                      right[2] * back[0] - right[0] * back[2],
                      right[0] * back[1] - right[1] * back[0]])
    tan = float(scene.tan_half_fov)
    w, h = scene.width, scene.height
    xs = ((torch.arange(w, dtype=torch.float64) + 0.5) / w * 2 - 1) * (w / h) * tan
    ys = ((torch.arange(y0, y0 + rows, dtype=torch.float64) + 0.5) / h * 2 - 1) * tan
    d = xs[None, :, None] * right + ys[:, None, None] * up + look
    d = (d / d.norm(dim=-1, keepdim=True)).reshape(-1, 3).to(dtype=dtype, device=device)
    origin = torch.as_tensor(position, dtype=dtype, device=device).expand(d.shape)
    return origin, d


def _axis_powers(o, d):
    """(o + t d)^e as coefficients in t, for e = 0..3: [e][k] -> [...]."""
    one = torch.ones_like(o)
    return [[one], [o, d], [o * o, 2 * o * d, d * d],
            [o * o * o, 3 * o * o * d, 3 * o * d * d, d * d * d]]


def _times(p, q):
    out = [None] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] = a * b if out[i + j] is None else out[i + j] + a * b
    return out


def along(coefs, origin, dir):
    """[R, N, 4]: the coefficients of t^0..t^3 of F_n(origin + t dir)."""
    px, py, pz = (_axis_powers(origin[:, i], dir[:, i]) for i in range(3))
    basis = torch.zeros(origin.shape[0], len(MONOMIAL_POWERS), 4, dtype=origin.dtype,
                        device=origin.device)
    for m, (ex, ey, ez) in enumerate(MONOMIAL_POWERS):
        for k, c in enumerate(_times(_times(px[ex], py[ey]), pz[ez])):
            basis[:, m, k] = c
    return torch.einsum("rmk,nm->rnk", basis, coefs)


def horner(a, t):
    return ((a[..., 3] * t + a[..., 2]) * t + a[..., 1]) * t + a[..., 0]


def _critical(a):
    """The cubic's critical points (c1 <= c2) and whether there are two."""
    A, B, C = 3 * a[..., 3], 2 * a[..., 2], a[..., 1]
    disc = B * B - 4 * A * C
    two = disc > 0
    root = torch.sqrt(torch.where(two, disc, torch.ones_like(disc)))
    sign = torch.where(B >= 0, torch.ones_like(B), -torch.ones_like(B))
    qq = -0.5 * (B + sign * root)
    safe_a = torch.where(A == 0, torch.ones_like(A), A)
    safe_q = torch.where(qq == 0, torch.ones_like(qq), qq)
    x, y = qq / safe_a, C / safe_q
    return torch.minimum(x, y), torch.maximum(x, y), two


@torch.no_grad()
def real_roots(a):
    """[..., 3] real roots of the polynomial with coefficients ``a`` [..., 4]
    (degree read against EPS), ascending, +inf where there is none."""
    inf = torch.full(a.shape[:-1], math.inf, dtype=a.dtype, device=a.device)
    cubic = a[..., 3].abs() > EPS
    quad = ~cubic & (a[..., 2].abs() > EPS)
    lin = ~cubic & ~quad & (a[..., 1].abs() > EPS)
    # a cubic: one bracket between each pair of its critical points and the
    # Cauchy bound, bisected
    a3 = torch.where(cubic, a[..., 3], torch.ones_like(inf))
    bound = 1 + a[..., :3].abs().amax(-1) / a3.abs()
    c1, c2, two = _critical(torch.where(cubic[..., None], a, torch.ones_like(a)))
    lo = torch.stack([-bound, torch.where(two, c1, -bound), torch.where(two, c2, bound)], -1)
    hi = torch.stack([torch.where(two, c1, bound), torch.where(two, c2, bound), bound], -1)
    ac = a[..., None, :]
    f_lo = horner(ac, lo)
    has = (f_lo * horner(ac, hi) <= 0) & (hi > lo)
    for _ in range(BISECTIONS):
        mid = 0.5 * (lo + hi)
        f_mid = horner(ac, mid)
        left = (f_mid == 0) | ((f_mid > 0) != (f_lo > 0))
        hi = torch.where(left, mid, hi)
        lo, f_lo = torch.where(left, lo, mid), torch.where(left, f_lo, f_mid)
    cubic_roots = torch.where(has, 0.5 * (lo + hi), inf[..., None])
    # a quadratic
    a2 = torch.where(quad, a[..., 2], torch.ones_like(inf))
    disc = a[..., 1] ** 2 - 4 * a2 * a[..., 0]
    ok = quad & (disc >= 0)
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    q = -0.5 * (a[..., 1] + torch.where(a[..., 1] >= 0, sq, -sq))
    x = q / a2
    y = a[..., 0] / torch.where(q == 0, torch.ones_like(q), q)
    y = torch.where(q == 0, x, y)
    quad_roots = torch.stack([torch.minimum(x, y), torch.maximum(x, y), inf], -1)
    quad_roots = torch.where(ok[..., None], quad_roots, inf[..., None])
    # a line
    a1 = torch.where(lin, a[..., 1], torch.ones_like(inf))
    lin_roots = torch.stack([-a[..., 0] / a1, inf, inf], -1)
    out = torch.where(cubic[..., None], cubic_roots,
                      torch.where(quad[..., None], quad_roots,
                                  torch.where(lin[..., None], lin_roots, inf[..., None])))
    return out.sort(-1).values


def first_in(roots, lo, hi, closed: bool):
    """The smallest root in [lo, hi) (``closed``) or (lo, hi), else +inf."""
    ok = ((roots >= lo) if closed else (roots > lo)) & (roots < hi)
    return torch.where(ok, roots, torch.full_like(roots, math.inf)).amin(-1)


@torch.no_grad()
def branch_roots(a, pair_kinds):
    """[R, N] each of the normal hit (A) and the pair-removed hit (B), +inf
    for a miss."""
    roots = real_roots(a)
    t_a = first_in(roots, EPS, MAX_T, True)
    n_real = torch.isfinite(roots).sum(-1)
    c1, c2, _ = _critical(a)
    smaller_left = horner(a, c1).abs() <= horner(a, c2).abs()
    survivor = torch.where(smaller_left, roots[..., 2], roots[..., 0])
    cubic = a[..., 3].abs() > EPS
    one = torch.where(n_real == 3, survivor, roots[..., 0])
    one = torch.where((one >= EPS) & (one < MAX_T), one, torch.full_like(one, math.inf))
    quad = a[..., 2].abs() > EPS
    kinds = pair_kinds.to(a.device)[None, :]
    t_b = torch.where(kinds, torch.where(cubic, one, t_a),
                      torch.where(quad, torch.full_like(t_a, math.inf), t_a))
    return t_a, t_b


def pair_delta(a, pair_kinds):
    """[R, N] ``delta_n`` (see the module's docstring), differentiable in ``a``."""
    ones = torch.ones_like(a[..., 0])
    c1, c2, two = _critical(torch.where((a[..., 3].abs() > EPS)[..., None], a, ones[..., None]))
    v1, v2 = horner(a, c1), horner(a, c2)
    den = v1 * v1 + v2 * v2
    cubic_d = 2 * v1 * v2 / torch.where(den > 0, den, ones)
    cubic_col = torch.where((a[..., 3].abs() > EPS) & two & (den > 0), cubic_d, ones)
    t2, t1, t0 = a[..., 2], a[..., 1], a[..., 0]
    disc = t1 * t1 - 4 * t2 * t0
    quad_d = -disc / (disc.abs() + QUAD_WIDTH * (t1 * t1 + (4 * t2 * t0).abs()) + 1e-30)
    quad_col = torch.where(t2.abs() > EPS, quad_d, ones)
    return torch.where(pair_kinds.to(a.device)[None, :], cubic_col, quad_col)


def _power(x, e: int):
    out = torch.ones_like(x)
    for _ in range(e):
        out = out * x
    return out


def _value_and_gradient(c, p):
    """F and its gradient at points ``p`` [R, 3] for coefficient rows ``c``
    [R, 20], from the monomials' exponents."""
    pw = [[_power(p[:, axis], e) for e in range(4)] for axis in range(3)]
    f = torch.zeros_like(p[:, 0])
    g = [torch.zeros_like(f) for _ in range(3)]
    for m, e in enumerate(MONOMIAL_POWERS):
        f = f + c[:, m] * pw[0][e[0]] * pw[1][e[1]] * pw[2][e[2]]
        for axis in range(3):
            if e[axis]:
                d = list(e)
                d[axis] -= 1
                g[axis] = g[axis] + c[:, m] * e[axis] * pw[0][d[0]] * pw[1][d[1]] * pw[2][d[2]]
    return f, torch.stack(g, -1)


@torch.no_grad()
def _occluded(scene: Scene, origin, dirs, max_t):
    """[R, L] whether an object has a root in (EPS, max_t) on each shadow ray."""
    rows, lights = dirs.shape[:2]
    a = along(scene.coefs, origin[:, None, :].expand(dirs.shape).reshape(-1, 3),
              dirs.reshape(-1, 3))
    t = first_in(real_roots(a), EPS, math.inf, False).amin(-1).reshape(rows, lights)
    return t < max_t[None, :]


def shade(scene: Scene, origin, dir, t_star):
    """[R, 3] the colour of each ray whose nearest root table is ``t_star``
    [R, N] (+inf for a miss), differentiable in the scene's coefficients,
    colours and lights."""
    best, idx = t_star.min(-1)
    hit = torch.isfinite(best)
    t0 = torch.where(hit, best, torch.zeros_like(best))
    c = scene.coefs[idx]
    with torch.no_grad():
        _, g0 = _value_and_gradient(c, origin + t0[:, None] * dir)
        slope = (g0 * dir).sum(-1)
        attach = hit & (slope.abs() > GRAZING)
        slope = torch.where(attach, slope, torch.ones_like(slope))
    f, _ = _value_and_gradient(c, origin + t0[:, None] * dir)
    t = t0 - torch.where(attach, (f - f.detach()) / slope, torch.zeros_like(f))
    point = origin + t[:, None] * dir
    _, grad = _value_and_gradient(c, point)
    norm = grad.norm(dim=-1, keepdim=True)
    normal = grad / torch.where(norm > 0, norm, torch.ones_like(norm))
    spherical = scene.light_is_spherical[None, :, None]
    to_light = scene.light_p[None, :, :] - point[:, None, :]            # [R, L, 3]
    dist2 = (to_light * to_light).sum(-1, keepdim=True)
    dist = torch.sqrt(dist2)
    ldir = torch.where(spherical, to_light / torch.where(dist > 0, dist, torch.ones_like(dist)),
                       scene.light_p[None, :, :])
    colour = torch.where(spherical, scene.light_color[None] / (4 * math.pi * dist2),
                         scene.light_color[None])
    with torch.no_grad():
        # the upstream hands the shadow ray's direction over in single precision
        sdir = torch.where(spherical, to_light, scene.light_p[None].expand_as(to_light))
        sdir = sdir.float().to(point.dtype)
        max_t = torch.where(scene.light_is_spherical, 1.0, MAX_T).to(point.dtype)
        dark = _occluded(scene, (point + SHADOW_BIAS * normal).detach(), sdir, max_t)
    lambert = torch.clamp((normal[:, None, :] * ldir).sum(-1), min=0.0)
    per_light = scene.colors[idx][:, None, :] * colour * lambert[..., None] / math.pi
    lit = torch.where(dark[..., None], torch.zeros_like(per_light), per_light).sum(1)
    lit = torch.minimum(lit, torch.ones_like(lit))
    return torch.where(hit[:, None], lit, scene.bg_color.to(lit.dtype).expand_as(lit))


def render_soft(scene: Scene, origin, dir, tau: float, pair_kinds):
    """[R, 3] the soft-visibility colour of each ray (bounce-free)."""
    if scene.n_objects == 0:
        return scene.bg_color.expand(origin.shape[0], 3)
    with torch.no_grad():
        t_a, t_b = branch_roots(along(scene.coefs, origin, dir), pair_kinds)
    img_a = shade(scene, origin, dir, t_a)
    img_b = shade(scene, origin, dir, t_b)
    delta = pair_delta(along(scene.coefs, origin, dir), pair_kinds)
    best, idx_a = t_a.min(-1)
    gov = torch.where(torch.isfinite(best), idx_a, delta.detach().argmin(-1))
    alpha = torch.sigmoid(-delta.gather(-1, gov[:, None]) / tau)
    return alpha * img_a + (1 - alpha) * img_b
