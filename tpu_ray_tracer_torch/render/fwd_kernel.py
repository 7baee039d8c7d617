"""Forward render kernel K1: its launch wrapper and its plain PyTorch version.

``render_fwd`` renders image rows from the packed scene tables that
``render/kernel_backend.py`` builds. On CUDA tensors it launches the
hand-written kernel of ``csrc/render_fwd.cu``; on CPU tensors it runs
``render_fwd_plain``, the same per-pixel math written with PyTorch tensor
operations over all pixels at once (``torch.where`` masks in place of the
kernel's per-thread branches). Both replace the forward Pallas kernel of
``tpu_ray_tracer/render/pallas_backend.py`` (``_make_kernel``, with and
without ``save_aux``) and follow its arithmetic operation for operation, so
the two differ only in rounding: the plain version rounds every operation,
the kernel lets nvcc contract multiply-adds, and the math libraries differ
in the last bits of cos, pow and rsqrt.

Packed tables (all contiguous, on one device):

* ``coefs`` [N, 20] f32, objects in slot order: the ``n_cubic`` cubic
  objects first, then the quadrics;
* ``orig_index`` [N] int32: each slot's index in the scene, for tie-breaks;
* ``colors`` [N, 3] f32, ``refl`` [N] f32;
* ``lights`` [L, 7] f32: is_spherical, p (3), color (3);
* ``dir_table`` [L, N] f32: per (light, slot) the cubic form C(d) for cubic
  slots or the quadratic form Q(d) for quadric slots of the light's stored
  direction (read for directional lights only);
* ``posdef`` [N] int32: 1 where a quadric slot's quadratic form is positive
  definite, which selects the specialised occlusion classifier;
* ``cam`` [18] f32: rotation columns (9), eye (3), aspect*tan, tan, bg (3),
  row0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.surface import MONOMIAL_POWERS, N_COEFS
from ..ops.constants import EPS, MAX_T, SHADOW_BIAS, TWO_THIRD_PI
from ..ops.poly import _EXPANSION
from ..utils import launches
from . import _build

_FAKE_ROOT = 2e6
_RESIDUAL_TOL = 1e-5
QUAD_START = 10  # first degree-<=2 monomial (x2) in the reference order
MAX_AUX_LIGHTS = 31  # bits 0-30 of the i32 occlusion mask (Pallas :1479)

_INV_PI = float(np.float32(1.0 / math.pi))
_FOUR_PI = float(np.float32(4.0 * math.pi))
_PI = float(np.float32(math.pi))


# --- scalar helpers (same substitutes as the Pallas kernel, :97-110) ---

def _cbrt(x):
    """sign(x) * |x|^(1/3): the seed-level cube root of the Pallas kernel."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _acos(x):
    """Abramowitz & Stegun 4.4.45 polynomial acos, |err| < 7e-5 rad."""
    ax = torch.abs(x)
    p = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * (-0.0187293)))
    pos = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x < 0, _PI - pos, pos)


def _powers3(x, y, z):
    cache = [[None] * 4 for _ in range(3)]
    for axis, comp in enumerate((x, y, z)):
        cache[axis][1] = comp
        cache[axis][2] = comp * comp
        cache[axis][3] = cache[axis][2] * comp
    return cache


def _prod(cache, pows, one):
    out = None
    for axis, e in enumerate(pows):
        if e == 0:
            continue
        out = cache[axis][e] if out is None else out * cache[axis][e]
    return one if out is None else out


def _ray_coeffs(coef, o_pows, d_pows, one, m_start=0, k_max=3):
    """[t_kmax, ..., t0]: coefficients of F(o + t d) for one object."""
    out = []
    for k in range(k_max, -1, -1):
        acc = None
        for m in range(m_start, N_COEFS):
            term_sum = None
            for w, o_p, d_p in _EXPANSION[k][m]:
                t = _prod(o_pows, o_p, one) * _prod(d_pows, d_p, one)
                if w != 1.0:
                    t = t * w
                term_sum = t if term_sum is None else term_sum + t
            if term_sum is None:
                continue
            contrib = coef[m] * term_sum
            acc = contrib if acc is None else acc + contrib
        out.append(acc)
    return out


def _eye_coeffs(coef, eye_pows, one):
    """[q_0, ..., q_19]: F(e + t d) = sum_k t^k sum_{deg n = k} q_n d^(p_n)
    for the eye e (cached powers ``eye_pows``), q_n = sum over monomials
    m with p_m >= p_n of coef_m w(p_m, p_n) e^(p_m - p_n): stage 0's ray
    expansion with the eye hoisted out of the pixels (the kernel's
    ``eye_coeffs``; ``tests/test_torch_render.py`` holds it to the binomial
    expansion in f64)."""
    out = []
    for pn in MONOMIAL_POWERS:
        acc = None
        for m, pm in enumerate(MONOMIAL_POWERS):
            if any(j > p for j, p in zip(pn, pm)):
                continue
            term = _prod(eye_pows, tuple(p - j for p, j in zip(pm, pn)), one)
            w = math.prod(math.comb(p, j) for p, j in zip(pm, pn))
            if w != 1:
                term = term * float(w)
            contrib = coef[m] * term
            acc = contrib if acc is None else acc + contrib
        out.append(acc)
    return out


def _eye_ray_coeffs(q, d_pows, one, m_start=0, k_max=3):
    """[t_kmax, ..., t0] of a ray from the eye, from ``_eye_coeffs`` and the
    direction's cached powers."""
    out = []
    for k in range(k_max, -1, -1):
        acc = None
        for n in range(m_start, N_COEFS):
            if sum(MONOMIAL_POWERS[n]) != k:
                continue
            t = q[n] * _prod(d_pows, MONOMIAL_POWERS[n], one)
            acc = t if acc is None else acc + t
        out.append(acc)
    return out


def _eval_F_and_grad(coef, cache, m_start=0, need_mag=True, need_grad=True):
    """F, sum |terms| and dF at the cached point powers."""
    f = mag = None
    g = [None, None, None]
    for m, pows in enumerate(MONOMIAL_POWERS):
        if m < m_start:
            continue
        term = coef[m] * _prod(cache, pows, 1.0)
        f = term if f is None else f + term
        if need_mag:
            a = torch.abs(term)
            mag = a if mag is None else mag + a
        if not need_grad:
            continue
        for axis in range(3):
            e = pows[axis]
            if e == 0:
                continue
            dpows = list(pows)
            dpows[axis] = e - 1
            dterm = coef[m] * float(e) * _prod(cache, dpows, 1.0)
            g[axis] = dterm if g[axis] is None else g[axis] + dterm
    return f, mag, [0.0 if gi is None else gi for gi in g]


def _hessian_entries(coef, cache):
    """[Hxx, Hyy, Hzz, Hxy, Hxz, Hyz] of F at the cached point."""
    out = []
    for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)):
        acc = None
        for m, pows in enumerate(MONOMIAL_POWERS):
            p2 = list(pows)
            if a == b:
                ea = pows[a]
                if ea < 2:
                    continue
                fac = float(ea * (ea - 1))
                p2[a] = ea - 2
            else:
                ea, eb = pows[a], pows[b]
                if ea == 0 or eb == 0:
                    continue
                fac = float(ea * eb)
                p2[a] = ea - 1
                p2[b] = eb - 1
            term = coef[m] * (_prod(cache, p2, 1.0) * fac)
            acc = term if acc is None else acc + term
        out.append(0.0 if acc is None else acc)
    return out


def _newton_step(t, f, df):
    ok = torch.abs(df) > 1e-12
    step = torch.where(ok, f / torch.where(ok, df, 1.0), 0.0)
    t_new = t - step
    return torch.where(torch.isfinite(t_new), t_new, t)


def _polish(coef, o, d, t, iters, m_start=0, reject=True):
    """Newton on the direct 20-monomial F, then (reject=True) the residual
    test (Pallas ``_polish``, :239)."""
    ox, oy, oz = o
    dx, dy, dz = d
    seed = t
    for _ in range(iters):
        cache = _powers3(ox + t * dx, oy + t * dy, oz + t * dz)
        f, _, g = _eval_F_and_grad(coef, cache, m_start, need_mag=False)
        t = _newton_step(t, f, g[0] * dx + g[1] * dy + g[2] * dz)
    if not reject:
        return t
    cache = _powers3(ox + t * dx, oy + t * dy, oz + t * dz)
    f, mag, _ = _eval_F_and_grad(coef, cache, m_start, need_grad=False)
    genuine = torch.abs(f) <= _RESIDUAL_TOL * mag
    return torch.where(genuine, t, torch.where(seed < 0, seed, _FAKE_ROOT))


def _feval1d(t3, t2, t1, t0, t):
    return ((t3 * t + t2) * t + t1) * t + t0


def _dfeval1d(t3, t2, t1, t):
    return (3.0 * t3 * t + 2.0 * t2) * t + t1


def _genuine1d(t3, t2, t1, t0, t):
    """Residual test on the assembled cubic: |f(t)| <= tol * sum of |terms|."""
    at = torch.abs(t)
    mag = (torch.abs(t3) * at * at * at + torch.abs(t2) * at * at
           + torch.abs(t1) * at + torch.abs(t0) + 1e-30)
    return torch.abs(_feval1d(t3, t2, t1, t0, t)) <= _RESIDUAL_TOL * mag


def _cubic_seeds(t3, t2, t1, t0):
    """The three scale-normalised Cardano/trig seeds (Delta > 0 puts the
    Cardano root in the first slot), as ``_solve_object`` and
    ``cubic_occ_one`` build them."""
    s3 = torch.where(torch.abs(t3) > EPS, t3, 1.0)
    a = t2 / s3
    b = t1 / s3
    c = t0 / s3
    s = torch.maximum(
        torch.maximum(torch.abs(a), torch.sqrt(torch.abs(b))),
        torch.clamp(_cbrt(torch.abs(c)), min=1e-30),
    )
    a = a / s
    b = b / (s * s)
    c = c / (s * s * s)
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a * a * a) / 54.0
    delta = q * q * q + r * r
    sq_delta = torch.sqrt(torch.clamp(delta, min=0.0))
    q_neg = torch.clamp(-q, min=0.0)
    denom = torch.sqrt(q_neg * q_neg * q_neg)
    ratio = torch.clamp(r / torch.where(denom == 0, 1.0, denom), -1.0, 1.0)
    theta = _acos(ratio) / 3.0
    two_sq = 2.0 * torch.sqrt(q_neg)
    a3 = a / 3.0
    cardano = _cbrt(r + sq_delta) + _cbrt(r - sq_delta)
    return [
        s * (torch.where(delta > 0, cardano, two_sq * torch.cos(theta)) - a3),
        s * (two_sq * torch.cos(theta + float(np.float32(TWO_THIRD_PI))) - a3),
        s * (two_sq * torch.cos(theta + float(np.float32(2.0 * TWO_THIRD_PI))) - a3),
    ]


def _stable_quad_roots(t2, t1, t0):
    """Cancellation-stable quadratic roots in the reference's (lo, hi) order."""
    disc = t1 * t1 - 4.0 * t2 * t0
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    sgn = torch.where(t1 >= 0, 1.0, -1.0)
    qq = -0.5 * (t1 + sgn * s)
    r_q = qq / torch.where(torch.abs(t2) > EPS, t2, 1.0)
    qq_ok = torch.abs(qq) > 0
    r_c = torch.where(qq_ok, t0 / torch.where(qq_ok, qq, 1.0), -1.0)
    lo = torch.where(t1 >= 0, r_q, r_c)
    hi = torch.where(t1 >= 0, r_c, r_q)
    return disc, lo, hi


def _solve_object(coef, o, d, polish_iters, screen_iters, eyeq=None):
    """Nearest reference-semantics root for one cubic slot (Pallas
    ``_solve_object``, :263-405); ``eyeq``: the slot's ``_eye_coeffs`` when
    the rays leave the eye (stage 0)."""
    one = torch.ones_like(d[0])
    if eyeq is None:
        t3, t2, t1, t0 = _ray_coeffs(coef, _powers3(*o), _powers3(*d), one)
    else:
        t3, t2, t1, t0 = _eye_ray_coeffs(eyeq, _powers3(*d), one)

    def screen(t):
        seed = t
        for _ in range(screen_iters):
            t = _newton_step(t, _feval1d(t3, t2, t1, t0, t), _dfeval1d(t3, t2, t1, t))
        return torch.where(_genuine1d(t3, t2, t1, t0, t), t,
                           torch.where(seed < 0, seed, _FAKE_ROOT))

    is_cubic = torch.abs(t3) > EPS
    is_quad = torch.abs(t2) > EPS
    is_lin = torch.abs(t1) > EPS

    trig = [screen(seed) for seed in _cubic_seeds(t3, t2, t1, t0)]
    sq2 = torch.where(is_quad, t2, 1.0)
    qdisc = t1 * t1 - 4.0 * t2 * t0
    qsq = torch.sqrt(torch.clamp(qdisc, min=0.0))
    sub_lo = screen((-t1 - qsq) / (2.0 * sq2))
    sub_hi = screen((-t1 + qsq) / (2.0 * sq2))

    big = 2.0 * _FAKE_ROOT
    cubic_root = torch.full_like(one, big)
    for cand in (*trig, sub_lo, sub_hi):
        take = (cand >= EPS) & (cand < cubic_root)
        cubic_root = torch.where(take, cand, cubic_root)
    refined = _polish(coef, o, d, cubic_root, polish_iters, reject=True)
    cubic_root = torch.where(cubic_root < _FAKE_ROOT, refined, cubic_root)
    cubic_root = torch.where(cubic_root >= big, -1.0, cubic_root)

    quad_root = torch.where(qdisc < 0, -1.0, torch.where(sub_lo >= EPS, sub_lo, sub_hi))
    q_ref = _polish(coef, o, d, quad_root, polish_iters, reject=False)
    quad_root = torch.where((qdisc >= 0) & (quad_root < _FAKE_ROOT), q_ref, quad_root)
    lin_root = -t0 / torch.where(is_lin, t1, 1.0)
    return torch.where(is_cubic, cubic_root,
                       torch.where(is_quad, quad_root,
                                   torch.where(is_lin, lin_root, -1.0)))


def _solve_quadric(coef, o, d, polish_iters, eyeq=None):
    """Root for a slot whose cubic coefficients are all zero (Pallas
    ``_solve_quadric``, :408-453): stable closed form, then at most 2
    polish steps on the selected root; ``eyeq`` as in ``_solve_object``."""
    one = torch.ones_like(d[0])
    if eyeq is None:
        t2, t1, t0 = _ray_coeffs(coef, _powers3(*o), _powers3(*d), one,
                                 m_start=QUAD_START, k_max=2)
    else:
        t2, t1, t0 = _eye_ray_coeffs(eyeq, _powers3(*d), one, m_start=QUAD_START, k_max=2)
    is_quad = torch.abs(t2) > EPS
    is_lin = torch.abs(t1) > EPS
    disc, lo, hi = _stable_quad_roots(t2, t1, t0)
    sel = _polish(coef, o, d, torch.where(lo >= EPS, lo, hi),
                  min(polish_iters, 2), m_start=QUAD_START, reject=False)
    quad_root = torch.where(disc < 0, -1.0, sel)
    lin_root = -t0 / torch.where(is_lin, t1, 1.0)
    return torch.where(is_quad, quad_root, torch.where(is_lin, lin_root, -1.0))


def _quadlin_occ(t2, t1, t0, max_t, posdef=False, unbounded=False):
    """Occlusion by a degree <= 2 t-polynomial, from signs alone (Pallas
    ``quadlin_occ_coeffs``, :665-752), with its ``posdef``/``unbounded``
    specialisations selected exactly where the Pallas kernel selects them."""
    E = EPS
    fE = (t2 * E + t1) * E + t0
    gE = 2.0 * t2 * E + t1
    disc_ok = t1 * t1 - 4.0 * t2 * t0 >= 0
    if posdef and unbounded:
        return disc_ok & ((fE < 0) | (gE < 0))
    fM = (t2 * max_t + t1) * max_t + t0
    gM = 2.0 * t2 * max_t + t1
    a_pos = (fE > 0) & (gE < 0) & ((fM < 0) | (gM > 0))
    b_pos = (fE < 0) & (fM > 0) & (gM > 0)
    occ_pos = disc_ok & (a_pos | b_pos)
    if posdef:
        return occ_pos
    occ_neg = disc_ok & ((fE > 0) | (gE > 0)) & (fM < 0) & (gM < 0)
    quad_hit = torch.where(t2 > 0, occ_pos, occ_neg)
    a = -t0
    lin_pos = (a > E * t1) & (a < max_t * t1)
    lin_neg = (a < E * t1) & (a > max_t * t1)
    lin_hit = (torch.abs(t1) > EPS) & torch.where(t1 > 0, lin_pos, lin_neg)
    return torch.where(torch.abs(t2) > EPS, quad_hit, lin_hit)


def _cubic_occ(f0, g0, h6, sd, t3, max_t, shadow_iters):
    """Occlusion by a cubic slot: Taylor assembly around the shadow origin,
    the five analytic candidates, ``shadow_iters`` steps of 1-D Newton and a
    residual test (Pallas ``cubic_occ_one``, :771-853)."""
    sdx, sdy, sdz = sd
    t2 = (0.5 * (h6[0] * (sdx * sdx) + h6[1] * (sdy * sdy) + h6[2] * (sdz * sdz))
          + h6[3] * (sdx * sdy) + h6[4] * (sdx * sdz) + h6[5] * (sdy * sdz))
    t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz
    t0 = f0
    _disc, qlo, qhi = _stable_quad_roots(t2, t1, t0)
    occ = None
    for cand in (*_cubic_seeds(t3, t2, t1, t0), qlo, qhi):
        t = cand
        for _ in range(shadow_iters):
            t = _newton_step(t, _feval1d(t3, t2, t1, t0, t), _dfeval1d(t3, t2, t1, t))
        hit = _genuine1d(t3, t2, t1, t0, t) & (t > EPS) & (t < max_t)
        occ = hit if occ is None else occ | hit
    return torch.where(torch.abs(t3) > EPS, occ, _quadlin_occ(t2, t1, t0, max_t))


class _Tables(NamedTuple):
    """The packed tables split into per-object and per-light rows of 0-d
    tensors (the scalars the Pallas kernel reads from SMEM), with the
    per-slot and per-light flags on the host."""
    coefs: list        # [N][20] 0-d tensors
    coefs_pad: torch.Tensor   # [N + 1, 20], last row zero (the miss slot -1)
    colors_pad: torch.Tensor  # [N + 1, 3]
    refl_pad: torch.Tensor    # [N + 1]
    orig_index: tuple  # [N] 0-d int64 tensors
    n_cubic: int
    lights: list       # [L][7] 0-d tensors
    kinds: list        # [L] bool, True = spherical
    dtab: list         # [L][N] 0-d tensors
    posdef: list       # [N] bool
    polish_iters: int
    shadow_iters: int
    screen_iters: int


def _shade(tab: _Tables, col, p, n, want_bits=False):
    """Shadow-tested Lambertian sum over lights, clamped to 1 (Pallas
    ``shade``, :596-941, reference update-cpu.cpp:60-77), and with
    ``want_bits`` the int32 occlusion bitmask (bit li set where light li is
    occluded; None otherwise)."""
    coefs, n_cubic, lights, dtab, posdef = (tab.coefs, tab.n_cubic, tab.lights,
                                            tab.dtab, tab.posdef)
    px, py, pz = p
    nx, ny, nz = n
    so_cache = _powers3(px + SHADOW_BIAS * nx, py + SHADOW_BIAS * ny,
                        pz + SHADOW_BIAS * nz)
    pre = []
    for i, coef in enumerate(coefs):
        cubic = i < n_cubic
        f0, _, g0 = _eval_F_and_grad(coef, so_cache, 0 if cubic else QUAD_START,
                                     need_mag=False)
        pre.append((coef, f0, g0, _hessian_entries(coef, so_cache) if cubic else None))

    acc = [torch.zeros_like(px)] * 3
    bits = torch.zeros_like(px, dtype=torch.int32) if want_bits else None
    for li, spherical in enumerate(tab.kinds):
        lk = lights[li]
        lpx, lpy, lpz = lk[1], lk[2], lk[3]
        if spherical:
            tox, toy, toz = lpx - px, lpy - py, lpz - pz
            sd = (tox, toy, toz)
            max_t = 1.0
            dist2 = tox * tox + toy * toy + toz * toz
            inv_dn = torch.rsqrt(torch.where(dist2 > 0, dist2, 1.0))
            ld = (tox * inv_dn, toy * inv_dn, toz * inv_dn)
            cscale = 1.0 / (_FOUR_PI * dist2)
        else:
            sd = ld = (lpx, lpy, lpz)
            max_t = MAX_T
            cscale = 1.0
        lam = torch.clamp(nx * ld[0] + ny * ld[1] + nz * ld[2], min=0.0)

        if spherical:
            sd_pows = _powers3(*sd)
            sd_cub = [_prod(sd_pows, MONOMIAL_POWERS[m], 1.0) for m in range(QUAD_START)]
        occluded = torch.zeros_like(px, dtype=torch.bool)
        for i, (coef, f0, g0, h6) in enumerate(pre):
            if i < n_cubic:
                if spherical:
                    t3 = None
                    for m in range(QUAD_START):
                        term = coef[m] * sd_cub[m]
                        t3 = term if t3 is None else t3 + term
                else:
                    t3 = dtab[li][i]
                occ = _cubic_occ(f0, g0, h6, sd, t3, max_t, tab.shadow_iters)
            else:
                sdx, sdy, sdz = sd
                if spherical:
                    t2 = (coef[10] * (sdx * sdx) + coef[11] * (sdy * sdy)
                          + coef[12] * (sdz * sdz) + coef[13] * (sdx * sdy)
                          + coef[14] * (sdx * sdz) + coef[15] * (sdy * sdz))
                else:
                    t2 = dtab[li][i]
                t1 = g0[0] * sdx + g0[1] * sdy + g0[2] * sdz
                occ = _quadlin_occ(t2, t1, f0, max_t, posdef=posdef[i],
                                   unbounded=not spherical)
            occluded = occluded | occ
        if want_bits:
            bits = bits | (occluded.to(torch.int32) << li)
        scale = cscale * torch.where(occluded, 0.0, lam * _INV_PI)
        acc = [acc[k] + col[k] * lk[4 + k] * scale for k in range(3)]
    return [torch.clamp(a, max=1.0) for a in acc], bits


def _trace_and_shade(tab: _Tables, o, d, want_bits=False, eyeq=None):
    """Nearest hit over all slots, then gather, normal and shading ->
    (hit, slot, t, refl, point, normal, lit, occlusion bits); slot is -1
    and t is 0 on a miss. ``eyeq``: per slot its ``_eye_coeffs`` when ``o``
    is the eye (stage 0)."""
    dx = d[0]
    best_t = torch.full_like(dx, MAX_T)
    best_idx = torch.full_like(dx, -1, dtype=torch.int64)
    best_orig = torch.full_like(dx, 2**30, dtype=torch.int64)
    for i, coef in enumerate(tab.coefs):
        q = None if eyeq is None else eyeq[i]
        if i < tab.n_cubic:
            t = _solve_object(coef, o, d, tab.polish_iters, tab.screen_iters, q)
        else:
            t = _solve_quadric(coef, o, d, tab.polish_iters, q)
        orig = tab.orig_index[i]
        better = ((t >= EPS) & (t < MAX_T)
                  & ((t < best_t) | ((t == best_t) & (orig < best_orig))))
        best_t = torch.where(better, t, best_t)
        best_idx = torch.where(better, i, best_idx)
        best_orig = torch.where(better, orig, best_orig)
    hit = best_idx >= 0
    t = torch.where(hit, best_t, 0.0)
    p = tuple(o[k] + t * d[k] for k in range(3))

    # gather by slot; slot -1 (a miss) reads the appended zero row
    sel = tab.coefs_pad[best_idx].unbind(1)
    col = tab.colors_pad[best_idx].unbind(1)
    refl = tab.refl_pad[best_idx]
    _, _, g = _eval_F_and_grad(sel, _powers3(*p), need_mag=False)
    norm = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
    inv = 1.0 / torch.where(norm > 0, norm, 1.0)
    n = (g[0] * inv, g[1] * inv, g[2] * inv)
    lit, bits = _shade(tab, col, p, n, want_bits)
    return hit, best_idx, t, refl, p, n, lit, bits


def render_fwd_plain(coefs, orig_index, colors, refl, lights, dir_table, posdef,
                     cam, *, width: int, height: int, rows: int, n_cubic: int,
                     polish_iters: int, shadow_iters: int, screen_iters: int,
                     bounces: int, save_aux: bool = False):
    """Plain PyTorch version of the kernel: [rows, width, 3] f32 for image
    rows [row0, row0 + rows), row0 = cam[17]; with ``save_aux`` also the
    per-stage (aux_t, aux_slot, aux_occ), each [bounces + 1, rows, width]
    (see ``render_fwd``). As in the kernel, stage 0 forms each slot's
    t-polynomial from the eye-hoisted coefficients (``_eye_coeffs``), the
    bounce stages from the binomial expansion."""
    dev = coefs.device
    tab = _Tables(
        coefs=[list(row.unbind(0)) for row in coefs.unbind(0)],
        coefs_pad=torch.cat([coefs, coefs.new_zeros(1, N_COEFS)]),
        colors_pad=torch.cat([colors, colors.new_zeros(1, 3)]),
        refl_pad=torch.cat([refl, refl.new_zeros(1)]),
        orig_index=orig_index.to(torch.int64).unbind(0),
        n_cubic=n_cubic,
        lights=[list(row.unbind(0)) for row in lights.unbind(0)],
        kinds=[k > 0.5 for k in lights[:, 0].tolist()],
        dtab=[list(row.unbind(0)) for row in dir_table.unbind(0)],
        posdef=[bool(v) for v in posdef.tolist()],
        polish_iters=polish_iters,
        shadow_iters=shadow_iters,
        screen_iters=screen_iters,
    )

    # --- ray generation (Pallas kernel :984-1016) ---
    pixel = torch.arange(rows * width, device=dev, dtype=torch.int32)
    pix_y_local = pixel // width
    pix_x = pixel - pix_y_local * width
    pix_y = pix_y_local + cam[17].to(torch.int32)
    ndc_x = (pix_x.to(torch.float32) + 0.5) * float(np.float32(1.0 / width))
    ndc_y = (pix_y.to(torch.float32) + 0.5) * float(np.float32(1.0 / height))
    cx = (2.0 * ndc_x - 1.0) * cam[12]
    cy = (2.0 * ndc_y - 1.0) * cam[13]
    tx = cx * cam[0] + cy * cam[3] + cam[6]
    ty = cx * cam[1] + cy * cam[4] + cam[7]
    tz = cx * cam[2] + cy * cam[5] + cam[8]
    inv_len = torch.rsqrt(tx * tx + ty * ty + tz * tz)
    d = (tx * inv_len, ty * inv_len, tz * inv_len)
    o = (cam[9], cam[10], cam[11])
    bg = (cam[14], cam[15], cam[16])

    eye_pows = _powers3(*o)
    eyeq = [_eye_coeffs(coef, eye_pows, torch.ones((), device=dev)) for coef in tab.coefs]
    hit, slot, t, refl_c, point, normal, lit, bits = _trace_and_shade(tab, o, d, save_aux, eyeq)
    result = [torch.where(hit, lit[k], bg[k]) for k in range(3)]
    # per-stage aux (Pallas kernel :1025-1029): t and the permuted slot of
    # the hit (0 and -1 on a miss), and the occlusion bits
    aux = [(t, slot.to(torch.int32), bits)] if save_aux else None

    if bounces > 0:
        # reflection chain (Pallas kernel :1031-1130), every pixel in lockstep
        ratio = torch.ones_like(d[0])
        active = hit
        for _ in range(bounces):
            enter = active & (refl_c > EPS)
            ratio = torch.where(enter, ratio * refl_c, ratio)
            dot = d[0] * normal[0] + d[1] * normal[1] + d[2] * normal[2]
            rd = tuple(d[k] - 2.0 * dot * normal[k] for k in range(3))
            no = tuple(point[k] + SHADOW_BIAS * normal[k] for k in range(3))
            h2, i2, t2, r2, p2, n2, l2, bits2 = _trace_and_shade(tab, no, rd, save_aux)
            result = [torch.where(enter, (1.0 - ratio) * result[k]
                                  + ratio * torch.where(h2, l2[k], bg[k]), result[k])
                      for k in range(3)]
            adv = enter & h2
            if save_aux:  # (:1084-1088) kept where the lane advanced / entered
                aux.append((torch.where(adv, t2, 0.0),
                            torch.where(adv, i2, -1).to(torch.int32),
                            torch.where(enter, bits2, 0)))
            refl_c = torch.where(adv, r2, refl_c)
            point = tuple(torch.where(adv, p2[k], point[k]) for k in range(3))
            normal = tuple(torch.where(adv, n2[k], normal[k]) for k in range(3))
            d = tuple(torch.where(enter, rd[k], d[k]) for k in range(3))
            active = adv
        # at-cap background blend
        enter = active & (refl_c > EPS)
        rr = ratio * refl_c
        result = [torch.where(enter, (1.0 - rr) * result[k] + rr * bg[k], result[k])
                  for k in range(3)]
    image = torch.stack(result, dim=-1).reshape(rows, width, 3)
    if not save_aux:
        return image
    return (image, *(torch.stack(list(field)).reshape(bounces + 1, rows, width)
                     for field in zip(*aux)))


def _check_tables(tables):
    """Raise unless the 8 tables are contiguous, of the kernel's dtypes and
    shapes, and on one device."""
    n_obj, n_lights = tables[0].shape[0], tables[4].shape[0]
    shapes = {
        "coefs": (n_obj, N_COEFS), "orig_index": (n_obj,), "colors": (n_obj, 3),
        "refl": (n_obj,), "lights": (n_lights, 7), "dir_table": (n_lights, n_obj),
        "posdef": (n_obj,), "cam": (18,),
    }
    device = tables[0].device
    for (name, shape), t in zip(shapes.items(), tables):
        want = torch.int32 if name in ("orig_index", "posdef") else torch.float32
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"render_fwd: {name} must be a contiguous {want} "
                             f"tensor on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"render_fwd: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


# The kernel's instantiations (``trt_render_fwd``'s ``variant``): the main
# path's iteration counts (polish 3, screen 3, shadow 1) compiled in, without
# and with a reflection chain, and the generic one with runtime counts.
FWD_VARIANTS = ("main", "main_chain", "generic")


def fwd_variant(polish_iters: int, screen_iters: int, shadow_iters: int, bounces: int) -> str:
    """The instantiation of ``csrc/render_fwd.cu`` that ``render_fwd`` launches."""
    if (polish_iters, screen_iters, shadow_iters) != (3, 3, 1):
        return "generic"
    return "main" if bounces == 0 else "main_chain"


def render_fwd(coefs, orig_index, colors, refl, lights, dir_table, posdef, cam,
               *, width: int, height: int, rows: int, n_cubic: int,
               polish_iters: int, shadow_iters: int, screen_iters: int,
               bounces: int, save_aux: bool = False):
    """Render image rows [row0, row0 + rows) -> [rows, width, 3] f32.

    CUDA tables launch the kernel of ``csrc/render_fwd.cu`` on the current
    stream (and count the launch in ``render_fwd.launches``, in
    ``render_fwd.launches_by_variant`` and, with ``save_aux``, in
    ``render_fwd.launches_save_aux``); CPU tables run ``render_fwd_plain``.
    Tables on any other device raise. The instantiation is ``fwd_variant``'s.

    ``save_aux`` (the Pallas kernel's ``save_aux=True``, for the backward)
    also returns, per chain stage s = 0..bounces, the data that fixes the
    stage without a root solve, each [bounces + 1, rows, width]:

    * ``aux_t`` f32: the hit distance where the stage hit, else 0;
    * ``aux_slot`` int32: the permuted slot of the hit, else -1;
    * ``aux_occ`` int32: bit li set where light li is occluded, for the
      stage's point (0 where a bounce stage was not entered).

    A stage k >= 1 keeps t and slot only where the lane advanced into it
    (entered and hit). The occlusion bits are an i32 mask, so ``save_aux``
    needs at most 31 lights. The bits of a light that does not face the
    point (Lambert factor 0) are not defined: the kernel does not test such
    lights, the plain version does. No gradient depends on them.
    """
    tables = (coefs, orig_index, colors, refl, lights, dir_table, posdef, cam)
    _check_tables(tables)
    device = coefs.device
    n_obj, n_lights = coefs.shape[0], lights.shape[0]
    if not 0 <= n_cubic <= n_obj:
        raise ValueError(f"render_fwd: n_cubic={n_cubic} outside [0, {n_obj}]")
    if polish_iters < 0 or min(shadow_iters, screen_iters) < 1 or bounces < 0:
        raise ValueError("render_fwd: needs polish_iters >= 0, shadow_iters >= 1, "
                         "screen_iters >= 1 and bounces >= 0")
    if save_aux and n_lights > MAX_AUX_LIGHTS:
        raise ValueError(f"render_fwd: save_aux needs at most {MAX_AUX_LIGHTS} lights "
                         f"(an i32 occlusion mask), got {n_lights}")
    kw = dict(width=width, height=height, rows=rows, n_cubic=n_cubic,
              polish_iters=polish_iters, shadow_iters=shadow_iters,
              screen_iters=screen_iters, bounces=bounces, save_aux=save_aux)
    if device.type == "cpu":
        return render_fwd_plain(*tables, **kw)
    if device.type != "cuda":
        raise ValueError(f"render_fwd: no kernel for device {device}")

    out = torch.empty((rows, width, 3), dtype=torch.float32, device=device)
    aux_shape = (bounces + 1, rows, width)
    aux = (torch.empty(aux_shape, dtype=torch.float32, device=device),
           torch.empty(aux_shape, dtype=torch.int32, device=device),
           torch.empty(aux_shape, dtype=torch.int32, device=device)) if save_aux else ()
    if out.numel() == 0:
        return (out, *aux) if save_aux else out
    variant = fwd_variant(polish_iters, screen_iters, shadow_iters, bounces)
    lib = _build.load("render_fwd")
    aux_ptrs = [t.data_ptr() for t in aux] if save_aux else [None] * 3
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.trt_render_fwd(
            *(t.data_ptr() for t in tables), out.data_ptr(), *aux_ptrs,
            width, height, rows, n_obj, n_cubic, n_lights,
            polish_iters, shadow_iters, screen_iters, bounces,
            FWD_VARIANTS.index(variant), stream)
    if rc != 0:
        raise RuntimeError(f"render_fwd: kernel launch ({variant}) failed: CUDA error {rc} "
                           f"({_build.error_string('render_fwd', rc)})")
    render_fwd.launches += 1
    render_fwd.launches_by_variant[variant] += 1
    render_fwd.launches_save_aux += int(save_aux)
    return (out, *aux) if save_aux else out


render_fwd.launches = 0
render_fwd.launches_by_variant = dict.fromkeys(FWD_VARIANTS, 0)
render_fwd.launches_save_aux = 0
launches.register("render_fwd", render_fwd, "launches")
launches.register("render_fwd.save_aux", render_fwd, "launches_save_aux")
launches.register("render_fwd", render_fwd, "launches_by_variant")
