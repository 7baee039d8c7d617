"""The least time an H100 could take for one call of each kernel.

A kernel's bound is max(operations / f32 peak, bytes / memory rate): the f32
operations the function needs for this call's data and the bytes it must
move, each input read once and each output written once. Both kernels are
bound by operations (hundreds to thousands per pixel against 24 to 36
bytes).

Operations are counted from the code, not measured. Each component of a
pixel's work (the ray expansion of a cubic slot, its seeds, one screen, the
polish, one light's Lambert factor, one shadow test; in the backward the
stage geometry, one light's terms and their reverse, the normal and root
backward, ...) is counted once by running its plain PyTorch version
(``render/fwd_kernel.py``, ``render/bwd_kernel.py``, which follow the
kernels operation for operation) on one pixel under a dispatch mode that
counts every f32 operation: add, sub, mul and min/max count 1 (so an FMA
counts 2), and division, sqrt, rsqrt, pow and cos count the instructions
nvcc emits for them on their fast path (``SASS_COST``); sign tests, selects,
abs and negation count 0. ``fwd_work`` and ``bwd_work`` combine the
components with the branch shares of the call's own aux, replayed by the
backward's Phase A (``bwd_kernel.chain_states``): which slot each stage hit,
which lights face the hit point, which are occluded, whether the stage's
lit sum stays under the clamp. Each piece is counted where the function
needs it and once: a light's terms once per stage, nothing for a light the
aux marks occluded beyond what finds it occluded, only the sign of the
Lambert factor for a light that faces away. Where the aux cannot say how
much a pixel did, the count takes the least: a slot's polish only where
that slot is the stage's hit (a ray also polishes a cubic it hits behind
another object), one shadow test of slot 0 for an occluded light (the loop
stops at the occluder; the first candidate may be the occluding one), every
test for a lit light.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.surface import N_COEFS
from ..ops.constants import EPS, SHADOW_BIAS
from . import bwd_kernel as bk
from . import fwd_kernel as fk

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate.
H100_F32_OPS_PER_S = 67e12
H100_BYTES_PER_S = 3.35e12

# SASS instructions of each math function's fast path on sm_90a with
# -fmad=true and no fast math, from the probe of
# `python -m tpu_ray_tracer_torch.kernel_bench --sass-costs` (nvcc 12.9):
# each probe kernel's instructions up to its EXIT, skipping the slow paths
# it branches over (cosf's large-argument reduction loop: 141 instructions
# with it; the division's and sqrtf's subroutine calls: 13 and 14), less
# those of a kernel that only adds.
SASS_COST = {"div": 10, "sqrt": 10, "rsqrt": 4, "pow": 81, "cos": 32}

_SASS_OPS = {"div": "div", "reciprocal": "div", "sqrt": "sqrt", "rsqrt": "rsqrt",
             "pow": "pow", "cos": "cos"}
_UNIT = ("add", "sub", "rsub", "mul", "maximum", "minimum", "clamp", "clamp_min",
         "clamp_max", "index_add", "sum")

# ray generation: ndc (4), camera plane (6), R (cx, cy, 1) (12), |t|^2 (5),
# the unit direction (3), and one rsqrt; the same in both kernels
RAYGEN_OPS = 30 + SASS_COST["rsqrt"]


class _OpCounter(TorchDispatchMode):
    """Counts the f32 operations of everything run under it (see the module
    docstring); a reduction over n values counts n - 1."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name == "sum":
            self.ops += max(args[0].numel() - out.numel(), 0)
        elif name == "index_add":
            self.ops += args[3].numel()
        elif name in _UNIT and isinstance(out, torch.Tensor) and out.is_floating_point():
            self.ops += out.numel()
        elif name in _SASS_OPS and isinstance(out, torch.Tensor) and out.is_floating_point():
            self.ops += SASS_COST[_SASS_OPS[name]] * out.numel()
        return out


def count_ops(fn, *args, **kwargs) -> int:
    """f32 operations of ``fn(*args, **kwargs)`` (see the module docstring)."""
    with _OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.ops


def bound_ms(ops: float, n_bytes: float):
    """(least time in ms, "operations" or "bytes") on an H100 at its
    published f32 and memory peaks."""
    t_ops, t_bytes = ops / H100_F32_OPS_PER_S, n_bytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _sign_test(sph: bool) -> int:
    """Operations of the sign of a light's Lambert factor: n . (light - p)
    for a spherical light, n . direction for a directional one."""
    x = torch.tensor(0.3)
    if sph:
        return count_ops(lambda: (x - x) * x + (x - x) * x + (x - x) * x)
    return count_ops(lambda: x * x + x * x + x * x)


# --- forward components, one ray each ---

@functools.cache
def fwd_components(polish_iters: int, screen_iters: int, shadow_iters: int) -> dict:
    """f32 operations of each piece of a forward pixel's work, for these
    iteration counts (counted once per process)."""
    x = torch.tensor(0.3)
    one = torch.ones(())
    coef = [x] * N_COEFS
    o = d = (x, x, x)
    t3 = t2 = t1 = t0 = x

    def screen(t):  # `_solve_object`'s screen, one seed
        for _ in range(screen_iters):
            t = fk._newton_step(t, fk._feval1d(t3, t2, t1, t0, t), fk._dfeval1d(t3, t2, t1, t))
        return fk._genuine1d(t3, t2, t1, t0, t)

    def sub_seeds():  # the two dominant-balance seeds of a cubic slot
        qsq = torch.sqrt(torch.clamp(t1 * t1 - 4.0 * t2 * t0, min=0.0))
        return (-t1 - qsq) / (2.0 * t2), (-t1 + qsq) / (2.0 * t2)

    def shadow_candidate(t):
        for _ in range(shadow_iters):
            t = fk._newton_step(t, fk._feval1d(t3, t2, t1, t0, t), fk._dfeval1d(t3, t2, t1, t))
        return fk._genuine1d(t3, t2, t1, t0, t)

    def normal():
        p = [o[k] + x * d[k] for k in range(3)]
        _, _, g = fk._eval_F_and_grad(coef, fk._powers3(*p), need_mag=False)
        norm = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
        return [g[k] * (1.0 / norm) for k in range(3)]

    def cubic_t2_t1():  # `cubic_occ`'s Taylor assembly of t2, t1
        h, g = [x] * 6, [x] * 3
        return (0.5 * (h[0] * (x * x) + h[1] * (x * x) + h[2] * (x * x)) + h[3] * (x * x)
                + h[4] * (x * x) + h[5] * (x * x)), g[0] * x + g[1] * x + g[2] * x

    def spherical_t3():  # a spherical light's cubic form at one cubic slot
        pows = fk._powers3(x, x, x)
        return sum(coef[m] * fk._prod(pows, fk.MONOMIAL_POWERS[m], 1.0)
                   for m in range(fk.QUAD_START))

    def spherical_t2():
        return (x * (x * x) + x * (x * x) + x * (x * x) + x * (x * x) + x * (x * x)
                + x * (x * x))

    def lambert_spherical():  # `lambert`: the factor and the falloff
        to = [x - x, x - x, x - x]
        dist2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
        inv = torch.rsqrt(dist2)
        lam = torch.clamp(x * (to[0] * inv) + x * (to[1] * inv) + x * (to[2] * inv), min=0.0)
        return lam, 1.0 / (fk._FOUR_PI * dist2)

    def lambert_directional():
        return torch.clamp(x * x + x * x + x * x, min=0.0)

    def light_sum():  # the final sum's terms of one light
        w = x * fk._INV_PI
        scale = x * w
        return [x + x * x * scale for _ in range(3)]

    pows = fk._powers3(x, x, x)
    # the seeds' first slot is the Cardano root (two powf) or the trig one
    # (one cosf): count the trig one, the cheaper
    cardano = count_ops(lambda: fk._cbrt(x + x) + fk._cbrt(x - x))
    trig = count_ops(lambda: x * torch.cos(x))
    return {
        "raygen": RAYGEN_OPS,
        "powers": count_ops(fk._powers3, x, x, x),  # of a direction or an origin
        # a slot's t-polynomial: the binomial expansion (a bounce ray), or
        # from the eye-hoisted coefficients (a primary ray)
        "cubic_expand": count_ops(fk._ray_coeffs, coef, pows, pows, one),
        "cubic_expand_eye": count_ops(fk._eye_ray_coeffs, coef, pows, one),
        "quad_expand": count_ops(fk._ray_coeffs, coef, pows, pows, one,
                                 m_start=fk.QUAD_START, k_max=2),
        "quad_expand_eye": count_ops(fk._eye_ray_coeffs, coef, pows, one,
                                     m_start=fk.QUAD_START, k_max=2),
        "eye_coeffs": count_ops(fk._eye_coeffs, coef, pows, one),  # per slot and frame
        "cubic_roots": count_ops(fk._cubic_seeds, t3, t2, t1, t0) - cardano + trig
                       + count_ops(sub_seeds) + 5 * count_ops(screen, x),
        "cubic_polish": count_ops(fk._polish, coef, o, d, x, polish_iters, reject=True),
        "quad_roots": count_ops(fk._stable_quad_roots, t2, t1, t0),
        "quad_polish": count_ops(fk._polish, coef, o, d, x, min(polish_iters, 2),
                                 m_start=fk.QUAD_START, reject=False),
        "normal": count_ops(normal),
        # shadow origin p + bias n (6) and its powers (6); the clamp (3)
        "shade": 6 + 6 + 3,
        "cubic_pre": count_ops(fk._eval_F_and_grad, coef, fk._powers3(x, x, x),
                               need_mag=False) + count_ops(fk._hessian_entries, coef,
                                                           fk._powers3(x, x, x)),
        "quad_pre": count_ops(fk._eval_F_and_grad, coef, fk._powers3(x, x, x),
                              fk.QUAD_START, need_mag=False),
        "cubic_occ_setup": count_ops(cubic_t2_t1) + count_ops(fk._cubic_seeds, t3, t2, t1, t0)
                           - cardano + trig + count_ops(fk._stable_quad_roots, t2, t1, t0),
        "cubic_occ_candidate": count_ops(shadow_candidate, x),
        "cubic_t3_spherical": count_ops(spherical_t3),
        "quad_occ": count_ops(lambda: x * x + x * x + x * x)  # t1
                    + count_ops(fk._quadlin_occ, t2, t1, t0, 1.0),
        "quad_t2_spherical": count_ops(spherical_t2),
        "sign_spherical": _sign_test(True),
        "sign_directional": _sign_test(False),
        "lambert_spherical": count_ops(lambert_spherical),
        "lambert_directional": count_ops(lambert_directional),
        "light_sum": count_ops(light_sum),
        # reflect (14), biased origin (6), ratio (1), blend (12); at the cap
        # the background blend (13)
        "bounce": 33,
        "at_cap": 13,
    }


def stage_classes(tables, kw, aux) -> dict:
    """What each stage of each pixel needs, from the call's aux
    ``(aux_t, aux_slot, aux_occ)`` replayed by the backward's Phase A
    (``bwd_kernel.chain_states`` on the packed ``tables`` of
    ``pack_frame``): ``hit`` [S, P] (the stage hit a slot), ``reflects``
    [S, P] (it hit a slot that reflects, so the ray enters stage s + 1),
    per light [S, P, L] ``lit`` (faces the hit point and is not occluded),
    ``occluded`` (faces it and is occluded) and ``away`` (the aux leaves it
    unoccluded and it faces away), and ``unclamped`` [S, P] (the pre-clamp
    lit sum is under 1 in some channel)."""
    coefs, lights = tables[0], tables[4]
    _, states = bk.chain_states(coefs, tables[2], tables[3], lights, tables[7], *aux,
                                width=kw["width"], height=kw["height"], rows=kw["rows"],
                                bounces=kw["bounces"])
    hit = torch.stack([st["hit"] for st in states])
    shape = (*hit.shape, lights.shape[0])
    if lights.shape[0]:
        faces = torch.stack([torch.stack([lt["lam"] > 0 for lt in st["lights"]], -1)
                             for st in states])
        bit = torch.stack([torch.stack([lt["notocc"] < 0.5 for lt in st["lights"]], -1)
                           for st in states])
    else:
        faces = bit = torch.zeros(shape, dtype=torch.bool, device=hit.device)
    at_hit = hit[..., None]
    return {
        "hit": hit,
        "reflects": hit & torch.stack([st["rfl"] > EPS for st in states]),
        "lit": at_hit & faces & ~bit,
        "occluded": at_hit & faces & bit,
        "away": at_hit & ~faces & ~bit,
        "unclamped": torch.stack([(st["lit"][0] < 1) | (st["lit"][1] < 1) | (st["lit"][2] < 1)
                                  for st in states]),
    }


def fwd_work(tables, kw, aux) -> dict:
    """{"ops", "bytes"} of one ``render_fwd`` call on these tables, along
    the path its pixels take as its own aux ``(aux_t, aux_slot, aux_occ)``
    records it (``render_fwd(..., save_aux=True)`` on the same tables), and
    the bytes with and without the aux outputs."""
    n_obj, n_cubic = tables[0].shape[0], kw["n_cubic"]
    n_quad = n_obj - n_cubic
    c = fwd_components(kw["polish_iters"], kw["screen_iters"], kw["shadow_iters"])
    cls = stage_classes(tables, kw, aux)
    hit, lit, occ = cls["hit"], cls["lit"], cls["occluded"]
    n_stages, n_px = hit.shape
    slot = aux[1].reshape(n_stages, -1).long()
    is_cubic = torch.arange(n_obj, device=slot.device) < n_cubic

    # rays traced: stage 0 always; stage k >= 1 where the lane entered it
    traced = torch.ones_like(hit)
    traced[1:] = cls["reflects"][:-1]
    n_traced = float(traced.sum())
    n_bounce = n_traced - n_px  # rays traced from a hit point
    n_hit = float(hit.sum())
    hit_cubic = float((hit & is_cubic[slot.clamp(min=0)]).sum())
    ops = n_px * c["raygen"] + n_obj * c["eye_coeffs"] + n_traced * c["powers"]
    ops += n_px * (n_cubic * c["cubic_expand_eye"] + n_quad * c["quad_expand_eye"])
    ops += n_bounce * (n_obj * c["powers"] + n_cubic * c["cubic_expand"]
                       + n_quad * c["quad_expand"])
    ops += n_traced * (n_cubic * c["cubic_roots"] + n_quad * c["quad_roots"])
    ops += hit_cubic * c["cubic_polish"] + (n_hit - hit_cubic) * c["quad_polish"]
    ops += n_hit * (c["normal"] + c["shade"]) + n_bounce * c["bounce"]
    if n_stages > 1:  # stages that hit at the cap blend in the background
        ops += float((hit[-1] & traced[-1]).sum()) * c["at_cap"]

    # lights of a hit: the sign of the Lambert factor where the light ends
    # up occluded or faces away; the factor, its falloff and the sum's terms
    # where it is lit; the shadow tests where it faces the point
    for li, sph in enumerate((tables[4][:, 0] > 0.5).tolist()):
        kind = "spherical" if sph else "directional"
        n_lit, n_occ = float(lit[..., li].sum()), float(occ[..., li].sum())
        ops += (n_hit - n_lit) * c[f"sign_{kind}"]
        ops += n_lit * (c[f"lambert_{kind}"] + c["light_sum"])
        t3 = c["cubic_t3_spherical"] if sph else 0
        t2 = c["quad_t2_spherical"] if sph else 0
        cubic_test = t3 + c["cubic_occ_setup"] + 5 * c["cubic_occ_candidate"]
        quad_test = t2 + c["quad_occ"]
        ops += n_lit * (n_cubic * cubic_test + n_quad * quad_test)
        if n_obj:  # an occluded light: at least slot 0's test
            first = (t3 + c["cubic_occ_setup"] + c["cubic_occ_candidate"]) if n_cubic else quad_test
            ops += n_occ * first
    # per-object precompute at the shadow origin: every object where a
    # facing light stays lit, slot 0 where all facing lights are occluded
    any_lit = float(lit.any(-1).sum())
    only_occ = float((occ.any(-1) & ~lit.any(-1)).sum())
    ops += any_lit * (n_cubic * c["cubic_pre"] + n_quad * c["quad_pre"])
    if n_obj:
        ops += only_occ * (c["cubic_pre"] if n_cubic else c["quad_pre"])

    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    return {"ops": ops, "bytes": table_bytes + 12 * n_px,
            "bytes_save_aux": table_bytes + 12 * n_px + 12 * n_px * n_stages}


# --- backward components, one pixel each ---

@functools.cache
def bwd_components() -> dict:
    """f32 operations of each piece of a backward pixel's work (counted once
    per process). A lit light's factor notocc is 1: its products (1 in the
    terms, 1 in the lit sum, 3 in the reverse) are left out."""
    x = torch.tensor(0.3)
    v3 = lambda: [x, x, x]  # noqa: E731  (a fresh list: the reverse updates in place)
    occ = torch.tensor(0, dtype=torch.int32)
    st = dict(n=v3(), gF=v3(), pcache=fk._powers3(x, x, x), sel=[x] * N_COEFS, t=x, d=v3(),
              inv_nu=x, hit=torch.tensor(True))
    ray = dict(d0=v3(), inv_len=x, cx=x, cy=x, gxf=x, gyf=x)

    def terms(sph):
        return bk._light_terms([x] * 7, sph, 0, v3(), v3(), occ)

    def lit_sum():  # one light's term of the pre-clamp lit sum
        w = x * fk._INV_PI * x
        return [x + x * x * w for _ in range(3)]

    def reflect():  # stage s + 1's ray: o' = p + bias n, d' = d - 2 (d.n) n
        dot = x * x + x * x + x * x
        return ([x + SHADOW_BIAS * x for _ in range(3)], [x - 2.0 * dot * x for _ in range(3)])

    def blend():  # r_s, bcol = min(1, lit), c_s = (1 - r_s) c_{s-1} + r_s bcol
        r = x * x
        a = 1.0 - r
        return [a * x + r * torch.clamp(x, max=1.0) for _ in range(3)]

    def blend_bwd():  # the reverse of the blend, and the refl row's term
        a = 1.0 - x
        dr = x + (x * (x - x) + x * (x - x) + x * (x - x))
        return [x * x for _ in range(3)], [x * a for _ in range(3)], dr * x, dr * x

    def reflect_bwd():  # stage s + 1's ray cotangent into stage s (u = d.n kept)
        nddp = x * x + x * x + x * x
        dn_in = [SHADOW_BIAS * x - 2.0 * (nddp * x + x * x) for _ in range(3)]
        dd_in = [x - 2.0 * x * nddp for _ in range(3)]
        return dn_in, dd_in, [x + x for _ in range(9)]  # dd_nxt, dn, dpoint sums

    def at_cap():  # the at-cap background blend's reverse and its 3 + 1 rows
        rr = x * x
        a = 1.0 - rr
        drr = x * (x - x) + x * (x - x) + x * (x - x)
        return [x * a for _ in range(3)], [x * rr + x for _ in range(3)], drr * x, drr * x + x

    c = {
        "raygen": RAYGEN_OPS,
        "geometry": count_ops(bk._geometry, [x] * N_COEFS, v3(), v3(), x),
        "lit_sum": count_ops(lit_sum) - 1,
        "normal_root": count_ops(bk._normal_root_bwd, st, v3(), v3()),
        "camera": count_ops(bk._camera_rows, ray, [x] * 18, v3(), v3()),
        "reflect": count_ops(reflect),
        "blend": count_ops(blend),
        "blend_bwd": count_ops(blend_bwd),
        "reflect_bwd": count_ops(reflect_bwd),
        "at_cap": count_ops(at_cap),
    }
    for sph, kind in ((True, "spherical"), (False, "directional")):
        c[f"sign_{kind}"] = _sign_test(sph)
        c[f"terms_{kind}"] = count_ops(terms, sph) - 1
        c[f"light_bwd_{kind}"] = count_ops(bk._light_bwd, terms(sph), v3(), v3(), v3(), v3(),
                                           v3(), v3()) - 3
    return c


def bwd_work(tables, kw, aux) -> dict:
    """{"ops", "bytes"} of one ``render_bwd`` call on the packed ``tables``
    of ``pack_frame`` and the forward's aux ``(aux_t, aux_slot, aux_occ)``,
    along the path the aux records. A stage that hit pays its geometry, and
    per light the sign test (occluded or facing away) or the light's terms
    and its part of the lit sum (lit); where a lit light's term is under the
    clamp, the stage also pays each lit light's reverse and the normal and
    root backward, which a stage also pays where the next stage's ray
    carries a cotangent back. A stage that missed pays its background rows.
    Every row value costs one add into its sum over pixels. Bytes: the
    cotangent and the aux read once, the tables read and the gradient rows
    written once."""
    c = bwd_components()
    cls = stage_classes(tables, kw, aux)
    hit, lit = cls["hit"], cls["lit"]
    n_stages, n_px = hit.shape
    spherical = (tables[4][:, 0] > 0.5).tolist()
    traced = torch.ones_like(hit)
    traced[1:] = cls["reflects"][:-1]
    lit_active = hit & lit.any(-1) & cls["unclamped"]
    active = lit_active.clone()  # the stage's normal and point carry a cotangent
    for s in range(n_stages - 2, -1, -1):
        active[s] |= hit[s] & active[s + 1]

    def n(mask):
        return float(mask.sum())

    ops = n(hit[0]) * c["raygen"] + n(active[0]) * (c["camera"] + 14)
    for s in range(n_stages):
        ops += n(hit[s]) * c["geometry"] + n(traced[s] & ~hit[s]) * 3  # background rows
        for li, sph in enumerate(spherical):
            kind = "spherical" if sph else "directional"
            ops += n(cls["occluded"][s, :, li] | cls["away"][s, :, li]) * c[f"sign_{kind}"]
            ops += n(lit[s, :, li]) * (c[f"terms_{kind}"] + c["lit_sum"])
            ops += n(lit[s, :, li] & lit_active[s]) * (c[f"light_bwd_{kind}"] + 6)
        ops += n(lit_active[s]) * 3 + n(active[s]) * (c["normal_root"] + 20)
        if s > 0:
            ops += n(hit[s]) * c["reflect"] + n(traced[s]) * (c["blend"] + c["blend_bwd"] + 1)
            ops += n(active[s]) * c["reflect_bwd"]
    if n_stages > 1:
        ops += n(cls["reflects"][-1]) * c["at_cap"]

    n_obj, n_lights = tables[0].shape[0], tables[4].shape[0]
    table_floats = n_obj * (N_COEFS + 3 + 1) + 7 * n_lights + 18
    return {"ops": ops,
            "bytes": 4 * (table_floats + bk.acc_layout(n_obj, n_lights)[-1])
                     + n_px * (12 + 12 * n_stages)}
