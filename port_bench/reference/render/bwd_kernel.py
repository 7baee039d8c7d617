"""The pieces of the port's backward kernel K2 that its operation count reads.

``chain_states`` is the backward's Phase A: from the per-stage aux that the
forward saved (per chain stage the hit distance, the hit slot and the
occlusion bits) it regenerates the primary ray and rebuilds the reflection
chain (points, normals, the pre-clamp lit sums, the blend ratios and
colours). ``_light_bwd``, ``_normal_root_bwd`` and ``_camera_rows`` are
Phase B's shading backward, the normal and implicit-function root backward,
and the camera's ray generation. ``bounds.py`` counts their operations; the
kernel itself (``csrc/render_bwd.cu`` of the port) follows the backward
Pallas kernel of ``tpu_ray_tracer/render/pallas_backend.py``
(``_make_bwd_kernel``) operation for operation.

The kernel's result is one f32 vector of ``acc_layout(N, L)[-1]`` = 18 + 24N
+ 7L rows: cam [18] | coefs [N*20] | colors [N*3] | lights [L*7] | refl [N],
in the packed (slot) order of the tables.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.surface import MONOMIAL_POWERS, N_COEFS
from ..ops.constants import SHADOW_BIAS
from .fwd_kernel import _eval_F_and_grad, _powers3, _prod

GRAZING_CLAMP = 1e-6  # Pallas `_GRAZING_CLAMP` (:1514), ops.intersect's clamp
_INV_PI = float(np.float32(1.0 / math.pi))
_FOUR_PI = float(np.float32(4.0 * math.pi))


def acc_layout(n_objects: int, n_lights: int):
    """Rows of the gradient vector (Pallas ``_acc_layout``, :1567):
    (row_cam, row_coefs, row_colors, row_lights, row_refl, total)."""
    row_cam = 0
    row_coefs = 18
    row_colors = row_coefs + n_objects * N_COEFS
    row_lights = row_colors + n_objects * 3
    row_refl = row_lights + n_lights * 7
    total = row_refl + n_objects
    return row_cam, row_coefs, row_colors, row_lights, row_refl, total


def _mono_fields(cache, one):
    """All 20 monomial values at the cached point powers (Pallas :1517)."""
    return [_prod(cache, pows, one) for pows in MONOMIAL_POWERS]


def _dmono_fields(cache, one, axis):
    """d(monomial_m)/d(axis) for all 20 monomials, None where identically 0
    (Pallas :1522)."""
    out = []
    for pows in MONOMIAL_POWERS:
        e = pows[axis]
        if e == 0:
            out.append(None)
            continue
        dp = list(pows)
        dp[axis] = e - 1
        f = _prod(cache, tuple(dp), one)
        out.append(f if e == 1 else f * float(e))
    return out


def _hessian_apply(coef, cache, one, v):
    """(H @ v)_b for the Hessian H of F = sum_m coef_m * mono_m at the cached
    point (Pallas :1537)."""
    out = [None, None, None]
    for m, pows in enumerate(MONOMIAL_POWERS):
        for a in range(3):
            ea = pows[a]
            if ea == 0:
                continue
            for b in range(3):
                p2 = list(pows)
                if a == b:
                    if ea < 2:
                        continue
                    fac = float(ea * (ea - 1))
                    p2[a] = ea - 2
                else:
                    eb = pows[b]
                    if eb == 0:
                        continue
                    fac = float(ea * eb)
                    p2[a] = ea - 1
                    p2[b] = eb - 1
                field = coef[m] * (_prod(cache, tuple(p2), one) * fac) * v[a]
                out[b] = field if out[b] is None else out[b] + field
    zero = torch.zeros_like(one)
    return [o if o is not None else zero for o in out]


def _geometry(sel, o, d, t):
    """Point, cached point powers, grad F, 1 / |grad F| and unit normal of a
    stage from its ray (o, d) and hit distance t (Pallas :1722-1728)."""
    p = [o[k] + t * d[k] for k in range(3)]
    pcache = _powers3(*p)
    _f, _mag, gF = _eval_F_and_grad(sel, pcache, need_mag=False)
    nu = torch.sqrt(gF[0] * gF[0] + gF[1] * gF[1] + gF[2] * gF[2])
    inv_nu = 1.0 / torch.where(nu > 0, nu, 1.0)
    n = [gF[k] * inv_nu for k in range(3)]
    return p, pcache, gF, inv_nu, n


def _light_terms(light, sph, li, p, n, occ):
    """The forward's shading quantities for light ``li`` (``light``: its 7
    table values; ``sph``: its kind) at a stage's point, normal and
    occlusion bits (Pallas ``light_terms``, :1667, static-kind branches)."""
    lp, lc = light[1:4], light[4:7]
    if sph:
        to = [lp[k] - p[k] for k in range(3)]
        dist2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
        inv_dn = torch.rsqrt(torch.where(dist2 > 0, dist2, 1.0))
        ld = [to[k] * inv_dn for k in range(3)]
        colr = [lc[k] / (_FOUR_PI * dist2) for k in range(3)]
    else:  # directional: the stored direction and colour, no falloff
        to = dist2 = inv_dn = None
        ld = lp
        colr = lc
    ndotl = n[0] * ld[0] + n[1] * ld[1] + n[2] * ld[2]
    lam = torch.clamp(ndotl, min=0.0)
    notocc = 1.0 - ((occ >> li) & 1).to(torch.float32)
    return dict(sph=sph, to=to, dist2=dist2, inv_dn=inv_dn, ld=ld, colr=colr, ndotl=ndotl,
                lam=lam, notocc=notocc)


def _light_bwd(lt, dlit, objc, n, dobjc, dn, dpoint):
    """Reverse one light's term of the Lambertian sum (Pallas ``shade_bwd``,
    :1775) from its ``_light_terms`` ``lt``: adds into the stage's running
    ``dobjc``, ``dn`` and ``dpoint`` (lists, updated in place) and returns
    the light's row values by column of the light table (1-3 position or
    direction, 4-6 colour)."""
    sph, ld, colr, lam = lt["sph"], lt["ld"], lt["colr"], lt["lam"]
    rows = {}
    u_lam = [dlit[c] * lt["notocc"] for c in range(3)]
    dlam = ddist2 = torch.zeros_like(dlit[0])
    for c in range(3):
        dobjc[c] = dobjc[c] + u_lam[c] * _INV_PI * colr[c] * lam
        dcol_c = u_lam[c] * objc[c] * _INV_PI * lam
        dlam = dlam + u_lam[c] * objc[c] * _INV_PI * colr[c]
        if sph:
            rows[4 + c] = dcol_c / (_FOUR_PI * lt["dist2"])
            ddist2 = ddist2 - dcol_c * colr[c] / lt["dist2"]
        else:
            rows[4 + c] = dcol_c
    dndotl = dlam * (lt["ndotl"] > 0).to(torch.float32)
    dld = [dndotl * n[k] for k in range(3)]
    for k in range(3):
        dn[k] = dn[k] + dndotl * ld[k]
    if not sph:
        for k in range(3):
            rows[1 + k] = dld[k]
        return rows
    udot = ld[0] * dld[0] + ld[1] * dld[1] + ld[2] * dld[2]
    for k in range(3):
        dto_k = (dld[k] - ld[k] * udot) * lt["inv_dn"] + 2.0 * lt["to"][k] * ddist2
        rows[1 + k] = dto_k
        dpoint[k] = dpoint[k] - dto_k
    return rows


def _normal_root_bwd(st, dn, dpoint):
    """Close a stage past its shading (Pallas ``stage_bwd``, :1834) from the
    cotangents of its normal and point: the normal backward through grad F
    and the Hessian, the point p = o + t d, and the implicit-function root
    backward clamped at grazing. Returns (dsel [20], do, dd)."""
    n, gF, pcache, sel = st["n"], st["gF"], st["pcache"], st["sel"]
    t, d = st["t"], st["d"]
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    # normal backward: n = gF / |gF|
    ndotdn = n[0] * dn[0] + n[1] * dn[1] + n[2] * dn[2]
    dgF = [(dn[k] - n[k] * ndotdn) * st["inv_nu"] for k in range(3)]
    dsel = [zero] * N_COEFS
    for axis in range(3):
        dmono = _dmono_fields(pcache, one, axis)
        for m in range(N_COEFS):
            if dmono[m] is not None:
                dsel[m] = dsel[m] + dgF[axis] * dmono[m]
    hv = _hessian_apply(sel, pcache, one, dgF)
    dpoint = [dpoint[k] + hv[k] for k in range(3)]

    # point backward: p = o + t d
    dt = dpoint[0] * d[0] + dpoint[1] * d[1] + dpoint[2] * d[2]
    do = list(dpoint)
    dd = [t * dpoint[k] for k in range(3)]

    # implicit-function-theorem root backward, clamped at grazing
    df_dt = gF[0] * d[0] + gF[1] * d[1] + gF[2] * d[2]
    valid = st["hit"] & (torch.abs(df_dt) > GRAZING_CLAMP)
    sc = dt * torch.where(valid, -1.0 / torch.where(valid, df_dt, 1.0), 0.0)
    mono = _mono_fields(pcache, one)
    for m in range(N_COEFS):
        dsel[m] = dsel[m] + sc * mono[m]
    for k in range(3):
        do[k] = do[k] + sc * gF[k]
        dd[k] = dd[k] + sc * t * gF[k]
    return dsel, do, dd


def _camera_rows(ray, cam, do, dd):
    """Camera rows 0-13 of each pixel from the cotangents (do, dd) of its
    primary ray (d0 = target / |target|, target = cx R0 + cy R1 + R2)."""
    d0, inv_len = ray["d0"], ray["inv_len"]
    dddot = d0[0] * dd[0] + d0[1] * dd[1] + d0[2] * dd[2]
    dtg = [(dd[k] - d0[k] * dddot) * inv_len for k in range(3)]
    rows = [None] * 14
    for k in range(3):
        rows[k] = ray["cx"] * dtg[k]
        rows[3 + k] = ray["cy"] * dtg[k]
        rows[6 + k] = dtg[k]
        rows[9 + k] = do[k]
    dcx = dtg[0] * cam[0] + dtg[1] * cam[1] + dtg[2] * cam[2]
    dcy = dtg[0] * cam[3] + dtg[1] * cam[4] + dtg[2] * cam[5]
    rows[12] = ray["gxf"] * dcx
    rows[13] = ray["gyf"] * dcy
    return rows


def chain_states(coefs, colors, refl, lights, cam, aux_t, aux_slot, aux_occ, *, width: int,
                 height: int, rows: int, bounces: int):
    """Phase A of the backward (Pallas :1716-1771): regenerate the primary
    ray and rebuild the reflection chain forward from the aux, with no root
    solve. Returns the primary ray's fields (d0, inv_len, cx, cy, gxf, gyf)
    and per stage a dict of its aux, gathered table rows, ray, geometry
    (``_geometry``), each light's ``_light_terms`` and the pre-clamp lit
    sum."""
    dev = coefs.device
    n_obj, n_lights = coefs.shape[0], lights.shape[0]
    n_stages = bounces + 1
    kinds = [k > 0.5 for k in lights[:, 0].tolist()]
    lrows = [list(row.unbind(0)) for row in lights.unbind(0)]
    coefs_pad = torch.cat([coefs, coefs.new_zeros(1, N_COEFS)])
    colors_pad = torch.cat([colors, colors.new_zeros(1, 3)])
    refl_pad = torch.cat([refl, refl.new_zeros(1)])

    # --- regenerate the primary ray (identical math to the forward) ---
    n_px = rows * width
    pixel = torch.arange(n_px, device=dev, dtype=torch.int32)
    pix_y_local = pixel // width
    pix_x = pixel - pix_y_local * width
    pix_y = pix_y_local + cam[17].to(torch.int32)
    ndc_x = (pix_x.to(torch.float32) + 0.5) * float(np.float32(1.0 / width))
    ndc_y = (pix_y.to(torch.float32) + 0.5) * float(np.float32(1.0 / height))
    gxf = 2.0 * ndc_x - 1.0
    gyf = 2.0 * ndc_y - 1.0
    cx = gxf * cam[12]
    cy = gyf * cam[13]
    tx = cx * cam[0] + cy * cam[3] + cam[6]
    ty = cx * cam[1] + cy * cam[4] + cam[7]
    tz = cx * cam[2] + cy * cam[5] + cam[8]
    inv_len = torch.rsqrt(tx * tx + ty * ty + tz * tz)
    d0 = [tx * inv_len, ty * inv_len, tz * inv_len]
    ray = dict(d0=d0, inv_len=inv_len, cx=cx, cy=cy, gxf=gxf, gyf=gyf)

    zero = torch.zeros_like(d0[0])
    aux_t = aux_t.reshape(n_stages, n_px)
    aux_slot = aux_slot.reshape(n_stages, n_px)
    aux_occ = aux_occ.reshape(n_stages, n_px)
    states = []
    o = [cam[9 + k].expand(n_px) for k in range(3)]
    d = d0
    for s in range(n_stages):
        t = aux_t[s]
        slot = aux_slot[s]
        occ = aux_occ[s]
        hit = slot >= 0
        gidx = torch.where(hit, slot, n_obj).to(torch.int64)  # -1 reads the zero row
        sel = list(coefs_pad[gidx].unbind(1))
        objc = list(colors_pad[gidx].unbind(1))
        p, pcache, gF, inv_nu, n = _geometry(sel, o, d, t)
        terms = [_light_terms(lrows[li], kinds[li], li, p, n, occ) for li in range(n_lights)]
        # pre-clamp lit: sets both the clamp mask and the blended colour chain
        lit = [zero, zero, zero]
        for lt in terms:
            w = lt["lam"] * _INV_PI * lt["notocc"]
            for c in range(3):
                lit[c] = lit[c] + objc[c] * lt["colr"][c] * w
        states.append(dict(t=t, slot=slot, gidx=gidx, occ=occ, hit=hit,
                           hitf=hit.to(torch.float32), sel=sel, objc=objc,
                           rfl=refl_pad[gidx], o=o, d=d, p=p, pcache=pcache, gF=gF,
                           inv_nu=inv_nu, n=n, lights=terms, lit=lit,
                           litc=[torch.clamp(lit[c], max=1.0) for c in range(3)]))
        if s + 1 < n_stages:
            o = [p[k] + SHADOW_BIAS * n[k] for k in range(3)]
            dot = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
            d = [d[k] - 2.0 * dot * n[k] for k in range(3)]
    return ray, states
