"""Backward render kernel K2: its launch wrapper and its plain PyTorch version.

``render_bwd`` turns the cotangent of a rendered block of rows into the
gradient of every packed table, from the per-stage aux that
``render_fwd(..., save_aux=True)`` saved: per chain stage the hit distance,
the hit slot and the occlusion bits. It solves no roots. It regenerates the
primary ray, rebuilds the reflection chain forward from the aux (Phase A:
points, normals, the pre-clamp lit sums, the blend ratios and colours), then
replays it in reverse (Phase B: the at-cap blend, the per-stage blend and
ratio, the clamp mask, the shading backward, the normal backward through
grad F and the Hessian, the implicit-function root backward with the 1e-6
grazing clamp, the reflect/bias geometry between stages, and the camera's
ray generation).

On CUDA tensors it launches the hand-written kernel of ``csrc/render_bwd.cu``;
on CPU tensors it runs ``render_bwd_plain``, the same math written with
PyTorch tensor operations over all pixels at once. Both replace the backward
Pallas kernel of ``tpu_ray_tracer/render/pallas_backend.py``
(``_make_bwd_kernel``) and follow its arithmetic operation for operation, so
they differ in rounding and in the order of the sums over pixels.

The result is one f32 vector of ``acc_layout(N, L)[-1]`` = 18 + 24N + 7L
rows: cam [18] | coefs [N*20] | colors [N*3] | lights [L*7] | refl [N], in
the packed (slot) order of the tables. Row 17 of cam (the row offset) and
column 0 of each light (the kind flag) hold no gradient; the refl rows are
written only when ``bounces > 0``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..models.surface import MONOMIAL_POWERS, N_COEFS
from ..ops.constants import EPS, SHADOW_BIAS
from . import _build
from .fwd_kernel import MAX_AUX_LIGHTS, _eval_F_and_grad, _powers3, _prod

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


def split_grad(vec: torch.Tensor, n_objects: int, n_lights: int) -> dict:
    """Views of the gradient vector by table: cam [18], coefs [N, 20],
    colors [N, 3], lights [L, 7] and refl [N]."""
    row_cam, row_coefs, row_colors, row_lights, row_refl, total = acc_layout(n_objects,
                                                                             n_lights)
    return {"cam": vec[row_cam:row_coefs],
            "coefs": vec[row_coefs:row_colors].reshape(n_objects, N_COEFS),
            "colors": vec[row_colors:row_lights].reshape(n_objects, 3),
            "lights": vec[row_lights:row_refl].reshape(n_lights, 7),
            "refl": vec[row_refl:total]}


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


def render_bwd_plain(coefs, colors, refl, lights, cam, grad_image, aux_t, aux_slot,
                     aux_occ, *, width: int, height: int, rows: int, n_lights: int,
                     bounces: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the gradient vector (f32,
    ``acc_layout(N, L)[-1]`` rows) for image rows [row0, row0 + rows),
    row0 = cam[17]. Follows the Pallas kernel body :1628-1976."""
    dev = coefs.device
    n_obj = coefs.shape[0]
    row_cam, row_coefs, row_colors, row_lights, row_refl, total = acc_layout(n_obj, n_lights)
    n_stages = bounces + 1
    ray, states = chain_states(coefs, colors, refl, lights, cam, aux_t, aux_slot, aux_occ,
                               width=width, height=height, rows=rows, bounces=bounces)
    n_px = rows * width
    g = list(grad_image.reshape(n_px, 3).unbind(1))
    one = torch.ones_like(ray["d0"][0])
    zero = torch.zeros_like(ray["d0"][0])
    bg = [cam[14 + c].expand(n_px) for c in range(3)]

    contrib = {}

    def add(row, field):
        contrib[row] = field if row not in contrib else contrib[row] + field

    # blend chains: per-stage colour c_s and cumulative ratio r_s
    st0 = states[0]
    c_chain = [[torch.where(st0["hit"], st0["litc"][c], bg[c]) for c in range(3)]]
    ratio = [one]
    enterf_chain = [one]
    bcol_chain = [None]
    for s in range(1, n_stages):
        prev, st = states[s - 1], states[s]
        enter = prev["hit"] & (prev["rfl"] > EPS)
        r_s = torch.where(enter, ratio[s - 1] * prev["rfl"], ratio[s - 1])
        bcol = [torch.where(st["hit"], st["litc"][c], bg[c]) for c in range(3)]
        c_chain.append([torch.where(enter, (1.0 - r_s) * c_chain[s - 1][c] + r_s * bcol[c],
                                    c_chain[s - 1][c]) for c in range(3)])
        ratio.append(r_s)
        enterf_chain.append(enter.to(torch.float32))
        bcol_chain.append(bcol)

    # === Phase B: reverse sweep, last stage first ===
    # per-object rows of every stage, scattered by slot: dsel [20], dobjc [3],
    # drefl; slot -1 lands in the dropped row n_obj
    obj_acc = torch.zeros(n_obj + 1, N_COEFS + 4, dtype=torch.float32, device=dev)

    def stage_bwd(st, dlit, dn_in, dp_in, drefl_val):
        """Close one stage: shading -> normal -> point -> root backward;
        scatter the per-object rows; return (do, dd) of the stage's ray."""
        dn_sh, dp_sh, dobjc = [zero] * 3, [zero] * 3, [zero] * 3
        for li, lt in enumerate(st["lights"]):
            for col, value in _light_bwd(lt, dlit, st["objc"], st["n"], dobjc, dn_sh,
                                         dp_sh).items():
                add(row_lights + li * 7 + col, value)
        dn = [dn_in[k] + dn_sh[k] for k in range(3)]
        dpoint = [dp_in[k] + dp_sh[k] for k in range(3)]
        dsel, do, dd = _normal_root_bwd(st, dn, dpoint)
        rows_obj = [*dsel, *dobjc, zero if drefl_val is None else drefl_val]
        obj_acc.index_add_(0, st["gidx"], torch.stack(rows_obj, dim=1))
        return do, dd

    # cotangent through the final at-cap blend
    drefl_stage = [zero] * n_stages
    if bounces > 0:
        stB = states[-1]
        entf_b = stB["hit"] & (stB["rfl"] > EPS)
        entf = entf_b.to(torch.float32)
        rr = ratio[-1] * stB["rfl"]
        dc = [torch.where(entf_b, g[c] * (1.0 - rr), g[c]) for c in range(3)]
        drr = sum(g[c] * (bg[c] - c_chain[-1][c]) for c in range(3)) * entf
        for c in range(3):
            add(row_cam + 14 + c, g[c] * rr * entf)
        dratio = drr * stB["rfl"]
        drefl_stage[-1] = drefl_stage[-1] + drr * ratio[-1]
    else:
        dc = list(g)
        dratio = zero

    do_nxt = [zero, zero, zero]
    dd_nxt = [zero, zero, zero]
    for s in range(n_stages - 1, -1, -1):
        st = states[s]
        if s > 0:
            # c_s = enter ? (1 - r_s) c_{s-1} + r_s bcol_s : c_{s-1}
            # r_s = enter ? r_{s-1} rfl_{s-1} : r_{s-1}
            prev = states[s - 1]
            enter_b = prev["hit"] & (prev["rfl"] > EPS)
            enterf = enterf_chain[s]
            r_s = ratio[s]
            bcol = bcol_chain[s]
            dcol = [dc[c] * r_s * enterf for c in range(3)]
            dratio = dratio + sum(dc[c] * (bcol[c] - c_chain[s - 1][c])
                                  for c in range(3)) * enterf
            dc = [torch.where(enter_b, dc[c] * (1.0 - r_s), dc[c]) for c in range(3)]
            drefl_stage[s - 1] = drefl_stage[s - 1] + torch.where(
                enter_b, dratio * ratio[s - 1], 0.0)
            dratio = torch.where(enter_b, dratio * prev["rfl"], dratio)
        else:
            dcol = dc

        # stage colour: where(hit, min(1, lit), bg)
        hitf = st["hitf"]
        dlit = [dcol[c] * hitf * (st["lit"][c] < 1.0).to(torch.float32) for c in range(3)]
        for c in range(3):
            add(row_cam + 14 + c, dcol[c] * (1.0 - hitf))

        # cotangents from stage s+1's ray: o' = p + bias n, d' = d - 2 (d.n) n
        dp_in = list(do_nxt)
        dn_in = [SHADOW_BIAS * do_nxt[k] for k in range(3)]
        n, d = st["n"], st["d"]
        if s + 1 < n_stages:
            nddp = n[0] * dd_nxt[0] + n[1] * dd_nxt[1] + n[2] * dd_nxt[2]
            u = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
            dd_in = [dd_nxt[k] - 2.0 * n[k] * nddp for k in range(3)]
            for k in range(3):
                dn_in[k] = dn_in[k] - 2.0 * (nddp * d[k] + u * dd_nxt[k])
        else:
            dd_in = [zero, zero, zero]

        do_s, dd_s = stage_bwd(st, dlit, dn_in, dp_in,
                               drefl_stage[s] if bounces > 0 else None)
        do_nxt = do_s
        dd_nxt = [dd_s[k] + dd_in[k] for k in range(3)]

    # --- camera backward: d0 = target / |target| ---
    for r, value in enumerate(_camera_rows(ray, cam, do_nxt, dd_nxt)):
        add(row_cam + r, value)

    vec = torch.zeros(total, dtype=torch.float32, device=dev)
    keys = sorted(contrib)
    vec[keys] = torch.stack([contrib[r].sum() for r in keys])
    obj = obj_acc[:n_obj]
    vec[row_coefs:row_colors] = obj[:, :N_COEFS].reshape(-1)
    vec[row_colors:row_lights] = obj[:, N_COEFS:N_COEFS + 3].reshape(-1)
    vec[row_refl:] = obj[:, N_COEFS + 3]
    return vec


def _check_bwd_args(tables, grad_image, aux, rows, width, n_lights, bounces):
    """Raise unless the tables, cotangent and aux are contiguous, of the
    kernel's dtypes and shapes, and on one device."""
    n_obj = tables[0].shape[0]
    n_stages = bounces + 1
    if tables[3].shape[0] != n_lights:
        raise ValueError(f"render_bwd: n_lights={n_lights} but the light table has "
                         f"{tables[3].shape[0]} rows")
    if n_lights > MAX_AUX_LIGHTS:
        raise ValueError(f"render_bwd: at most {MAX_AUX_LIGHTS} lights (an i32 occlusion "
                         f"mask), got {n_lights}")
    if bounces < 0:
        raise ValueError("render_bwd: needs bounces >= 0")
    specs = {
        "coefs": ((n_obj, N_COEFS), torch.float32), "colors": ((n_obj, 3), torch.float32),
        "refl": ((n_obj,), torch.float32), "lights": ((n_lights, 7), torch.float32),
        "cam": ((18,), torch.float32), "grad_image": ((rows, width, 3), torch.float32),
        "aux_t": ((n_stages, rows, width), torch.float32),
        "aux_slot": ((n_stages, rows, width), torch.int32),
        "aux_occ": ((n_stages, rows, width), torch.int32),
    }
    device = tables[0].device
    for (name, (shape, want)), t in zip(specs.items(), (*tables, grad_image, *aux)):
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"render_bwd: {name} must be a contiguous {want} "
                             f"tensor on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"render_bwd: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


# Where the kernel sums the gradient rows (``csrc/render_bwd.cu``): by warp
# reductions only, with the light rows in per-thread columns of shared
# memory, or with every non-camera row in those columns.
BWD_PLACEMENTS = ("warp", "light_columns", "columns")


def bwd_plan(width: int, rows: int, n_obj: int, n_lights: int, bounces: int):
    """(placement, blocks, floats of scratch) of the kernel's launch for
    these arguments on the current CUDA device, as the launcher's plan
    picks them: the first placement of columns, light_columns, warp that
    fits in shared memory with 256 threads resident per SM, and one
    resident wave of blocks. Planned once per device and shape."""
    return _plan(torch.cuda.current_device(), width, rows, n_obj, n_lights, bounces)


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, width, rows, n_obj, n_lights, bounces):
    lib = _build.load("render_bwd")
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device_index):
        rc = lib.trt_render_bwd_plan(width, rows, n_obj, n_lights, bounces, out)
    if rc != 0:
        raise RuntimeError(f"render_bwd: no launch for this frame: CUDA error "
                           f"{rc} ({_build.error_string('render_bwd', rc)})")
    return BWD_PLACEMENTS[out[0]], int(out[1]), int(out[2])


def render_bwd(coefs, colors, refl, lights, cam, grad_image, aux_t, aux_slot, aux_occ,
               *, width: int, height: int, rows: int, n_lights: int,
               bounces: int) -> torch.Tensor:
    """Gradient vector of the packed tables (see the module docstring) for
    the cotangent ``grad_image`` [rows, width, 3] of image rows
    [row0, row0 + rows), from the aux of ``render_fwd(..., save_aux=True)``.

    CUDA tensors launch the kernel of ``csrc/render_bwd.cu`` on the current
    stream (and count the launch in ``render_bwd.launches`` and in
    ``render_bwd.launches_by_placement``); CPU tensors run
    ``render_bwd_plain``. Tensors on any other device raise. The kernel
    sums each row over pixels in a fixed order (no atomics), so a call
    repeated on the same inputs gives the same bits. The placement of the
    gradient rows is ``bwd_plan``'s.
    """
    tables = (coefs, colors, refl, lights, cam)
    aux = (aux_t, aux_slot, aux_occ)
    _check_bwd_args(tables, grad_image, aux, rows, width, n_lights, bounces)
    device = coefs.device
    kw = dict(width=width, height=height, rows=rows, n_lights=n_lights, bounces=bounces)
    if device.type == "cpu":
        return render_bwd_plain(*tables, grad_image, *aux, **kw)
    if device.type != "cuda":
        raise ValueError(f"render_bwd: no kernel for device {device}")

    n_obj = coefs.shape[0]
    n_rows = acc_layout(n_obj, n_lights)[-1]
    if rows * width == 0:
        return torch.zeros(n_rows, dtype=torch.float32, device=device)
    out = torch.empty(n_rows, dtype=torch.float32, device=device)  # the kernel writes every row
    lib = _build.load("render_bwd")
    with torch.cuda.device(device):
        placement, blocks, n_scratch = bwd_plan(width, rows, n_obj, n_lights, bounces)
        scratch = torch.empty(max(n_scratch, 1), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.trt_render_bwd(
            *(t.data_ptr() for t in (*tables, grad_image, *aux, scratch, out)),
            width, height, rows, n_obj, n_lights, bounces,
            BWD_PLACEMENTS.index(placement), blocks, stream)
    if rc != 0:
        raise RuntimeError(f"render_bwd: kernel launch ({placement}) failed: CUDA error {rc} "
                           f"({_build.error_string('render_bwd', rc)})")
    render_bwd.launches += 1
    render_bwd.launches_by_placement[placement] += 1
    return out


render_bwd.launches = 0
render_bwd.launches_by_placement = dict.fromkeys(BWD_PLACEMENTS, 0)
