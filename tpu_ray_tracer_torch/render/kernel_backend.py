"""Host half of the kernel path: scene statics, table packing and the public
render entries.

Counterpart of the host-side code of
``tpu_ray_tracer/render/pallas_backend.py`` (``render_image_pallas`` :2259,
``render_rows_pallas`` :2158, ``_render_pallas_raw`` :1336,
``_render_pallas_jit`` :1457, and the ``custom_vjp`` pair ``_packed_render``
/ ``_packed_fwd`` / ``_packed_bwd`` :2032-2120). A frame is: the scene
statics (cubics-first slot order, per-slot posdef, whether the chain runs),
memoised per table; the packed tables (``_pack_lights``, ``_pack_camera``,
``_dir_form_table``) built with torch on the scene's device; one
``render_fwd`` launch.

The render is differentiable. When grad mode is on and a scene or camera
tensor requires grad, the frame goes through ``PackedRender``: the forward
saves its per-stage aux (``render_fwd(..., save_aux=True)``) and the
backward is one ``render_bwd`` call on it, whose gradient rows autograd
carries back through the packing (the slot gather, the f32 casts and the
camera frame) to the scene's and camera's own tensors, as ``jax.grad``
carries them through ``jnp.take``, ``_pack_lights`` and ``_pack_camera``.

The JAX package's scene statics are jit-static and its kernel is rebuilt
per scene; here they are runtime arguments of one kernel build, and the
light kinds are read by the kernel from column 0 of the light table.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..models.scene import Scene
from ..models.surface import MONOMIAL_POWERS
from ..ops import camera as camera_ops
from .bwd_kernel import render_bwd, split_grad
from .fwd_kernel import MAX_AUX_LIGHTS, QUAD_START, render_fwd

# Numerics knobs of the Pallas kernel, fixed at their defaults there:
# `_shadow_polish_default()` (:1235) and `_screen_iters_default()` (:1240).
SHADOW_POLISH = 1
SCREEN_ITERS = 3


def _degree_partition(coefs):
    """Cubics-first permutation (perm, n_cubic) from concrete coefficients.

    perm lists original object indices, cubic objects first, stable within
    each class. An object is cubic iff any of its 10 cubic coefficients is
    nonzero; otherwise t3 == 0 along every ray and only the reference's
    quadratic/linear branches can fire, so the partition keeps semantics."""
    cc = np.asarray(coefs)
    is_cubic = (np.abs(cc[:, :QUAD_START]) > 0).any(axis=1)
    perm = np.argsort(~is_cubic, kind="stable").astype(np.int32)
    return perm, int(is_cubic.sum())


def _quad_posdef(coefs):
    """Per-object positive definiteness of the quadratic form Q (Sylvester's
    criterion; every sphere qualifies). A True entry selects the specialised
    occlusion classifier for that (quadric) slot. Columns 10-15 hold
    x2, y2, z2, xy, xz, yz."""
    cc = np.asarray(coefs, np.float64)
    a, b, c = cc[:, 10], cc[:, 11], cc[:, 12]
    d, e, f = cc[:, 13] / 2, cc[:, 14] / 2, cc[:, 15] / 2
    m2 = a * b - d * d
    m3 = (a * (b * c - f * f) - d * (d * c - f * e)
          + e * (d * f - b * e))
    return (a > 0) & (m2 > 0) & (m3 > 0)


# Memo of values derived from a table on the host, so that a frame loop does
# not copy the table to the host (and wait for the device) every frame. The
# key holds the tensor's data pointer, shape, dtype, device and version
# counter, which every in-place torch op bumps (the JAX memo could key on
# identity alone because JAX arrays are immutable); the weakref rejects an
# entry whose tensor died and whose id and address were reused. Writes that
# bypass autograd's version counter (through ``.data`` or a shared numpy
# buffer) are not seen.
_MEMO: dict = {}


def _memo(t: torch.Tensor, fn):
    key = (fn.__name__, id(t), t.data_ptr(), t._version, tuple(t.shape), t.dtype,
           t.device)
    entry = _MEMO.get(key)
    if entry is not None and entry[0]() is t:
        return entry[1]
    value = fn(t)
    if len(_MEMO) > 64:
        _MEMO.clear()
    _MEMO[key] = (weakref.ref(t), value)
    return value


def _compute_statics(coefs: torch.Tensor):
    cc = coefs.detach().cpu().numpy()
    perm, n_cubic = _degree_partition(cc)
    pd = _quad_posdef(cc)
    return (tuple(int(i) for i in perm), n_cubic, tuple(bool(pd[i]) for i in perm))


def _statics_for(coefs: torch.Tensor):
    """(perm, n_cubic, posdef) for a coefficient table, memoised; ``posdef``
    is in the permuted slot order the kernel sees."""
    return _memo(coefs, _compute_statics)


def _compute_slot_tables(coefs: torch.Tensor):
    perm, _, posdef = _statics_for(coefs)
    dev = coefs.device
    return (torch.tensor(perm, dtype=torch.int64, device=dev),
            torch.tensor(perm, dtype=torch.int32, device=dev),
            torch.tensor(posdef, dtype=torch.int32, device=dev))


def _slot_tables(coefs: torch.Tensor):
    """(gather index, orig_index, posdef) tensors on the table's device."""
    return _memo(coefs, _compute_slot_tables)


def _reflective(refl: torch.Tensor) -> bool:
    """The entry test of ``static_bounce_count``: any ratio above EPS."""
    return refl.numel() > 0 and float(refl.detach().max()) > 1e-7


def _light_kinds_of(light_is_spherical) -> tuple:
    """Per-light kind tuple (True = spherical)."""
    return tuple(bool(x) for x in torch.as_tensor(light_is_spherical).tolist())


def _pack_lights(scene: Scene) -> torch.Tensor:
    """[L, 7] f32: is_spherical, p (3), color (3)."""
    return torch.cat(
        [scene.light_is_spherical.to(torch.float32)[:, None],
         scene.light_p.to(torch.float32),
         scene.light_color.to(torch.float32)],
        dim=1,
    )


def _pack_camera(scene: Scene, camera: camera_ops.Camera, row0: int = 0) -> torch.Tensor:
    """[18] f32: rotation columns (9), eye (3), aspect*tanf, tanf, bg (3),
    row0. The camera frame is computed in f32, as the Pallas path does."""
    dev = scene.coefs.device
    rotation, eye = camera_ops.camera_frame(camera.to(torch.float32, dev))
    tanf = scene.tan_half_fov.to(torch.float32)
    return torch.cat([
        rotation.T.reshape(-1),  # columns flattened
        eye,
        (tanf * scene.aspect_ratio)[None],
        tanf[None],
        scene.bg_color.to(torch.float32),
        torch.full((1,), float(row0), dtype=torch.float32, device=dev),
    ])


def _dir_form_table(coefs: torch.Tensor, lights: torch.Tensor, n_cubic: int) -> torch.Tensor:
    """[L, N] frame constants for directional lights: entry (li, i) is the
    cubic form C_i(d_li) for cubic slots and the quadratic form Q_i(d_li) for
    quadric slots, d_li being the light's stored unit direction
    (lights[:, 1:4]). Rows of spherical lights are never read.

    The entries feed knife-edge occlusion sign tests, so they are computed in
    true f32: products and a sum, never a matrix product, so no TF32 or
    reduced-precision matmul setting can reach them (a bf16 version of this
    table flipped 499 penumbra pixels on 20spheres in the JAX package)."""
    comps = [lights[:, 1], lights[:, 2], lights[:, 3]]

    def mono(pows):
        out = None
        for axis in range(3):
            for _ in range(pows[axis]):
                out = comps[axis] if out is None else out * comps[axis]
        return out

    cub = torch.stack([mono(MONOMIAL_POWERS[m]) for m in range(QUAD_START)], dim=1)
    quad = torch.stack([mono(MONOMIAL_POWERS[m]) for m in range(QUAD_START, QUAD_START + 6)],
                       dim=1)
    c_tbl = (cub[:, None, :] * coefs[None, :, :QUAD_START]).sum(-1)
    q_tbl = (quad[:, None, :] * coefs[None, :, QUAD_START:QUAD_START + 6]).sum(-1)
    slot_cubic = torch.arange(coefs.shape[0], device=coefs.device) < n_cubic
    return torch.where(slot_cubic[None, :], c_tbl, q_tbl).contiguous()


def pack_frame(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int,
               *, polish_iters: int = 3, bounces: int | None = None,
               shadow_iters: int | None = None):
    """(tables, keyword arguments) of one ``render_fwd`` call for image rows
    [row0, row0 + rows), on the scene's device."""
    if bounces is None:
        bounces = scene.max_reflections if _memo(scene.reflection, _reflective) else 0
    if shadow_iters is None:
        shadow_iters = min(SHADOW_POLISH, polish_iters)
    shadow_iters = max(1, min(int(shadow_iters), polish_iters))
    _perm, n_cubic, _posdef = _statics_for(scene.coefs)
    gather, orig_index, posdef = _slot_tables(scene.coefs)
    scene32 = scene.astype(torch.float32)
    coefs = scene32.coefs.index_select(0, gather)
    lights = _pack_lights(scene32)
    tables = (
        coefs,
        orig_index,
        scene32.colors.index_select(0, gather),
        scene32.reflection.index_select(0, gather),
        lights,
        _dir_form_table(coefs, lights, n_cubic),
        posdef,
        _pack_camera(scene32, camera, row0),
    )
    kwargs = dict(width=scene.width, height=scene.height, rows=int(rows),
                  n_cubic=n_cubic, polish_iters=int(polish_iters),
                  shadow_iters=shadow_iters, screen_iters=SCREEN_ITERS,
                  bounces=int(bounces))
    return tables, kwargs


class PackedRender(torch.autograd.Function):
    """The differentiable render on packed tables: the forward launches
    ``render_fwd`` with ``save_aux``, the backward one ``render_bwd`` on that
    aux (the counterpart of ``_packed_render`` / ``_packed_fwd`` /
    ``_packed_bwd``).

    Inputs are the 8 tables of ``pack_frame`` and its keyword dict. The
    gradient goes to coefs, colors, refl, lights and cam; ``orig_index``,
    ``posdef`` and ``dir_table`` get none. ``dir_table`` feeds only the
    occlusion tests, which the JAX VJP never differentiates, so a gradient
    through it would be counted twice.
    """

    @staticmethod
    def forward(ctx, coefs, orig_index, colors, refl, lights, dir_table, posdef, cam, kwargs):
        image, *aux = render_fwd(coefs, orig_index, colors, refl, lights, dir_table, posdef,
                                 cam, **kwargs, save_aux=True)
        ctx.save_for_backward(coefs, colors, refl, lights, cam, *aux)
        ctx.kwargs = kwargs
        return image

    @staticmethod
    def backward(ctx, grad_image):
        coefs, colors, refl, lights, cam, *aux = ctx.saved_tensors
        kw = ctx.kwargs
        n_obj, n_lights = coefs.shape[0], lights.shape[0]
        vec = render_bwd(coefs, colors, refl, lights, cam,
                         grad_image.to(torch.float32).contiguous(), *aux,
                         width=kw["width"], height=kw["height"], rows=kw["rows"],
                         n_lights=n_lights, bounces=kw["bounces"])
        grads = split_grad(vec, n_obj, n_lights)
        # cam row 17 is the integer row offset and light column 0 the kind
        # flag: neither is a parameter (Pallas :2099-2109)
        grads["cam"][17] = 0.0
        grads["lights"][:, 0] = 0.0
        return (grads["coefs"], None, grads["colors"], grads["refl"], grads["lights"], None,
                None, grads["cam"], None)


def _wants_grad(scene: Scene, camera: camera_ops.Camera) -> bool:
    """Whether autograd would record the render: grad mode on and any
    differentiable scene or camera tensor requiring grad."""
    if not torch.is_grad_enabled():
        return False
    tensors = (scene.coefs, scene.colors, scene.reflection, scene.light_p,
               scene.light_color, scene.bg_color, scene.tan_half_fov,
               camera.position, camera.yaw_deg, camera.pitch_deg)
    return any(t.requires_grad for t in tensors)


def render_rows_kernel(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int,
                       *, polish_iters: int = 3, bounces: int | None = None,
                       shadow_iters: int | None = None) -> torch.Tensor:
    """Render image rows [row0, row0 + rows) -> [rows, W, 3] f32 on the
    scene's device, ``row0`` entering the kernel through cam[17] (the
    per-device body of a row-sharded render, ``render_rows_pallas``).

    Unlike the JAX entry, the scene statics are always derived from the
    tables: a torch tensor is never abstract. ``bounces=None`` runs the
    reflection chain to ``max_reflections`` when any object reflects.

    Differentiable when a scene or camera tensor requires grad (see
    ``PackedRender``); the gradients of row blocks sum to the frame's. The
    fused backward covers scenes with at least one object and at most 31
    lights (the i32 occlusion mask); a gradient of any other scene raises
    ``NotImplementedError``, while its forward renders as always.
    """
    wants_grad = _wants_grad(scene, camera)
    if wants_grad and not (scene.n_objects > 0 and scene.n_lights <= MAX_AUX_LIGHTS):
        raise NotImplementedError(
            f"render_rows_kernel: no gradient for a scene with {scene.n_objects} objects "
            f"and {scene.n_lights} lights: the fused backward needs at least one object "
            f"and at most {MAX_AUX_LIGHTS} lights; such gradients need the plain "
            "pipeline (ROADMAP Queue 1 item 6, the JAX package's _diff_bwd fallback), "
            "which is not ported yet")
    tables, kwargs = pack_frame(scene, camera, row0, rows, polish_iters=polish_iters,
                                bounces=bounces, shadow_iters=shadow_iters)
    if wants_grad:
        return PackedRender.apply(*tables, kwargs)
    return render_fwd(*tables, **kwargs)


def render_image_kernel(scene: Scene, camera: camera_ops.Camera | None = None,
                        polish_iters: int = 3, bounces: int | None = None,
                        shadow_iters: int | None = None) -> torch.Tensor:
    """Render a full frame -> [H, W, 3] f32 on the scene's device, row 0 at
    the bottom: the counterpart of ``render_image_pallas``, differentiable
    as ``render_rows_kernel`` is.

    ``camera`` defaults to the reference pose. ``shadow_iters`` sets the
    Newton steps of the shadow-occlusion solves, clamped to
    [1, polish_iters]; the default 1 is the Pallas kernel's.
    """
    if camera is None:
        camera = camera_ops.Camera.initial(torch.float32, scene.coefs.device)
    return render_rows_kernel(scene, camera, 0, scene.height,
                              polish_iters=polish_iters, bounces=bounces,
                              shadow_iters=shadow_iters)
