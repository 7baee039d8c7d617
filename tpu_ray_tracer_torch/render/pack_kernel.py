"""A frame's table packing and its VJP: their launch wrappers and their plain
PyTorch versions.

``pack_tables`` writes the 8 tables of one ``render_fwd`` call from the
scene's and the camera's own tensors: the f32 casts, the cubics-first slot
gather of the coefficients, colours and reflection ratios (through the
memoised gather index), orig_index and posdef, the light table
(``_pack_lights``), the direction-form table (``_dir_form_table``) and the
camera table (``_pack_camera``). ``pack_vjp`` maps ``render_bwd``'s gradient
vector (``bwd_kernel.split_grad``'s layout) to the gradients of the scene's
and camera's tensors (``GRAD_FIELDS``): it un-permutes the slot rows, leaves
out cam row 17 (the row offset) and light column 0 (the kind flag), which
are no parameter (``PackedRender.backward`` zeroes them, as ``_packed_bwd``
does, tpu_ray_tracer/render/pallas_backend.py:2100-2109), and takes the
rotation's rows back through the camera frame in closed form.

On CUDA tensors each launches one kernel of ``csrc/pack.cu``; on CPU tensors
each runs its plain version. They replace no Pallas kernel: they are the
counterpart of the XLA fusions that ``jax.jit`` makes of the packing in
``_render_pallas_jit`` (pallas_backend.py:1464-1478, ``_pack_lights`` :1177,
``_pack_camera`` :1190, ``_dir_form_table`` :1139) and of its VJP after
``_packed_bwd`` (:2073-2118).

``pack_tables_plain``'s tables are the kernel's bit for bit on the card
(the kernel rounds each operation as torch's CUDA ops do and sums in their
order). ``pack_vjp_plain`` is the kernel's closed form written with torch
ops; its camera gradients round differently from autograd through
``pack_tables_plain`` (tests/test_torch_pack.py states the tolerance).
"""

from __future__ import annotations

import math

import torch

from ..models.scene import Scene
from ..models.surface import MONOMIAL_POWERS, N_COEFS
from ..ops import camera as camera_ops
from ..utils import launches
from . import _build
from .bwd_kernel import split_grad
from .fwd_kernel import QUAD_START

# The scene's and the camera's differentiable tensors, in the order of
# ``pack_vjp``'s gradients.
SCENE_GRAD_FIELDS = ("coefs", "colors", "reflection", "light_p", "light_color", "bg_color",
                     "tan_half_fov")
CAMERA_FIELDS = ("position", "yaw_deg", "pitch_deg")
GRAD_FIELDS = SCENE_GRAD_FIELDS + CAMERA_FIELDS


def grad_tensors(scene: Scene, camera: camera_ops.Camera) -> tuple:
    """``GRAD_FIELDS``' tensors of a scene and a camera."""
    return (*(getattr(scene, f) for f in SCENE_GRAD_FIELDS),
            *(getattr(camera, f) for f in CAMERA_FIELDS))


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


def pack_tables_plain(scene: Scene, camera: camera_ops.Camera, slots, *, n_cubic: int,
                      row0: int) -> tuple:
    """Plain PyTorch version of the kernel: (coefs, orig_index, colors,
    refl, lights, dir_table, posdef, cam), ``render_fwd``'s tables in its
    order. ``slots`` is (gather index, orig_index, posdef), the slot tables
    of the statics (``kernel_backend._slot_tables``); orig_index and posdef
    are returned as they are. Differentiable through torch's autograd."""
    gather, orig_index, posdef = slots
    scene32 = scene.astype(torch.float32)
    coefs = scene32.coefs.index_select(0, gather)
    lights = _pack_lights(scene32)
    return (
        coefs,
        orig_index,
        scene32.colors.index_select(0, gather),
        scene32.reflection.index_select(0, gather),
        lights,
        _dir_form_table(coefs, lights, n_cubic),
        posdef,
        _pack_camera(scene32, camera, row0),
    )


def _float_inputs(scene: Scene, camera: camera_ops.Camera) -> tuple:
    """``trt_pack_frame``'s float inputs, in its order."""
    return (scene.coefs, scene.colors, scene.reflection, scene.light_p, scene.light_color,
            scene.bg_color, scene.tan_half_fov, camera.position, camera.yaw_deg,
            camera.pitch_deg)


def _check_inputs(what: str, scene: Scene, camera: camera_ops.Camera, device) -> None:
    """Raise unless the scene's and camera's tensors are contiguous, f32 or
    f64 (the light kinds bool), of the scene's shapes and on ``device``."""
    n_obj, n_lights = scene.coefs.shape[0], scene.light_p.shape[0]
    shapes = {"coefs": (n_obj, N_COEFS), "colors": (n_obj, 3), "reflection": (n_obj,),
              "light_p": (n_lights, 3), "light_color": (n_lights, 3), "bg_color": (3,),
              "tan_half_fov": (), "position": (3,), "yaw_deg": (), "pitch_deg": ()}
    for (name, shape), t in zip(shapes.items(), _float_inputs(scene, camera)):
        if t.device != device or t.dtype not in (torch.float32, torch.float64) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous f32 or f64 tensor on "
                             f"{device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    kinds = scene.light_is_spherical
    if kinds.device != device or kinds.dtype != torch.bool or tuple(kinds.shape) != (n_lights,) \
            or not kinds.is_contiguous():
        raise ValueError(f"{what}: light_is_spherical must be a contiguous bool tensor of "
                         f"shape ({n_lights},) on {device}")


def _check_index(what: str, name: str, t: torch.Tensor, dtype, n: int, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor of shape ({n},) "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _f64_mask(tensors) -> int:
    return sum(1 << i for i, t in enumerate(tensors) if t.dtype == torch.float64)


def pack_tables(scene: Scene, camera: camera_ops.Camera, slots, *, n_cubic: int,
                row0: int) -> tuple:
    """``render_fwd``'s 8 tables for image rows from ``row0`` (see
    ``pack_tables_plain``), from the scene's and camera's own tensors.

    CUDA tensors launch the kernel of ``csrc/pack.cu`` on the current stream
    (and count the launch in ``pack_tables.launches``); its tables are fresh
    tensors. CPU tensors run ``pack_tables_plain``. Tensors on any other
    device raise."""
    device = scene.coefs.device
    if device.type == "cpu":
        return pack_tables_plain(scene, camera, slots, n_cubic=n_cubic, row0=row0)
    if device.type != "cuda":
        raise ValueError(f"pack_tables: no kernel for device {device}")
    _check_inputs("pack_tables", scene, camera, device)
    gather, _, posdef = slots
    n_obj, n_lights = scene.coefs.shape[0], scene.light_p.shape[0]
    _check_index("pack_tables", "the gather index", gather, torch.int64, n_obj, device)
    _check_index("pack_tables", "posdef", posdef, torch.int32, n_obj, device)
    if not 0 <= n_cubic <= n_obj:
        raise ValueError(f"pack_tables: n_cubic={n_cubic} outside [0, {n_obj}]")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    out = (empty(n_obj, N_COEFS), empty(n_obj, dtype=torch.int32), empty(n_obj, 3),
           empty(n_obj), empty(n_lights, 7), empty(n_lights, n_obj),
           empty(n_obj, dtype=torch.int32), empty(18))
    floats = _float_inputs(scene, camera)
    lib = _build.load("pack")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.trt_pack_frame(
            *(t.data_ptr() for t in floats), scene.light_is_spherical.data_ptr(),
            gather.data_ptr(), posdef.data_ptr(), _f64_mask(floats),
            *(t.data_ptr() for t in out), n_obj, n_cubic, n_lights, scene.aspect_ratio,
            int(row0), stream)
    if rc != 0:
        raise RuntimeError(f"pack_tables: kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string('pack', rc)})")
    pack_tables.launches += 1
    return out


pack_tables.launches = 0
launches.register("pack_frame", pack_tables, "launches")


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cross(a, b) of [3] vectors, each product and difference its own op."""
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _norm_vjp(g: torch.Tensor, v: torch.Tensor, unit: torch.Tensor, r: torch.Tensor):
    """The cotangent of v from that of unit = v / r, r = sqrt(v . v), as
    autograd takes the two ops back: g / r to v, -sum(g * (unit / r)) to r,
    and d sqrt(q) = dr / (2 r), the sum left to right."""
    terms = g * (unit / r)
    dq = -(terms[0] + terms[1] + terms[2]) / (r * 2.0)
    return g / r + (v * dq) * 2.0


def camera_vjp_plain(grad_cam: torch.Tensor, yaw_deg: torch.Tensor,
                     pitch_deg: torch.Tensor) -> tuple:
    """(d yaw_deg, d pitch_deg) in f32 from the gradients of cam rows 0-8
    (the rotation columns s, u and -f of ``ops.camera.camera_frame``), in
    closed form through u = cross(s, f), s = normalize(cross(f, up)),
    f = normalize(-d) and d(yaw, pitch): the arithmetic of
    ``pack_vjp_kernel``'s ``camera_vjp``."""
    yaw = camera_ops._deg2rad(yaw_deg.to(torch.float32))
    pitch = camera_ops._deg2rad(pitch_deg.to(torch.float32))
    cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
    # the forward's frame, as camera_frame computes it
    nd = -camera_ops.view_direction(yaw_deg.to(torch.float32), pitch_deg.to(torch.float32))
    r1 = torch.sqrt((nd * nd).sum(-1))
    f = nd / r1
    up = torch.zeros(3, dtype=torch.float32, device=nd.device)
    up.narrow(0, 1, 1).fill_(1.0)
    c = torch.linalg.cross(f, up)
    r2 = torch.sqrt((c * c).sum(-1))
    s = c / r2
    gs, gu, gf = grad_cam[0:3], grad_cam[3:6], -grad_cam[6:9]
    gs = gs + _cross(f, gu)  # u = cross(s, f)
    gf = gf + _cross(gu, s)
    gc = _norm_vjp(gs, c, s, r2)
    # c = cross(f, up): cross(up, gc) = (gc2, 0, -gc0) to f
    gf = torch.stack([gf[0] + gc[2], gf[1], gf[2] - gc[0]])
    gd = -_norm_vjp(gf, nd, f, r1)
    a, b = gd[0] * cp, gd[2] * cp
    g_yaw = b * cy - a * sy
    g_pitch = gd[1] * cp - (gd[0] * cy + gd[2] * sy) * sp
    return g_yaw * (math.pi / 180.0), g_pitch * (math.pi / 180.0)


def pack_vjp_plain(grad_vec: torch.Tensor, gather: torch.Tensor, scene: Scene,
                   camera: camera_ops.Camera, *, wanted=None) -> list:
    """Plain PyTorch version of the kernel: the gradients of ``GRAD_FIELDS``'
    tensors of ``scene`` and ``camera`` (each in its tensor's dtype and
    shape; None where ``wanted`` is false) from ``render_bwd``'s gradient
    vector of the frame packed from them."""
    n_obj, n_lights = scene.coefs.shape[0], scene.light_p.shape[0]
    leaves = grad_tensors(scene, camera)
    wanted = (True,) * len(leaves) if wanted is None else tuple(wanted)
    g = split_grad(grad_vec, n_obj, n_lights)

    def slot_order_back(rows):
        return torch.empty_like(rows).index_copy_(0, gather, rows)

    cam = g["cam"]
    angles = []

    def angle(i):
        if not angles:
            angles.extend(camera_vjp_plain(cam, camera.yaw_deg, camera.pitch_deg))
        return angles[i]

    makers = (
        lambda: slot_order_back(g["coefs"]),
        lambda: slot_order_back(g["colors"]),
        lambda: slot_order_back(g["refl"]),
        lambda: g["lights"][:, 1:4],
        lambda: g["lights"][:, 4:7],
        lambda: cam[14:17],
        # cam[12] = tanf * aspect, cam[13] = tanf
        lambda: cam[12] * scene.aspect_ratio + cam[13],
        lambda: cam[9:12],
        lambda: angle(0),
        lambda: angle(1),
    )
    return [make().to(t.dtype).reshape(t.shape).contiguous() if w else None
            for make, t, w in zip(makers, leaves, wanted)]


def pack_vjp(grad_vec: torch.Tensor, gather: torch.Tensor, scene: Scene,
             camera: camera_ops.Camera, *, wanted=None) -> list:
    """The gradients of ``GRAD_FIELDS``' tensors of ``scene`` and ``camera``
    from ``render_bwd``'s gradient vector of the frame ``pack_tables``
    packed from them (see ``pack_vjp_plain``).

    CUDA tensors launch the kernel of ``csrc/pack.cu`` on the current stream
    (and count the launch in ``pack_vjp.launches``); one launch writes every
    wanted gradient. CPU tensors run ``pack_vjp_plain``. Tensors on any
    other device raise."""
    device = grad_vec.device
    if device.type == "cpu":
        return pack_vjp_plain(grad_vec, gather, scene, camera, wanted=wanted)
    if device.type != "cuda":
        raise ValueError(f"pack_vjp: no kernel for device {device}")
    _check_inputs("pack_vjp", scene, camera, device)
    n_obj, n_lights = scene.coefs.shape[0], scene.light_p.shape[0]
    total = 18 + (N_COEFS + 4) * n_obj + 7 * n_lights
    if grad_vec.dtype != torch.float32 or tuple(grad_vec.shape) != (total,) \
            or not grad_vec.is_contiguous():
        raise ValueError(f"pack_vjp: the gradient vector must be a contiguous f32 tensor of "
                         f"shape ({total},), got {grad_vec.dtype} {tuple(grad_vec.shape)}")
    _check_index("pack_vjp", "the gather index", gather, torch.int64, n_obj, device)
    leaves = grad_tensors(scene, camera)
    wanted = (True,) * len(leaves) if wanted is None else tuple(wanted)
    out = [torch.empty(t.shape, dtype=t.dtype, device=device) if w else None
           for t, w in zip(leaves, wanted)]
    angles = (camera.yaw_deg, camera.pitch_deg)
    lib = _build.load("pack")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.trt_pack_vjp(
            grad_vec.data_ptr(), gather.data_ptr(), *(t.data_ptr() for t in angles),
            _f64_mask(angles), *(None if g is None else g.data_ptr() for g in out),
            _f64_mask(leaves), n_obj, n_lights, scene.aspect_ratio, stream)
    if rc != 0:
        raise RuntimeError(f"pack_vjp: kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string('pack', rc)})")
    pack_vjp.launches += 1
    return out


pack_vjp.launches = 0
launches.register("pack_vjp", pack_vjp, "launches")
