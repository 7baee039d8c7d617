"""A frame's table packing: the plain PyTorch version of the port's packing
kernel.

``pack_tables_plain`` writes the 8 tables of one ``render_fwd`` call from the
scene's and the camera's own tensors: the f32 casts, the cubics-first slot
gather of the coefficients, colours and reflection ratios, orig_index and
posdef, the light table (``_pack_lights``), the direction-form table
(``_dir_form_table``) and the camera table (``_pack_camera``): the
counterpart of the XLA fusions that ``jax.jit`` makes of the packing in
``_render_pallas_jit`` (tpu_ray_tracer/render/pallas_backend.py:1464-1478,
``_pack_lights`` :1177, ``_pack_camera`` :1190, ``_dir_form_table`` :1139).
Its tables are the port's kernel's bit for bit on the card.
"""

from __future__ import annotations

import torch

from ..models.scene import Scene
from ..models.surface import MONOMIAL_POWERS
from ..ops import camera as camera_ops
from .fwd_kernel import QUAD_START

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
