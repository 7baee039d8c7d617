"""The host half of a kernel frame, frozen: what ``render/kernel_backend.py``
of the port derives on the host before it packs a frame (the cubics-first
slot order, posdef, the iteration counts), then ``pack_tables_plain``.

With ``fwd_aux`` it gives the tables, the kernel's keyword arguments and the
forward's aux (``render_fwd_plain(..., save_aux=True)``) of one frame, which
``render/bounds.py``'s ``fwd_work`` and ``bwd_work`` read: the work of a
frame, whatever implements the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.scene import Scene
from ..ops import camera as camera_ops
from .fwd_kernel import QUAD_START, render_fwd_plain
from .pack_kernel import pack_tables_plain

# the Pallas kernel's defaults, as the port's kernel_backend fixes them
SHADOW_POLISH = 1
SCREEN_ITERS = 3


def degree_partition(coefs: np.ndarray):
    """(perm, n_cubic): cubic objects first, stable within each class."""
    is_cubic = (np.abs(coefs[:, :QUAD_START]) > 0).any(axis=1)
    return np.argsort(~is_cubic, kind="stable").astype(np.int32), int(is_cubic.sum())


def quad_posdef(coefs: np.ndarray) -> np.ndarray:
    """Per-object positive definiteness of the quadratic form (Sylvester)."""
    cc = np.asarray(coefs, np.float64)
    a, b, c = cc[:, 10], cc[:, 11], cc[:, 12]
    d, e, f = cc[:, 13] / 2, cc[:, 14] / 2, cc[:, 15] / 2
    m2 = a * b - d * d
    m3 = a * (b * c - f * f) - d * (d * c - f * e) + e * (d * f - b * e)
    return (a > 0) & (m2 > 0) & (m3 > 0)


def pack(scene: Scene, camera: camera_ops.Camera, *, polish_iters: int, bounces: int | None = None,
         row0: int = 0, rows: int | None = None):
    """(tables, kwargs) of one kernel call for rows [row0, row0 + rows)."""
    cc = scene.coefs.detach().cpu().numpy()
    perm, n_cubic = degree_partition(cc)
    posdef = quad_posdef(cc)[perm]
    dev = scene.coefs.device
    slots = (torch.tensor(perm, dtype=torch.int64, device=dev),
             torch.tensor(perm, dtype=torch.int32, device=dev),
             torch.tensor(posdef.astype(np.int32), device=dev))
    if bounces is None:
        reflective = scene.reflection.numel() > 0 and float(scene.reflection.max()) > 1e-7
        bounces = scene.max_reflections if reflective else 0
    camera = camera_ops.Camera(*(t.detach().to(dev) for t in
                                 (camera.position, camera.yaw_deg, camera.pitch_deg)))
    with torch.no_grad():
        tables = pack_tables_plain(scene, camera, slots, n_cubic=n_cubic, row0=row0)
    kw = dict(width=scene.width, height=scene.height,
              rows=scene.height if rows is None else rows, n_cubic=n_cubic,
              polish_iters=polish_iters, shadow_iters=max(1, min(SHADOW_POLISH, polish_iters)),
              screen_iters=SCREEN_ITERS, bounces=int(bounces))
    return tables, kw


def fwd_aux(scene: Scene, camera: camera_ops.Camera, *, polish_iters: int):
    """(tables, kwargs, aux) of a whole frame: the aux the plain forward
    records, as ``render_fwd(..., save_aux=True)`` does."""
    tables, kw = pack(scene, camera, polish_iters=polish_iters)
    with torch.no_grad():
        _, *aux = render_fwd_plain(*tables, **kw, save_aux=True)
    return tables, kw, tuple(aux)
