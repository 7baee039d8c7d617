"""Row sharding of the frame across ranks.

Counterpart of ``tpu_ray_tracer/parallel/sharding.py``. The scaling model is
the JAX package's: the image's rows are split across ranks, every rank
renders its own row block, the scene is replicated, and the only traffic
between ranks is the gradient all-reduce of inverse rendering (and the
frame gather for host output). Where JAX runs one program over a device
mesh (``shard_map``), the port runs one process per device through
``torch.distributed``: NCCL between GPUs, gloo on the CPU (or wherever the
caller names it).

The rows are split only across the process group a caller passes (as the
JAX functions shard only over the mesh they are given): ``group=None`` is
one process with no collective, whether or not ``torch.distributed`` is
initialized. ``make_mesh`` describes the initialized world, and its
``group`` is what the callers pass. There is no compile cache: the JAX
package's exists only to avoid retracing, and nothing here is traced.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..models.scene import Scene, resolve_device
from ..ops import camera as camera_ops
from ..render.kernel_backend import _wants_grad, render_rows_kernel
from ..render.pipeline import RenderConfig, render_rays, resolve_bounces


def rank_and_size(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None (one process)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world as one rank sees it (the counterpart of the JAX package's
    1-D device mesh): this rank, the number of ranks, this rank's device and
    the process group of the collectives (None: one process)."""

    rank: int
    size: int
    device: torch.device
    group: object = None


def make_mesh(device=None, group=None) -> Mesh:
    """This rank's ``Mesh``: over ``group``, else over the default group
    where ``torch.distributed`` is initialized, else one process. ``device``
    defaults to ``cuda:LOCAL_RANK`` (a bare ``"cuda"`` reads the same) and
    raises without a CUDA device; the CPU is used only where the caller
    names it."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank, size = rank_and_size(group)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return Mesh(rank, size, resolve_device(device), group)


def padded_rows(height: int, n_devices: int) -> int:
    """Rows after padding so the row axis divides the mesh."""
    return -(-height // n_devices) * n_devices


def render_image_sharded(scene: Scene, camera: camera_ops.Camera | None = None,
                         config: RenderConfig = RenderConfig(), backend: str = "kernel",
                         group=None) -> torch.Tensor:
    """Render with rows split across the ranks of ``group`` (None: one
    process); returns the whole [H, W, 3] f32 frame on every rank, on the
    scene's device.

    Rank r renders rows [r * rows_local, (r + 1) * rows_local), rows_local =
    ``padded_rows(H, n) // n``, then the blocks are gathered and trimmed to
    the height. Every rank renders its full ``rows_local``, rows past the
    height included, so that every ``all_gather`` input has the same size.

    backend: ``"kernel"`` renders the block through ``render_rows_kernel``
    (row0 in cam[17]); ``"torch"`` through the plain pipeline
    (``pixel_directions(..., y0, rows)`` and ``render_rays``). ``camera``
    defaults to the reference pose.

    Forward only: the gather carries no gradient, so a call that would
    record one raises; the differentiable sharded path is the loss of
    ``diff/inverse.py``.
    """
    if backend not in ("kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if camera is None:
        camera = camera_ops.Camera.initial(torch.float32, scene.coefs.device)
    if _wants_grad(scene, camera):
        raise NotImplementedError(
            "render_image_sharded is forward-only (the gather carries no gradient); "
            "the row-sharded gradient is diff.inverse.make_loss_fn(problem, group).backward")
    rank, n = rank_and_size(group)
    rows_local = padded_rows(scene.height, n) // n
    y0 = rank * rows_local
    bounces = resolve_bounces(scene, config)
    if backend == "kernel":
        block = render_rows_kernel(scene, camera, y0, rows_local,
                                   polish_iters=config.polish_iters, bounces=bounces)
    else:
        scene = scene.astype(config.dtype)
        camera = camera.to(config.dtype, scene.coefs.device)
        rotation, eye = camera_ops.camera_frame(camera)
        dirs = camera_ops.pixel_directions(rotation, scene.width, scene.height,
                                           scene.aspect_ratio, scene.tan_half_fov,
                                           y0=y0, rows=rows_local)
        block = render_rays(scene, eye.expand(dirs.shape), dirs,
                            polish_iters=config.polish_iters, bounces=bounces)
    if group is None:
        return block[:scene.height]
    parts = [torch.empty_like(block) for _ in range(n)]
    dist.all_gather(parts, block.contiguous(), group=group)
    return torch.cat(parts)[:scene.height]


def _map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to every tensor of it: a tensor, a
    dataclass (``Scene``, ``Camera``), a dict, a list or a tuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def replicate(tree, group=None):
    """Every tensor of ``tree`` (a tensor, ``Scene``, ``Camera``, dict, list
    or tuple) broadcast from rank 0, so that all ranks hold rank 0's values;
    ``group=None`` (one process) returns ``tree`` as it is."""
    if group is None:
        return tree

    def broadcast(t):
        t = t.detach().clone().contiguous()
        dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
        return t

    return _map_tensors(broadcast, tree)


def shard_rows(array: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's row block of a padded [Hp, ...] tensor (axis 0 split
    evenly across the ranks; Hp from ``padded_rows``)."""
    rank, n = rank_and_size(group)
    if array.shape[0] % n:
        raise ValueError(f"shard_rows: {array.shape[0]} rows do not split across {n} ranks; "
                         "pad them to padded_rows(height, n)")
    rows = array.shape[0] // n
    return array[rank * rows:(rank + 1) * rows]
