"""Multi-process initialization and the world's row bookkeeping.

Counterpart of ``tpu_ray_tracer/parallel/multihost.py``. A job is one process
per device, started by ``torchrun`` (``python -m torch.distributed.run``),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; ``initialize_distributed`` brings up the process group
from them. Scene tables stay replicated; the only traffic between ranks is
the inverse renderer's gradient all-reduce. A single-process run needs none
of this: every helper then describes a world of one.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.scene import resolve_device
from .sharding import make_mesh, rank_and_size


def initialize_distributed(backend: str | None = None, device=None, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None,
                           timeout=None) -> bool:
    """Initialize ``torch.distributed`` when the job has more than one
    process; a world of one is a no-op. Returns whether it initialized.

    The arguments default from torchrun's environment (``WORLD_SIZE``,
    ``RANK``; ``init_method`` ``env://`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). ``device`` is this rank's device, ``cuda`` by default:
    a CUDA device becomes ``cuda:LOCAL_RANK`` and the current device, and
    raises where there is none. ``backend`` defaults to NCCL on CUDA and
    gloo on the CPU. ``timeout`` (a ``timedelta``) bounds every collective.
    """
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0")) if device.index is None else device.index
        device = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank if rank is not None else int(os.environ["RANK"]), **kwargs)
    return True


def global_pixel_mesh(device=None, group=None) -> list:
    """The device of every rank in the job, in rank order (the row order of
    the sharded frame); ``device`` is this rank's, as ``make_mesh`` takes
    it."""
    mesh = make_mesh(device, group)
    if mesh.group is None:
        return [mesh.device]
    names = [None] * mesh.size
    dist.all_gather_object(names, str(mesh.device), group=mesh.group)
    return [torch.device(n) for n in names]


def _row_span(height: int, device_process_ids, pid: int):
    """Pure core of ``host_local_rows``: (start_row, n_rows) for the process
    ``pid`` given the mesh's flat device->process assignment. Requires the
    process's devices to be contiguous in mesh order (true for
    ``jax.devices()``, which sorts by process); raises otherwise rather than
    silently returning a wrong span."""
    ids = np.flatnonzero(np.asarray(device_process_ids) == pid)
    if ids.size == 0:
        return 0, 0
    if ids[-1] - ids[0] != ids.size - 1:
        raise ValueError(
            f"process {pid}'s devices are not contiguous in mesh order: "
            f"positions {ids.tolist()}"
        )
    n_dev = len(device_process_ids)
    rows_per_dev = -(-height // n_dev)
    start = int(ids[0]) * rows_per_dev
    n_rows = int(ids.size) * rows_per_dev
    start = min(start, height)
    return start, max(0, min(n_rows, height - start))


def host_local_rows(height: int, group=None):
    """(start_row, n_rows) of this process's contiguous row span — useful
    for host-side IO (e.g. each host writes its strip of the framebuffer).
    Each rank drives one device, so rank r holds mesh position r;
    ``group=None`` is one process (a ``Mesh``'s ``group`` is the world's)."""
    rank, size = rank_and_size(group)
    return _row_span(height, list(range(size)), rank)
