"""The pipeline's per-ray gather of a per-object table, ``table[idx]``, and
its backward.

``select_rows(table, idx)`` returns ``table[idx]``: the rows (coefficients,
colours, reflection ratios) of each ray's object. Its backward sums the
gradient rows of every ray into its object's row. Autograd's own backward of
``table[idx]`` on the card is aten's ``index_put_(accumulate=True)``, which
sorts the indices and sums each run of equal indices serially, so a scene
whose rays mostly hit one object sums hundreds of thousands of rows in one
thread group one after another. On a CUDA table whose gradient autograd
records, ``select_rows`` is an ``autograd.Function`` whose forward is still
``table[idx]`` (the same bits) and whose backward launches the two kernels
of ``csrc/select_rows.cu``: a deterministic blocked reduction with no
atomics, so a replayed graph gives the eager call's bits. Everywhere else
(CPU tables, no gradient recorded) it is ``table[idx]`` itself, and autograd
differentiates it as before.

The kernels replace no Pallas kernel: they are the counterpart of the
scatter-add that XLA emits for the transpose of the JAX pipeline's gathers
(``tpu_ray_tracer/render/pipeline.py:93``, ``:95``, ``:150``, ``:187``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from ..utils import launches
from . import _build

# Where the kernel keeps each warp's sums: shared memory, or global scratch
# where they do not fit (``csrc/select_rows.cu``).
PLACEMENTS = ("shared", "global")


def select_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` -> [*idx.shape, *table.shape[1:]], differentiable in
    ``table``. On a CUDA ``table`` that requires grad, with grad mode on, the
    backward is ``select_rows_bwd``'s kernels (and counts in
    ``select_rows.launches``); there ``table`` must be f32 or f64 and
    ``idx`` an int64 tensor on its device, or it raises."""
    if table.device.type != "cuda" or not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    _check("select_rows", table, idx)
    return _SelectRows.apply(table, idx)


def _check(what: str, values: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise unless ``values`` (the table or the gradient) is an f32 or f64
    CUDA tensor and ``idx`` an int64 tensor on its device."""
    if values.dtype not in (torch.float32, torch.float64) or values.device.type != "cuda":
        raise ValueError(f"{what}: needs f32 or f64 CUDA values, got {values.dtype} on "
                         f"{values.device}")
    if idx.dtype != torch.int64 or idx.device != values.device:
        raise ValueError(f"{what}: idx must be an int64 tensor on {values.device}, got "
                         f"{idx.dtype} on {idx.device}")


select_rows.launches = 0
launches.register("select_rows", select_rows, "launches")


class _SelectRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return select_rows_bwd(grad, idx, ctx.table_shape), None


def select_plan(rows: int, n: int, c: int, dtype: torch.dtype):
    """(placement, blocks, values of scratch) of the backward's launch for
    ``rows`` gradient rows of an [n, c] table of ``dtype`` on the current
    CUDA device, as the launcher plans it: the warp sums in shared memory
    where they fit, one resident wave of blocks or fewer for a small input.
    Planned once per device and shape."""
    return _plan(torch.cuda.current_device(), rows, n, c, dtype == torch.float64)


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, rows: int, n: int, c: int, f64: bool):
    lib = _build.load("select_rows")
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device_index):
        rc = lib.trt_select_rows_plan(rows, n, c, int(f64), out)
    if rc != 0:
        raise RuntimeError(f"select_rows: no launch for {rows} rows of a [{n}, {c}] table: "
                           f"CUDA error {rc} ({_build.error_string('select_rows', rc)})")
    return PLACEMENTS[out[0]], int(out[1]), int(out[2])


def select_rows_bwd(grad: torch.Tensor, idx: torch.Tensor, table_shape) -> torch.Tensor:
    """The gradient of a table of ``table_shape`` from the gradient ``grad``
    of ``table[idx]``: each gradient row summed into its index's row, by the
    kernels of ``csrc/select_rows.cu`` on the current stream, in a fixed
    order (the same bits at every call)."""
    n, c = table_shape[0], math.prod(table_shape[1:])
    _check("select_rows_bwd", grad, idx)
    device = grad.device
    grad = grad.contiguous()
    if grad.data_ptr() % 16:  # the kernel loads 16-byte vectors; a fresh tensor is aligned
        grad = grad.clone()
    idx = idx.reshape(-1)
    rows = idx.numel()
    if grad.numel() != rows * c:
        raise ValueError(f"select_rows_bwd: the gradient has shape {tuple(grad.shape)} for "
                         f"{rows} rows of {c} values")
    out = torch.empty(table_shape, dtype=grad.dtype, device=device)
    if rows == 0 or n * c == 0:
        return out.zero_()
    lib = _build.load("select_rows")
    with torch.cuda.device(device):
        placement, blocks, n_scratch = select_plan(rows, n, c, grad.dtype)
        scratch = torch.empty(n_scratch, dtype=grad.dtype, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.trt_select_rows_bwd(grad.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                                     out.data_ptr(), rows, n, c,
                                     int(grad.dtype == torch.float64),
                                     PLACEMENTS.index(placement), blocks, stream)
    if rc != 0:
        raise RuntimeError(f"select_rows_bwd: kernel launch ({placement}) failed: CUDA error "
                           f"{rc} ({_build.error_string('select_rows', rc)})")
    select_rows.launches += 1
    return out
