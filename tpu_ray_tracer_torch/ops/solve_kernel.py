"""The pipeline's root solve, ``intersect_all``'s forward: for every (ray,
object) pair the ray parameter of the reference's selected root, as one
hand-written kernel on the card.

``solve_roots(coefs, origin, dir, polish_iters)`` returns the [..., N] root
table of ``_solve_plain``: the expansion of F(o + t d) into a cubic in t
(``poly.ray_poly_coeffs``), the reference's root selection
(``roots.min_positive_root``) and the Newton polish of its candidates
(``roots.make_newton_polisher``). On CPU tensors it is ``_solve_plain``.
On CUDA tensors it launches ``csrc/solve_roots.cu``, one thread per output
entry that keeps every intermediate in registers, or raises: eager torch
materialises each intermediate of the plain version (a shadow solve's are
[rays, lights, objects] each, broadcast), some 3,220 kernels a call.

The kernel replaces no Pallas kernel: it is the counterpart of XLA's fusion
of the JAX package's ``intersect_all`` (``tpu_ray_tracer/ops/intersect.py``).
It reads ``origin`` and ``dir`` through their broadcast strides
(``solve_layout``) and walks the expansion of ``ops.poly._EXPANSION`` as a
table written out in its source (tests/test_torch_solve_roots.py generates
the table's rows and holds the source to them).
"""

from __future__ import annotations

import ctypes

import torch

from ..render import _build
from ..utils import launches
from .poly import ray_poly_coeffs
from .roots import make_newton_polisher, min_positive_root

# Batch dimensions the kernel decomposes a ray's index into, after
# ``solve_layout`` has dropped the unit ones and merged the rest.
MAX_DIMS = 6


def _solve_plain(coefs, origin, dir, polish_iters):
    """The root table [..., N] in plain PyTorch: the expansion, the
    selection and the polish, one tensor operation at a time."""
    # the coefficients pass straight in, so that the solve can drop them
    # once spent
    return min_positive_root(*ray_poly_coeffs(coefs, origin, dir),
                             make_newton_polisher(coefs, origin, dir, polish_iters))


def solve_roots(coefs: torch.Tensor, origin: torch.Tensor, dir: torch.Tensor,
                polish_iters: int) -> torch.Tensor:
    """The root table [..., N] of ``_solve_plain`` for coefs [N, 20] and
    origin, dir [..., 3] (broadcast against each other), in torch's
    promotion of their dtypes. CPU tensors take ``_solve_plain``; CUDA
    tensors launch the kernel (counted in ``solve_roots.launches``) on the
    current stream, and must lie on one device, coefs f32 or f64 and origin
    and dir both f32 or both f64, or it raises."""
    if all(t.device.type == "cpu" for t in (coefs, origin, dir)):
        return _solve_plain(coefs, origin, dir, polish_iters)
    floats = (torch.float32, torch.float64)
    if (coefs.dtype not in floats or origin.dtype not in floats or dir.dtype != origin.dtype
            or coefs.device.type != "cuda"
            or any(t.device != coefs.device for t in (origin, dir))):
        raise ValueError(f"solve_roots: needs f32 or f64 coefs and origin and dir of one of "
                         f"those dtypes, on one CUDA device, got "
                         f"{[(t.dtype, str(t.device)) for t in (coefs, origin, dir)]}")
    if coefs.dim() != 2 or coefs.shape[1] != 20:
        raise ValueError(f"solve_roots: coefs must be [N, 20], got {tuple(coefs.shape)}")
    batch, dims, o_comp, d_comp = solve_layout(origin, dir)
    n_obj, device = coefs.shape[0], coefs.device
    out = torch.empty(batch + (n_obj,), dtype=torch.promote_types(coefs.dtype, origin.dtype),
                      device=device)
    if out.numel() == 0:
        return out
    layout = (ctypes.c_longlong * (3 * MAX_DIMS + 2))(
        *[size for size, _, _ in dims], *[0] * (MAX_DIMS - len(dims)),
        *[so for _, so, _ in dims], *[0] * (MAX_DIMS - len(dims)),
        *[sd for _, _, sd in dims], *[0] * (MAX_DIMS - len(dims)), o_comp, d_comp)
    lib = _build.load("solve_roots")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.trt_solve_roots(coefs.data_ptr(), origin.data_ptr(), dir.data_ptr(),
                                 out.data_ptr(), layout, len(dims), out.numel() // n_obj,
                                 n_obj, coefs.stride(0), coefs.stride(1), int(polish_iters),
                                 int(coefs.dtype == torch.float64),
                                 int(origin.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"solve_roots: kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string('solve_roots', rc)})")
    solve_roots.launches += 1
    return out


solve_roots.launches = 0
launches.register("solve_roots", solve_roots, "launches")


def solve_layout(origin: torch.Tensor, dir: torch.Tensor):
    """(batch, dims, origin's xyz stride, dir's xyz stride) of the kernel's
    reads: ``batch`` the broadcast of the two leading shapes; ``dims`` the
    batch dimensions as (size, origin's element stride, dir's element
    stride), outermost first, 0 where a tensor is broadcast, with unit
    dimensions dropped and neighbours that both tensors step through
    evenly merged. Ray ``r`` of the row-major batch reads origin component
    ``a`` at ``sum_i digit_i * origin_stride_i + a * o_comp`` from
    ``origin.data_ptr()``, ``digit_i`` the digits of ``r`` in the sizes of
    ``dims`` (likewise dir)."""
    if origin.shape[-1:] != (3,) or dir.shape[-1:] != (3,):
        raise ValueError(f"solve_roots: origin and dir must be [..., 3], got "
                         f"{tuple(origin.shape)} and {tuple(dir.shape)}")
    batch = tuple(torch.broadcast_shapes(origin.shape[:-1], dir.shape[:-1]))

    def strides(t):
        lead = len(batch) - (t.dim() - 1)
        return [0] * lead + [s if n != 1 else 0 for n, s in zip(t.shape[:-1], t.stride()[:-1])]

    dims = []
    for size, so, sd in zip(batch, strides(origin), strides(dir)):
        if size == 1:
            continue
        if dims and dims[-1][1] == so * size and dims[-1][2] == sd * size:
            dims[-1] = (dims[-1][0] * size, so, sd)
        else:
            dims.append((size, so, sd))
    if len(dims) > MAX_DIMS:
        raise ValueError(f"solve_roots: the batch of {tuple(origin.shape)} and "
                         f"{tuple(dir.shape)} needs {len(dims)} dimensions, more than "
                         f"{MAX_DIMS}")
    return batch, dims, origin.stride(-1), dir.stride(-1)

