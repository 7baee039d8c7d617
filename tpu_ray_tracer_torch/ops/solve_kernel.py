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

``roots_excluding_pair`` is the same source's second entry, the root table
of the soft render's branch B on the card (``diff/soft.py``
``_raw_roots_excluding_pair`` dispatches to it; its plain version,
``_excluding_pair_plain``, lives there): the same expansion, seeds and
polish, another selection.
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
    _check_inputs("solve_roots", coefs, origin, dir)
    _check_device("solve_roots", coefs, origin, dir)
    batch, dims, o_comp, d_comp = solve_layout(origin, dir)
    out = torch.empty(batch + coefs.shape[:1], device=coefs.device,
                      dtype=torch.promote_types(coefs.dtype, origin.dtype))
    if out.numel():
        _launch("solve_roots", coefs, origin, dir, (), out, dims, o_comp, d_comp, polish_iters)
        solve_roots.launches += 1
    return out


solve_roots.launches = 0
launches.register("solve_roots", solve_roots, "launches")


def roots_excluding_pair(coefs: torch.Tensor, origin: torch.Tensor, dir: torch.Tensor,
                         polish_iters: int, kinds, t_normal: torch.Tensor) -> torch.Tensor:
    """The root table [..., N] of the soft render's branch B
    (``diff/soft.py`` ``_raw_roots_excluding_pair``, whose plain version is
    ``_excluding_pair_plain``) as one launch of ``csrc/solve_roots.cu``'s
    ``roots_excluding_pair_kernel`` on the current stream, counted in
    ``roots_excluding_pair.launches``. Takes what ``solve_roots`` takes on
    the card, and ``kinds``, None (each entry classed by |t3| > EPS) or the
    per-object cubic-class mask, a bool [N]; ``t_normal``, ``intersect_all``'s
    table for the same rays, [..., N] contiguous in the promoted dtype; all
    on one CUDA device. Raises on anything else, CPU tensors included."""
    name = "roots_excluding_pair"
    _check_inputs(name, coefs, origin, dir)
    batch, dims, o_comp, d_comp = solve_layout(origin, dir)
    shape, dtype = batch + coefs.shape[:1], torch.promote_types(coefs.dtype, origin.dtype)
    if t_normal.shape != shape or t_normal.dtype != dtype or not t_normal.is_contiguous():
        raise ValueError(f"{name}: t_normal must be {shape} {dtype}, contiguous, got "
                         f"{tuple(t_normal.shape)} {t_normal.dtype} with strides "
                         f"{t_normal.stride()}")
    if kinds is not None and (kinds.dtype != torch.bool or kinds.shape != coefs.shape[:1]):
        raise ValueError(f"{name}: kinds must be None or a bool [{coefs.shape[0]}], got "
                         f"{tuple(kinds.shape)} {kinds.dtype}")
    _check_device(name, coefs, origin, dir, t_normal,
                  *(() if kinds is None else (kinds,)))
    out = torch.empty(shape, dtype=dtype, device=coefs.device)
    if out.numel():
        extra = ((None, 0) if kinds is None else (kinds.data_ptr(), kinds.stride(0))) + (
            t_normal.data_ptr(),)
        _launch(name, coefs, origin, dir, extra, out, dims, o_comp, d_comp,
                max(1, int(polish_iters)))
        roots_excluding_pair.launches += 1
    return out


roots_excluding_pair.launches = 0
launches.register("roots_excluding_pair", roots_excluding_pair, "launches")


def _check_inputs(name, coefs, origin, dir):
    """Raise unless coefs is an f32 or f64 [N, 20] and origin and dir are
    both f32 or both f64."""
    floats = (torch.float32, torch.float64)
    if coefs.dtype not in floats or origin.dtype not in floats or dir.dtype != origin.dtype:
        raise ValueError(f"{name}: needs f32 or f64 coefs and origin and dir of one of those "
                         f"dtypes, got {[t.dtype for t in (coefs, origin, dir)]}")
    if coefs.dim() != 2 or coefs.shape[1] != 20:
        raise ValueError(f"{name}: coefs must be [N, 20], got {tuple(coefs.shape)}")


def _check_device(name, coefs, *tensors):
    """Raise unless every tensor lies on coefs' device, a CUDA one."""
    if coefs.device.type != "cuda" or any(t.device != coefs.device for t in tensors):
        raise ValueError(f"{name}: needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in (coefs, *tensors)]}")


def _launch(name, coefs, origin, dir, extra, out, dims, o_comp, d_comp, iters):
    """``trt_<name>(coefs, origin, dir, *extra, out, layout, ...)`` of the
    ``solve_roots`` library for ``solve_layout``'s dims and strides, on
    the current stream of out's device; raises if the launch fails."""
    n_obj = coefs.shape[0]
    layout = (ctypes.c_longlong * (3 * MAX_DIMS + 2))(
        *[size for size, _, _ in dims], *[0] * (MAX_DIMS - len(dims)),
        *[so for _, so, _ in dims], *[0] * (MAX_DIMS - len(dims)),
        *[sd for _, _, sd in dims], *[0] * (MAX_DIMS - len(dims)), o_comp, d_comp)
    lib = _build.load("solve_roots")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(lib, f"trt_{name}")(
            coefs.data_ptr(), origin.data_ptr(), dir.data_ptr(), *extra, out.data_ptr(), layout,
            len(dims), out.numel() // n_obj, n_obj, coefs.stride(0), coefs.stride(1),
            int(iters), int(coefs.dtype == torch.float64), int(origin.dtype == torch.float64),
            stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string('solve_roots', rc)})")


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

