"""The yardstick of a kernel's share of its roofline: the chip's published
peaks and the least time of one call from the frozen count.

The least time of a call is the larger of its f32 operations over the peak
rate and its bytes over the memory rate. Operations and bytes come from the
frozen copy of the port's ``render/bounds.py`` (``reference/render/
bounds.py``: each pixel's work along the path that the frame's own aux
records, counted by running the plain versions' components under a dispatch
mode), fed by the frozen plain packing and plain forward
(``reference/render/packing.py``). So the count follows the frame's scene
and pose, and stays the same whatever implements the kernels.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates, at the card's full 700 W: f32
# outside the tensor cores, and HBM3.
PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_s(ops: float, n_bytes: float) -> float:
    return max(ops / PEAK_F32_OPS_PER_S, n_bytes / PEAK_BYTES_PER_S)


def frame_work(scene, camera, *, polish_iters: int, save_aux: bool) -> dict:
    """{"k1": least seconds of the forward kernel's call, "k2": of the
    backward's} for one frame of ``scene`` (a scene of the frozen copy) at
    ``camera``; ``save_aux`` is whether the forward writes its aux."""
    from .reference.render import bounds, packing

    tables, kw, aux = packing.fwd_aux(scene, camera, polish_iters=polish_iters)
    fwd = bounds.fwd_work(tables, kw, aux)
    bwd = bounds.bwd_work(tables, kw, aux)
    return {"k1": least_s(fwd["ops"], fwd["bytes_save_aux" if save_aux else "bytes"]),
            "k2": least_s(bwd["ops"], bwd["bytes"])}
