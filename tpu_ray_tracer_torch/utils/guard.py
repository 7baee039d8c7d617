"""Device-side error surface: the ``checkCudaErrors`` analog.

Counterpart of ``tpu_ray_tracer/utils/guard.py``. The reference wraps every
CUDA call in ``checkCudaErrors``/``getLastCudaError`` which print
``file:line code(name) "expr"`` and terminate
(reference: include/helper_cuda_opengl.h:13-44). The port's kernel wrappers
raise on a launch error code already; the failure that remains is numeric:
non-finite pixels escaping the masked-lane arithmetic. This module gives
that failure a first-class, opt-in surface:

* ``checked(render_fn)`` — wraps a render function so the non-finite test
  runs on the image's device (one reduction, one boolean read back),
  raising ``RenderCheckError`` at the call site when it trips. The contract
  is on the OUTPUT: the render paths produce inf/NaN in masked lanes by
  design (e.g. background falloff at t = 0).
* ``check_image(image)`` — host-side: locates the offending pixels and
  raises ``RenderCheckError`` listing their (row, col) indices and values,
  the debugging detail the reference's print-and-exit never had.

Wired into the CLI as ``render --check`` (print error and exit nonzero,
mirroring the reference's error path at src/ray-tracer.cpp:151-158).
"""

from __future__ import annotations

import numpy as np
import torch


class RenderCheckError(RuntimeError):
    """Non-finite pixels (or a failed device-side check) in a render."""


def checked(render_fn):
    """Wrap ``(*args) -> image tensor`` with a finiteness check on the
    image's device. Returns a callable with the same signature that raises
    ``RenderCheckError`` when the rendered image contains non-finite values.
    """

    def wrapper(*args, **kwargs):
        image = render_fn(*args, **kwargs)
        if not bool(torch.isfinite(image).all()):
            raise RenderCheckError("non-finite pixels in render output")
        return image

    return wrapper


def find_nonfinite(image):
    """(row, col) indices of pixels with any non-finite channel."""
    arr = np.asarray(image)
    bad = ~np.isfinite(arr).all(axis=-1)
    ys, xs = np.nonzero(bad)
    return list(zip(ys.tolist(), xs.tolist()))


def check_image(image, context: str = "render"):
    """Raise ``RenderCheckError`` naming the offending pixels, else return
    the image unchanged."""
    idx = find_nonfinite(image)
    if idx:
        arr = np.asarray(image)
        sample = ", ".join(
            f"({y},{x})={arr[y, x].tolist()}" for y, x in idx[:8]
        )
        more = "" if len(idx) <= 8 else f" (+{len(idx) - 8} more)"
        raise RenderCheckError(
            f"{context}: {len(idx)} non-finite pixel(s): {sample}{more}"
        )
    return image
