"""Image parity against the f64 reference: the bad-pixel measure and the
per-scene full-resolution gates.

A bad pixel is one whose max-channel error exceeds 2/255. ``PARITY_GATES``
is the JAX bench's ratchet (``bench.py`` PARITY_GATES, bad-pixel fraction at
full resolution against ``bench_goldens/<scene>.npz``); the CPU tests hold
this copy equal to it.
"""

from __future__ import annotations

import numpy as np

BAD_PIXEL_ERR = 2.0 / 255.0

PARITY_GATES = {
    "dingdong": 0.0027,
    "monkey_saddle": 1e-4,
    "20spheres": 1e-4,
    "reflection_test": 1e-4,
    "quadratic": 1e-4,
    "cayley": 7e-4,
    "clebsch": 1e-4,
    "cubic": 1e-4,
}


def bad_pixel_fraction(image, reference) -> float:
    """Fraction of pixels whose max-channel |image - reference| > 2/255."""
    image = np.asarray(image, dtype=np.float32)
    reference = np.asarray(reference, dtype=np.float32)
    if image.shape != reference.shape:
        raise ValueError(f"shape {image.shape} != reference shape {reference.shape}")
    err = np.abs(image - reference).max(axis=-1)
    return float((err > BAD_PIXEL_ERR).mean())
