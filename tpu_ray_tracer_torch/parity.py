"""Image parity against the f64 reference: the bad-pixel measure and the
per-scene full-resolution gates; and the per-group rule that holds one
gradient vector of ``render_bwd`` to another.

A bad pixel is one whose max-channel error exceeds 2/255. ``PARITY_GATES``
is the JAX bench's ratchet (``bench.py`` PARITY_GATES, bad-pixel fraction at
full resolution against ``bench_goldens/<scene>.npz``); the CPU tests hold
this copy equal to it.
"""

from __future__ import annotations

import numpy as np

from .render.bwd_kernel import split_grad

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


def gradient_group_errors(grad, reference, n_objects: int, n_lights: int) -> dict:
    """{group: (relative error, limit)} of a gradient vector in
    ``render_bwd``'s layout against a reference one, per parameter group
    (camera rotation, eye, fov, background; coefs; colors; light positions;
    light colours; reflection ratios). The error is max|grad - reference|
    over the group's largest |reference| (at least 1e-6); the limit is
    2e-3, or 2e-2 where that entry is at most 1, the rule of the JAX
    package's fused-backward tests (tests/test_pallas.py:177-181): small
    gradients carry more f32 cancellation noise relative to their size."""
    out = {}
    for (group, g), r in zip(_groups(grad, n_objects, n_lights).items(),
                             _groups(reference, n_objects, n_lights).values()):
        scale = max(float(r.abs().max()) if r.numel() else 0.0, 1e-6)
        err = float((g - r).abs().max()) / scale if r.numel() else 0.0
        out[group] = (err, 2e-3 if scale > 1.0 else 2e-2)
    return out


def _groups(vec, n_objects, n_lights):
    g = split_grad(vec, n_objects, n_lights)
    cam, lights = g["cam"], g["lights"]
    return {"rotation": cam[0:9], "eye": cam[9:12], "fov": cam[12:14], "bg": cam[14:17],
            "coefs": g["coefs"], "colors": g["colors"], "light_p": lights[:, 1:4],
            "light_color": lights[:, 4:7], "refl": g["refl"]}
