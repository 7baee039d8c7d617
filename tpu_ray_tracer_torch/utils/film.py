"""Framebuffer finishing: quantization and display-ready conversion.

Counterpart of ``tpu_ray_tracer/utils/film.py``, on numpy images.

The reference has two output paths: the CPU backend uploads raw float RGB
(reference: src/update-cpu.cpp:136-137), the CUDA backend quantizes with
``iround(color * 255)`` to RGBA8 (reference: src/update-cuda.cu:149-156).
Both are provided; the float path is the parity target.
"""

from __future__ import annotations

import numpy as np


def to_uint8(image: np.ndarray) -> np.ndarray:
    """[H, W, 3] float -> [H, W, 3] uint8 via round-half-away-from-zero,
    matching glm::iround (reference: update-cuda.cu:149)."""
    img = np.asarray(image, dtype=np.float32)
    return np.clip(np.floor(img * 255.0 + 0.5), 0, 255).astype(np.uint8)


def flip_vertical(image: np.ndarray) -> np.ndarray:
    """Renderer row 0 is the image bottom (GL texture convention); flip for
    top-down file formats like PNG."""
    return image[::-1]
