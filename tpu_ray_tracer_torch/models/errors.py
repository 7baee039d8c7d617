"""Scene validation errors.

Counterpart of ``tpu_ray_tracer/models/errors.py``: the same exception type
and the same message shapes, carrying YAML ``line: L column: C`` marks
(reference: src/scene.cpp:24-39, src/scene-exception.cpp:3-11).
"""

from __future__ import annotations

import numpy as np


class SceneError(Exception):
    """Raised for any invalid scene description (parse or validation failure)."""


def mark_to_string(mark) -> str:
    """Format a YAML mark as ``line: L column: C`` (1-based)."""
    return f"line: {mark.line + 1} column: {mark.column + 1}"


def undefined_value(parent_mark, key: str) -> SceneError:
    return SceneError(f"Value '{key}' undefined, {mark_to_string(parent_mark)}")


def invalid_type(mark, key: str) -> SceneError:
    return SceneError(f"Value '{key}' is invalid, {mark_to_string(mark)}")


def validate_positive(what: str, value) -> None:
    """Reject negative values (reference: include/scene-exception.h:26-34)."""
    if value < 0:
        raise SceneError(f"Negative value for {what}: {value:g}")


def validate_color(color) -> None:
    """Require each channel in [0, 1] (reference: src/scene-exception.cpp:3-11)."""
    color = np.asarray(color, dtype=np.float64)
    if color.shape != (3,) or np.any(color < 0.0) or np.any(color > 1.0):
        c = [float(v) for v in np.ravel(color)[:3]]
        raise SceneError(f"Invalid color: ({c[0]:g}, {c[1]:g}, {c[2]:g})")
