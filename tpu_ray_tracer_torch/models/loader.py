"""YAML scene loader.

Counterpart of ``tpu_ray_tracer/models/loader.py``: the reference loader's
schema and error semantics (reference: src/scene.cpp:154-203) on PyYAML's
``compose`` API, so error messages carry ``line: L column: C`` marks as the
yaml-cpp based reference does (src/scene.cpp:24-39):

* required keys -> ``Value 'key' undefined, line: .. column: ..``;
* bad conversions of required keys -> ``Value 'key' is invalid, ...``;
* optional keys follow yaml-cpp ``as<T>(fallback)``: a present but
  unconvertible value silently takes the default.

Schema: ``width``/``height``/``fov`` required; ``max_reflections`` (default 5)
and ``bg_color`` (default white) optional; ``objects`` and ``light_sources``
required sequences. Objects: ``type`` in {sphere, plane, dingDong, clebsch,
cayley, polynomial}, ``color`` required, ``reflection_ratio`` default 0.
Lights: ``type`` in {directional, spherical}, ``direction``/``position``
required, ``intensity`` default 1, ``color`` default white.
"""

from __future__ import annotations

import numpy as np
import torch
import yaml

from . import light as light_mod
from . import surface as surface_mod
from .errors import SceneError, invalid_type, mark_to_string, undefined_value
from .scene import (
    DEFAULT_BG_COLOR,
    DEFAULT_MAX_REFLECTIONS,
    Object,
    Scene,
    build_scene,
)

_WHITE = (1.0, 1.0, 1.0)


# --- node conversion helpers (yaml-cpp `as<T>` analogues) ---

def _is_map(node) -> bool:
    return isinstance(node, yaml.MappingNode)


def _is_seq(node) -> bool:
    return isinstance(node, yaml.SequenceNode)


def _lookup(map_node, key: str):
    """Mapping lookup by scalar key; returns the value node or None."""
    if not _is_map(map_node):
        return None
    for key_node, value_node in map_node.value:
        if isinstance(key_node, yaml.ScalarNode) and key_node.value == key:
            return value_node
    return None


def _as_float(node) -> float:
    if not isinstance(node, yaml.ScalarNode):
        raise ValueError
    try:
        return float(node.value)
    except (TypeError, ValueError):
        raise ValueError from None


def _as_uint(node) -> int:
    if not isinstance(node, yaml.ScalarNode):
        raise ValueError
    try:
        value = int(node.value, 0)
    except (TypeError, ValueError):
        raise ValueError from None
    if value < 0:
        raise ValueError
    return value


def _as_str(node) -> str:
    if not isinstance(node, yaml.ScalarNode):
        raise ValueError
    return str(node.value)


def _as_vec3(node) -> np.ndarray:
    """3-element sequence -> vec3 (reference: src/scene.cpp:79-95)."""
    if not _is_seq(node) or len(node.value) != 3:
        raise ValueError
    return np.asarray([_as_float(child) for child in node.value], dtype=np.float64)


def _get_value(map_node, key: str, convert):
    """Required key with typed conversion (reference: src/scene.cpp:41-54)."""
    child = _lookup(map_node, key)
    if child is None:
        raise undefined_value(map_node.start_mark, key)
    try:
        return convert(child)
    except ValueError:
        raise invalid_type(child.start_mark, key) from None


def _get_opt(map_node, key: str, convert, default):
    """Optional key: silent fallback on a missing key and on a bad conversion."""
    child = _lookup(map_node, key)
    if child is None:
        return default
    try:
        return convert(child)
    except ValueError:
        return default


def _check_sequence(map_node, key: str):
    """Require `key` to exist and be a sequence (reference: src/scene.cpp:56-65)."""
    child = _lookup(map_node, key)
    if child is None:
        raise undefined_value(map_node.start_mark, key)
    if not _is_seq(child):
        raise SceneError(
            f"Value '{key}' must be a sequence, {mark_to_string(child.start_mark)}"
        )
    return child


def _check_map(map_node, key: str):
    """Require `key` to exist and be a mapping (reference: src/scene.cpp:67-76)."""
    child = _lookup(map_node, key)
    if child is None:
        raise undefined_value(map_node.start_mark, key)
    if not _is_map(child):
        raise SceneError(
            f"Value '{key}' must be a mapping, {mark_to_string(child.start_mark)}"
        )
    return child


# --- surface / light parsing ---

def _parse_surface(node) -> np.ndarray:
    """Dispatch on object ``type`` (reference: src/scene.cpp:97-151)."""
    type_name = _get_value(node, "type", _as_str)
    if type_name == "sphere":
        return surface_mod.sphere(
            _get_opt(node, "center", _as_vec3, np.zeros(3)),
            _get_opt(node, "radius", _as_float, 1.0),
        )
    if type_name == "plane":
        return surface_mod.plane(
            _get_opt(node, "origin", _as_vec3, np.zeros(3)),
            _get_opt(node, "normal", _as_vec3, np.array([0.0, 1.0, 0.0])),
        )
    if type_name == "dingDong":
        return surface_mod.ding_dong(_get_opt(node, "origin", _as_vec3, np.zeros(3)))
    if type_name == "clebsch":
        return surface_mod.clebsch()
    if type_name == "cayley":
        return surface_mod.cayley()
    if type_name == "polynomial":
        coef_node = _check_map(node, "coefficients")
        named = {
            name: _get_opt(coef_node, name, _as_float, 0.0)
            for name in surface_mod.COEF_NAMES
        }
        return surface_mod.from_named(**named)
    type_node = _lookup(node, "type")
    raise SceneError(
        f"Unknown surface type: '{type_name}', {mark_to_string(type_node.start_mark)}"
    )


def _parse_light(node) -> light_mod.Light:
    """Light dispatch (reference: src/scene.cpp:179-200)."""
    type_name = _get_value(node, "type", _as_str)
    if type_name == "directional":
        return light_mod.directional(
            _get_opt(node, "intensity", _as_float, 1.0),
            _get_value(node, "direction", _as_vec3),
            _get_opt(node, "color", _as_vec3, np.asarray(_WHITE)),
        )
    if type_name == "spherical":
        return light_mod.spherical(
            _get_opt(node, "intensity", _as_float, 1.0),
            _get_value(node, "position", _as_vec3),
            _get_opt(node, "color", _as_vec3, np.asarray(_WHITE)),
        )
    type_node = _lookup(node, "type")
    raise SceneError(
        "Light source type must be 'spherical' or 'directional', "
        + mark_to_string(type_node.start_mark)
    )


# --- top level ---

def load_from_string(text: str, device: str | torch.device = "cuda") -> Scene:
    """Parse a YAML scene document from a string into a ``Scene`` on
    ``device``: the GPU unless the caller asks for another, as the JAX
    package puts a loaded scene on its default device, the accelerator.
    Without a CUDA device the default raises; pass ``device="cpu"``."""
    try:
        root = yaml.compose(text, Loader=yaml.SafeLoader)
    except yaml.YAMLError as exc:
        raise SceneError(f"YAML parser error: {exc}") from None
    if root is None or not _is_map(root):
        raise SceneError("YAML parser error: scene document must be a mapping")

    width = _get_value(root, "width", _as_uint)
    height = _get_value(root, "height", _as_uint)
    fov_deg = _get_value(root, "fov", _as_float)
    max_reflections = _get_opt(root, "max_reflections", _as_uint, DEFAULT_MAX_REFLECTIONS)
    bg_color = _get_opt(root, "bg_color", _as_vec3, np.asarray(DEFAULT_BG_COLOR))

    objects_node = _check_sequence(root, "objects")
    lights_node = _check_sequence(root, "light_sources")

    objects = [
        Object(
            surface=_parse_surface(obj_node),
            reflection_ratio=_get_opt(obj_node, "reflection_ratio", _as_float, 0.0),
            color=np.asarray(_get_value(obj_node, "color", _as_vec3), dtype=np.float32),
        )
        for obj_node in objects_node.value
    ]
    lights = [_parse_light(light_node) for light_node in lights_node.value]

    return build_scene(
        width=width,
        height=height,
        fov_deg=fov_deg,
        objects=objects,
        lights=lights,
        max_reflections=max_reflections,
        bg_color=bg_color,
        device=device,
    )


def load_from_file(path, device: str | torch.device = "cuda") -> Scene:
    """Load a scene YAML file (reference: src/scene.cpp:154-203) into a
    ``Scene`` on ``device`` (see ``load_from_string``)."""
    try:
        with open(path, "r") as handle:
            text = handle.read()
    except OSError:
        raise SceneError(f"Cannot read the file {path}") from None
    return load_from_string(text, device)
