"""The port's native (C++) scene loader (``tpu_ray_tracer_torch/native/``)
against the port's Python loader and the JAX package's loader on the full
corpus, with the error paths of tests/test_native_loader.py.

The library is built from the port's own copy of ``scene_loader.cpp``
(byte-identical to the JAX package's, tested here) into
``build/tpu_ray_tracer_torch/<hash>/``; the cases skip where no C++
toolchain builds it.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch import native
from tpu_ray_tracer_torch.models.errors import SceneError

from conftest import SCENE_NAMES, scene_path

REPO = pathlib.Path(__file__).resolve().parent.parent
TABLES = ("coefs", "colors", "reflection", "light_p", "light_color", "light_is_spherical",
          "bg_color", "tan_half_fov")


@pytest.fixture(scope="module")
def load():
    if not native.available():
        pytest.skip("no C++ toolchain builds libtrtscene")
    return functools.partial(native.load_from_file, device="cpu")


def test_source_is_the_jax_packages_byte_for_byte():
    port = (REPO / "tpu_ray_tracer_torch" / "native" / "scene_loader.cpp").read_bytes()
    assert port == (REPO / "tpu_ray_tracer" / "native" / "scene_loader.cpp").read_bytes()


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_native_matches_python_loaders(load, name):
    """Every table equal to the port's Python loader's (same dtypes, same
    values) and to the JAX loader's (rtol 1e-12 on coefs and light_p, as
    tests/test_native_loader.py holds the JAX native loader)."""
    a = load(scene_path(name))
    b = ttt.load_from_file(scene_path(name), device="cpu")
    j = trt.load_from_file(scene_path(name))
    for s in (b, j):
        assert (a.width, a.height, a.max_reflections) == (s.width, s.height, s.max_reflections)
    for f in TABLES:
        got, want = getattr(a, f), getattr(b, f)
        assert got.device.type == "cpu" and got.dtype == want.dtype, f
        assert torch.equal(got, want), f
    np.testing.assert_allclose(a.coefs.numpy(), np.asarray(j.coefs), rtol=1e-12)
    np.testing.assert_allclose(a.light_p.numpy(), np.asarray(j.light_p), rtol=1e-12)
    np.testing.assert_allclose(a.colors.numpy(), np.asarray(j.colors))
    np.testing.assert_allclose(a.reflection.numpy(), np.asarray(j.reflection))
    np.testing.assert_allclose(a.light_color.numpy(), np.asarray(j.light_color), rtol=1e-6)
    np.testing.assert_array_equal(a.light_is_spherical.numpy(), np.asarray(j.light_is_spherical))
    np.testing.assert_allclose(a.bg_color.numpy(), np.asarray(j.bg_color))
    assert float(a.tan_half_fov) == pytest.approx(float(np.asarray(j.tan_half_fov)), rel=1e-12)


BAD_SCENES = [
    ("missing_key", "width: 10\nheight: 10\nobjects: []\nlight_sources: []\n",
     "Value 'fov' undefined"),
    ("unknown_surface", "width: 10\nheight: 10\nfov: 30\n"
     "objects:\n  - {type: torus, color: [1, 0, 0]}\nlight_sources: []\n",
     "Unknown surface type: 'torus'"),
    ("negative_radius", "width: 10\nheight: 10\nfov: 30\n"
     "objects:\n  - {type: sphere, radius: -2, color: [1, 0, 0]}\nlight_sources: []\n",
     "Negative value for sphere radius"),
]


def test_native_missing_file(load):
    with pytest.raises(SceneError, match="Cannot read the file"):
        load("/nonexistent/scene.yml")


@pytest.mark.parametrize("text,message", [c[1:] for c in BAD_SCENES],
                         ids=[c[0] for c in BAD_SCENES])
def test_native_errors_raise_scene_error(load, tmp_path, text, message):
    """The port's SceneError with the C++ loader's message, the one
    tests/test_native_loader.py expects of the JAX binding."""
    path = tmp_path / "bad.yml"
    path.write_text(text)
    with pytest.raises(SceneError, match=message):
        load(str(path))


def test_native_block_style_scene(load, tmp_path):
    """Block-style (reference formatting) parses as the Python loaders do."""
    path = tmp_path / "block.yml"
    path.write_text("""
width: 320
height: 200
fov: 45
bg_color: [0, 0.1, 0.2]
objects:
  - type: sphere
    center: [1, 2, 3]
    radius: 2
    color: [0.5, 0.5, 0.5]
    reflection_ratio: 0.25
  - type: polynomial
    coefficients:
      x3: 1
      y: 10
      c: 5
    color: [0.8, 0.8, 0.8]
light_sources:
  - type: directional
    intensity: 3
    direction: [0.8, -0.3, 0.2]
    color: [1, 1, 1]
  - type: spherical
    intensity: 800
    position: [0, 4, 4]
    color: [1, 0.8, 0.4]
""")
    a, b = load(str(path)), ttt.load_from_file(str(path), device="cpu")
    j = trt.load_from_file(str(path))
    for f in TABLES:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(a.coefs.numpy(), np.asarray(j.coefs), rtol=1e-12)


def test_native_defaults_to_the_card(load):
    """As the other loaders: the default device is the GPU, raising without
    one; ``device="cpu"`` gives CPU tables."""
    path = scene_path("dingdong")
    if torch.cuda.is_available():
        assert native.load_from_file(path).coefs.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match=r"no CUDA device.*device=\"cpu\""):
            native.load_from_file(path)
    assert all(getattr(load(path), f).device.type == "cpu" for f in TABLES)
