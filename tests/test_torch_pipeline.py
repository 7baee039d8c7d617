"""The port's plain PyTorch pipeline (``render/pipeline.py``) and its NumPy
oracle (``render/reference_cpu.py``) against the JAX package's, on the CPU.

The fast path in f32 is held to the oracle with the JAX package's own limit
(tests/test_golden.py: at most 1% of the pixels off by more than 2/255 at
64x48); the port's oracle to the JAX package's bit for bit; the pipeline to
the JAX package's f32 XLA pipeline as tests/test_torch_render.py holds the
kernel's plain version to it. Only one XLA compile, that f32 frame, whose
executable tests/test_torch_render.py shares through the persistent cache.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.render import reference_cpu as jref
from tpu_ray_tracer.render.pipeline import RenderConfig as JRenderConfig
from tpu_ray_tracer_torch.models import light as tlight
from tpu_ray_tracer_torch.models import surface as tsurface
from tpu_ray_tracer_torch.models.scene import Object, camera_from_arrays
from tpu_ray_tracer_torch.parity import bad_pixel_fraction
from tpu_ray_tracer_torch.render import reference_cpu as tref

from conftest import SCENE_NAMES, scene_path
from test_reflection_cap import CORRIDOR

MAX_BAD_FRACTION = 0.01  # tests/test_golden.py
# GOLDEN (f64, unpolished) against the oracle at 64x48: at most 0.2% of the
# pixels. Measured: dingdong 4 of 3072 pixels (0.13%), near the double roots
# of its cubic around the y=0 scanline, where the pipeline's scale-normalised
# discriminant and the oracle's unscaled one pick other branches; 0 on the
# other 7 scenes.
MAX_BAD_GOLDEN = 0.002
OFF_POSE = ((0.0, 2.0, -3.0), 75.0, -12.0)


def _scene(name, width=64, height=48):
    return dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                               width=width, height=height)


def _fast(scene, **kw):
    return ttt.render_image(scene, config=dataclasses.replace(ttt.FAST_CONFIG, **kw)).numpy()


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_fast_path_matches_oracle(name):
    scene = _scene(name)
    golden = tref.render_image_np(scene)
    fast = _fast(scene)
    assert fast.dtype == np.float32 and fast.shape == golden.shape == (48, 64, 3)
    assert np.isfinite(fast).all()
    frac = bad_pixel_fraction(fast, golden)
    assert frac <= MAX_BAD_FRACTION, f"{name}: {frac:.4%} bad pixels"


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_golden_config_matches_oracle(name):
    scene = _scene(name)
    img = ttt.render_image(scene, config=ttt.GOLDEN_CONFIG)
    assert img.dtype == torch.float32
    frac = bad_pixel_fraction(img.numpy(), tref.render_image_np(scene))
    assert frac <= MAX_BAD_GOLDEN, f"{name}: {frac:.4%} bad pixels"


def test_matches_jax_pipeline():
    """The port's pipeline against the JAX package's f32 XLA pipeline, same
    config: < 0.5% bad pixels (tests/test_torch_render.py:69-78)."""
    jscene = dataclasses.replace(trt.load_from_file(scene_path("dingdong")), width=64,
                                 height=48)
    jc = trt.Camera(position=jnp.zeros(3, jnp.float32), yaw_deg=jnp.asarray(90.0, jnp.float32),
                    pitch_deg=jnp.asarray(0.0, jnp.float32))
    config = dict(geom_dtype="float32", polish_iters=3, bounces=0, chunk_px=None)
    xla = np.asarray(trt.render_image(jscene, jc, JRenderConfig(**config)))
    cam = camera_from_arrays(np.zeros(3, np.float32), np.float32(90.0), np.float32(0.0), "cpu")
    img = ttt.render_image(_scene("dingdong"), cam, ttt.RenderConfig(**config)).numpy()
    assert bad_pixel_fraction(img, xla) < 0.005


@pytest.mark.parametrize("case", [*SCENE_NAMES, "dingdong@off"])
def test_oracle_bitwise_equals_jax_oracle(case):
    """The port's copy of the NumPy oracle reads the port's scene and gives
    the JAX package's oracle's image bit for bit."""
    name = case.split("@")[0]
    pose = dict(position=OFF_POSE[0], yaw_deg=OFF_POSE[1], pitch_deg=OFF_POSE[2]) \
        if "@" in case else {}
    jscene = dataclasses.replace(trt.load_from_file(scene_path(name)), width=32, height=24)
    got = tref.render_image_np(_scene(name, 32, 24), **pose)
    want = jref.render_image_np(jscene, **pose)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_oracle_nonempty_and_bounded():
    for name in SCENE_NAMES:
        img = tref.render_image_np(_scene(name))
        assert np.isfinite(img).all(), name
        assert (img >= 0).all() and (img <= 1.0).all(), name


def test_background_when_camera_faces_away():
    """Yaw 270 looks down -z: all of 20spheres' geometry sits at z in
    [13, 18], so both the oracle and the pipeline give pure background
    (tests/test_golden.py:59-66)."""
    scene = _scene("20spheres")
    bg = np.broadcast_to(scene.bg_color.numpy(), (48, 64, 3))
    np.testing.assert_allclose(tref.render_image_np(scene, yaw_deg=270.0), bg, atol=1e-6)
    cam = camera_from_arrays(np.zeros(3, np.float32), np.float32(270.0), np.float32(0.0), "cpu")
    np.testing.assert_allclose(ttt.render_image(scene, cam).numpy(), bg, atol=1e-6)


def _corridor(max_reflections):
    return ttt.load_from_string(CORRIDOR.format(max_reflections=max_reflections), device="cpu")


def test_reflection_chain_changes_image():
    """reflection_test's mirror plane blends in other colours, and the
    corridor's deeper cap resolves more bounces (tests/test_golden.py:69-79,
    tests/test_reflection_cap.py:33-38)."""
    scene = _scene("reflection_test")
    no_refl = dataclasses.replace(scene, reflection=torch.zeros_like(scene.reflection))
    assert np.abs(_fast(scene) - _fast(no_refl)).max() > 0.01
    assert np.abs(tref.render_image_np(_corridor(1))
                  - tref.render_image_np(_corridor(5))).max() > 0.01


@pytest.mark.parametrize("max_reflections", [1, 3, 5])
def test_fast_path_matches_oracle_at_cap(max_reflections):
    """The mirror corridor drives the chain to the cap: the cumulative-ratio
    blend and the at-cap background blend (tests/test_reflection_cap.py:41-53,
    at most 2% bad pixels)."""
    scene = _corridor(max_reflections)
    frac = bad_pixel_fraction(_fast(scene), tref.render_image_np(scene))
    assert frac <= 0.02, (max_reflections, frac)


def test_zero_reflectivity_ignores_max_reflections():
    """The loop never enters without a reflective object (loop-entry
    condition, reference update-cpu.cpp:97), in the oracle and the
    pipeline."""
    scene = _corridor(5)
    no_refl = dataclasses.replace(scene, reflection=torch.zeros_like(scene.reflection))
    one = dataclasses.replace(no_refl, max_reflections=1)
    np.testing.assert_array_equal(tref.render_image_np(no_refl), tref.render_image_np(one))
    np.testing.assert_array_equal(_fast(no_refl), _fast(one))


def _built(objects, lights, bg=(0.25, 0.5, 0.75)):
    return ttt.build_scene(64, 32, 60.0, objects, lights, bg_color=bg, device="cpu")


SPHERE = Object(tsurface.sphere((0.0, 0.0, 6.0), 2.0), 0.0, np.float32([0.8, 0.3, 0.2]))
PLANE = Object(tsurface.plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0)), 0.0,
               np.float32([0.2, 0.6, 0.9]))
SUN = tlight.directional(1.0, (0.0, -1.0, 0.0), (1.0, 1.0, 1.0))


def test_zero_object_scene_is_background():
    """No object: every ray misses; the frame is the background, chunked or
    not (the oracle cannot reduce over an empty object axis)."""
    scene = _built([], [SUN], bg=(0.3, 0.6, 0.9))
    for chunk in (None, 500):
        img = _fast(scene, chunk_px=chunk)
        np.testing.assert_array_equal(img, np.broadcast_to(np.float32([0.3, 0.6, 0.9]),
                                                           img.shape))


def test_zero_light_scene_matches_oracle():
    """No light: hit pixels are black (an empty lit sum), misses show the
    background (tests/test_degenerate.py:123-142)."""
    scene = _built([SPHERE, PLANE], [])
    img = _fast(scene)
    assert bad_pixel_fraction(img, tref.render_image_np(scene)) == 0.0
    flat = img.reshape(-1, 3)
    assert (flat == 0.0).all(axis=-1).any()
    assert np.isclose(flat, [0.25, 0.5, 0.75]).all(axis=-1).any()


@pytest.mark.parametrize("name", ["dingdong", "reflection_test"])
def test_chunked_equals_unchunked(name):
    """Chunks of rays are independent: 3072 pixels in chunks of 1024 or 512
    (whole SIMD strides, so the CPU's vector loops round alike) give the
    one-shot frame's bits; a gradient through the chunks equals the
    one-shot one within 1e-4 relative (its f32 sum over the 3072 pixels
    runs in another order: measured 1.8e-5)."""
    scene = _scene(name)
    whole = _fast(scene)
    for chunk in (1024, 512):
        np.testing.assert_array_equal(_fast(scene, chunk_px=chunk), whole)
    grads = []
    for chunk in (None, 1024):
        colors = scene.colors.clone().requires_grad_()
        img = ttt.render_image(dataclasses.replace(scene, colors=colors),
                               config=dataclasses.replace(ttt.FAST_CONFIG, chunk_px=chunk))
        img.sum().backward()
        grads.append(colors.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=0)


def test_argmin_ties_take_the_first_object():
    """Two copies of one sphere tie on every hit: the first index wins, as
    in the reference's strict-< scan, the oracle and ``jnp.argmin``."""
    t = torch.tensor([[3.0, 1.0, 1.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    assert torch.argmin(t, dim=-1).tolist() == [1, 0]
    big = torch.ones(4099, 7)
    assert (torch.argmin(big, dim=-1) == 0).all()
    twin = Object(SPHERE.surface, 0.0, np.float32([0.1, 0.9, 0.1]))
    scene = _built([SPHERE, twin, PLANE], [SUN])
    img = _fast(scene)
    assert bad_pixel_fraction(img, tref.render_image_np(scene)) == 0.0
    first = _fast(_built([SPHERE, PLANE], [SUN]))
    np.testing.assert_array_equal(img, first)
