"""The PyTorch port's forward render against the JAX package's references.

On the CPU ``render_image_kernel`` runs the kernel's plain PyTorch version
(``render_fwd_plain``), which these tests hold to the f64 NumPy oracle
``render_image_np`` and to the f32 XLA pipeline, with the limits the JAX
package's own kernel tests use (tests/test_pallas.py). The CUDA kernel's
own tests are in tests/test_torch_gpu.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.render.pipeline import RenderConfig, render_image
from tpu_ray_tracer.render.reference_cpu import render_image_np
from tpu_ray_tracer_torch.models import light as tlight
from tpu_ray_tracer_torch.models import surface as tsurface
from tpu_ray_tracer_torch.models.scene import Object, camera_from_arrays, scene_from_arrays
from tpu_ray_tracer_torch.parity import bad_pixel_fraction
from tpu_ray_tracer_torch.models.surface import MONOMIAL_POWERS
from tpu_ray_tracer_torch.render.fwd_kernel import (_eye_coeffs, _eye_ray_coeffs, _powers3,
                                                    _ray_coeffs, render_fwd)
from tpu_ray_tracer_torch.render.kernel_backend import pack_frame, render_rows_kernel

from conftest import SCENE_NAMES, scene_path
from test_pallas import PARITY_MAX_BAD

FIELDS = ("coefs", "colors", "reflection", "light_p", "light_color",
          "light_is_spherical", "bg_color", "tan_half_fov")
OFF_POSE = ((0.0, 2.0, -3.0), 75.0, -12.0)


def _small(name, width=64, height=48):
    """The same scene at a test size in both packages."""
    return (dataclasses.replace(trt.load_from_file(scene_path(name)), width=width,
                                height=height),
            dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"), width=width,
                                height=height))


def _camera(pose, device="cpu"):
    pos, yaw, pitch = pose
    return camera_from_arrays(np.float32(pos), np.float32(yaw), np.float32(pitch), device)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_reference_pose_matches_oracle(name):
    jscene, tscene = _small(name)
    img = ttt.render_image_kernel(tscene)
    assert img.dtype == torch.float32 and img.shape == (48, 64, 3)
    assert torch.isfinite(img).all()
    frac = bad_pixel_fraction(img.numpy(), render_image_np(jscene))
    assert frac <= PARITY_MAX_BAD[name], f"{name}: {frac:.4%} bad pixels"


def test_off_pose_matches_oracle():
    jscene, tscene = _small("dingdong")
    pos, yaw, pitch = OFF_POSE
    img = ttt.render_image_kernel(tscene, _camera(OFF_POSE)).numpy()
    gold = render_image_np(jscene, position=pos, yaw_deg=yaw, pitch_deg=pitch)
    assert bad_pixel_fraction(img, gold) <= 0.01


def test_matches_xla_pipeline():
    """The plain version against the JAX package's f32 XLA pipeline: the
    same algorithm, near-identical output (tests/test_pallas.py:95-111)."""
    jscene, tscene = _small("dingdong")
    jc = trt.Camera(position=jnp.zeros(3, jnp.float32), yaw_deg=jnp.asarray(90.0, jnp.float32),
                    pitch_deg=jnp.asarray(0.0, jnp.float32))
    xla = np.asarray(render_image(jscene, jc, RenderConfig(
        geom_dtype="float32", polish_iters=3, bounces=0, chunk_px=None)))
    img = ttt.render_image_kernel(tscene).numpy()
    assert bad_pixel_fraction(img, xla) < 0.005


def _random_scene_arrays(seed=20261016):
    """Random spheres plus one cubic, lit by both light kinds, from numpy."""
    rng = np.random.default_rng(seed)
    surfaces = [tsurface.sphere(rng.uniform(-3, 3, 3) + [0, 0, 12], rng.uniform(0.5, 1.5))
                for _ in range(5)]
    surfaces.append(tsurface.ding_dong(rng.uniform(-1, 1, 3) + [0, 0, 10]))
    lights = [tlight.directional(rng.uniform(0.5, 2), rng.uniform(-1, 1, 3) - [0, 1, 0],
                                 rng.uniform(0.2, 1, 3)),
              tlight.spherical(rng.uniform(200, 800), rng.uniform(-4, 4, 3) + [0, 6, 6],
                               rng.uniform(0.2, 1, 3))]
    return dict(
        coefs=np.stack(surfaces),
        colors=rng.uniform(0.1, 1, (6, 3)).astype(np.float32),
        reflection=np.asarray([0.0, 0.4, 0.0, 0.0, 0.2, 0.0], np.float32),
        light_p=np.stack([l.p for l in lights]),
        light_color=np.stack([l.color for l in lights]),
        light_is_spherical=np.asarray([l.is_spherical for l in lights]),
        bg_color=np.asarray([0.1, 0.2, 0.3], np.float32),
        tan_half_fov=np.float64(np.tan(np.radians(20.0))),
    )


def test_random_scene_matches_oracle():
    arrays = _random_scene_arrays()
    jscene = trt.Scene(**arrays, width=64, height=48, max_reflections=2)
    tscene = scene_from_arrays(*(arrays[f] for f in FIELDS), 64, 48, 2, device="cpu")
    img = ttt.render_image_kernel(tscene).numpy()
    assert np.isfinite(img).all()
    assert bad_pixel_fraction(img, render_image_np(jscene)) <= 0.01


@pytest.mark.parametrize("name", ["dingdong", "reflection_test"])
def test_rows_stitch_to_frame(name):
    # width 64: torch's CPU loops finish a tensor whose length is not a
    # multiple of the SIMD stride with scalar math (other last bits for cos,
    # pow, rsqrt), so only whole strides make the blocks bit-comparable
    _, tscene = _small(name, 64, 30)
    cam = _camera(OFF_POSE)
    full = ttt.render_image_kernel(tscene, cam)
    blocks = [render_rows_kernel(tscene, cam, r0, r1 - r0)
              for r0, r1 in ((0, 7), (7, 19), (19, 30))]
    assert torch.equal(torch.cat(blocks), full)


def _both_scenes(objects, lights):
    kw = dict(width=32, height=24, fov_deg=40.0, objects=objects, lights=lights,
              bg_color=(0.0, 0.1, 0.2))
    jobjects = [trt.models.scene.Object(o.surface, o.reflection_ratio, o.color)
                for o in objects]
    return trt.build_scene(**{**kw, "objects": jobjects}), ttt.build_scene(**kw, device="cpu")


@pytest.mark.parametrize("case", ["no_objects", "no_lights"])
def test_empty_scenes_match_reference(case):
    """Empty object or light tables are legal scenes (reference
    src/scene.cpp:169-170). The NumPy oracle cannot take an empty object
    table (it reduces over the object axis), so the 0-object frame is held
    to the JAX package's XLA pipeline and to the background instead."""
    sphere = Object(tsurface.sphere((0, 0, 8), 2.0), 0.3, np.float32([0.8, 0.2, 0.1]))
    plane = Object(tsurface.plane((0, -2, 0), (0, 1, 0)), 0.0, np.float32([0.2, 0.8, 0.2]))
    sun = tlight.directional(2.0, (0.3, -1, 0.5), (1, 1, 1))
    objects, lights = ([], [sun]) if case == "no_objects" else ([sphere, plane], [])
    jscene, tscene = _both_scenes(objects, lights)
    img = ttt.render_image_kernel(tscene).numpy()
    if case == "no_objects":
        np.testing.assert_array_equal(img, np.asarray(render_image(jscene)))
        np.testing.assert_array_equal(img, np.broadcast_to(np.float32([0.0, 0.1, 0.2]),
                                                           img.shape))
    else:
        assert bad_pixel_fraction(img, render_image_np(jscene)) == 0.0


def test_eye_hoisted_coefficients_match_binomial_expansion():
    """Stage 0's t-polynomial from the eye-hoisted coefficients
    (``_eye_coeffs``, ``_eye_ray_coeffs``) against the binomial expansion
    ``_ray_coeffs`` and against a direct fit of F(e + t d) at t = 0..3, all
    in f64, on random coefficients, eyes and unit directions made with numpy
    from a seed: within 1e-12 (expansion) and 1e-9 (fit) of the scale
    sum_m |c_m| (1 + |e|)^3. In f32 (the kernels' type) within 1e-5 of it."""
    rng = np.random.default_rng(20261016)
    powers = np.asarray(MONOMIAL_POWERS)
    for _ in range(16):
        coef = rng.normal(size=20)
        eye = rng.uniform(-3.0, 3.0, 3)
        d = rng.normal(size=(32, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        scale = np.abs(coef).sum() * (1.0 + np.abs(eye).max()) ** 3

        def both(dtype):
            c = [torch.tensor(v, dtype=dtype) for v in coef]
            e = _powers3(*(torch.tensor(v, dtype=dtype) for v in eye))
            dp = _powers3(*torch.tensor(d, dtype=dtype).unbind(1))
            one = torch.ones(32, dtype=dtype)
            hoisted = _eye_ray_coeffs(_eye_coeffs(c, e, torch.ones((), dtype=dtype)), dp, one)
            return (torch.stack(hoisted).double().numpy(),
                    torch.stack(_ray_coeffs(c, e, dp, one)).double().numpy())

        hoisted, expansion = both(torch.float64)
        np.testing.assert_allclose(hoisted, expansion, rtol=0, atol=1e-12 * scale)
        ts = np.arange(4.0)
        pts = eye[None, None, :] + ts[None, :, None] * d[:, None, :]  # [32, 4, 3]
        f = (coef * np.prod(pts[..., None, :] ** powers, axis=-1)).sum(-1)  # [32, 4]
        fit = np.linalg.solve(np.vander(ts, 4), f.T)  # rows t3, t2, t1, t0
        np.testing.assert_allclose(hoisted, fit, rtol=0, atol=1e-9 * scale)
        hoisted32, _ = both(torch.float32)
        np.testing.assert_allclose(hoisted32, expansion, rtol=0, atol=1e-5 * scale)


def test_launch_counter_stays_zero_on_cpu():
    _, tscene = _small("quadratic", 16, 12)
    before = render_fwd.launches
    ttt.render_image_kernel(tscene)
    assert render_fwd.launches == before == 0


def test_wrapper_rejects_bad_tables():
    _, tscene = _small("dingdong", 8, 8)
    tables, kw = pack_frame(tscene, _camera(OFF_POSE), 0, 8)
    with pytest.raises(ValueError, match="coefs must be a contiguous"):
        render_fwd(tables[0].double(), *tables[1:], **kw)
    with pytest.raises(ValueError, match="dir_table has shape"):
        render_fwd(*tables[:5], tables[5][:, :1].contiguous(), *tables[6:], **kw)
    with pytest.raises(ValueError, match="n_cubic"):
        render_fwd(*tables, **{**kw, "n_cubic": 4})
    with pytest.raises(ValueError, match="no kernel for device"):
        render_fwd(*(t.to("meta") for t in tables), **kw)
