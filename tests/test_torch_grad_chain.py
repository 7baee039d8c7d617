"""The port's differentiable render through the reflection chain, and its
stage-0 aux, against the JAX package.

The reflective gradient is held to ``jax.grad`` of the f32 XLA pipeline at
``bounces=2`` with the limits of tests/test_pallas.py:351-408; the stage-0
aux of ``render_fwd(..., save_aux=True)`` (hit distance, slot, occlusion
bits) to the pipeline's ``trace_and_shade`` (render/pipeline.py:80-115).
On the CPU both run the plain versions of the port's kernels. This file is
apart from tests/test_torch_grad.py so that the two XLA gradient compiles
land on different workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
from tpu_ray_tracer.ops import camera as jcamera
from tpu_ray_tracer.ops.constants import SHADOW_BIAS
from tpu_ray_tracer.ops.intersect import intersect_all, occluder_mask
from tpu_ray_tracer.ops.shading import shadow_ray_dirs
from tpu_ray_tracer.render.pipeline import RenderConfig, trace_and_shade
from tpu_ray_tracer_torch.models.scene import camera_from_arrays
from tpu_ray_tracer_torch.render import kernel_backend
from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd

from conftest import scene_path
from test_torch_grad import assert_group_close, jax_grads, port_grads, to_torch

REFLECTION_GROUPS = ("coefs", "reflection", "light_color", "light_p", "colors",
                     "bg_color", "position", "yaw_deg", "pitch_deg")
REFLECTION_POSE = ((0.0, 0.0, 0.0), 90.0, -10.0)


@pytest.fixture(scope="module")
def reflection_grads():
    jscene = dataclasses.replace(trt.load_from_file(scene_path("reflection_test")),
                                 width=32, height=16)
    config = RenderConfig(geom_dtype="float32", polish_iters=3, bounces=2, chunk_px=None)
    ref = jax_grads(jscene, REFLECTION_POSE, config, REFLECTION_GROUPS)
    # shadow_iters=3: the XLA pipeline solves occlusion with polish_iters
    port = port_grads(to_torch(jscene), REFLECTION_POSE, REFLECTION_GROUPS, bounces=2,
                      shadow_iters=3)
    return port, ref


@pytest.mark.parametrize("group", REFLECTION_GROUPS)
def test_reflective_gradient_matches_jax(reflection_grads, group):
    """reflection_test at 32x16, bounces=2, pitch -10: the at-cap blend, an
    interior stage and stage 0 (tests/test_pallas.py:343-408)."""
    port, ref = reflection_grads
    if group == "reflection":
        # the ratio gradient exists only through the chain's blend
        assert np.abs(ref[group]).max() > 0
    assert_group_close(group, port[group], ref[group])


def _xla_stage0(jscene, polish_iters=3):
    """The XLA pipeline's primary hit at the reference pose: hit, slot, hit
    distance, per-light in_shadow and per-light Lambert factor
    (render/pipeline.py:80-115; the pipeline does not return in_shadow, so
    its lines 99-107 are repeated here with the same ops)."""
    scene = jax.tree.map(jnp.asarray, jscene.astype(jnp.float32))
    cam = jcamera.Camera.initial(jnp.float32)

    @jax.jit
    def run(scene):
        rotation, eye = jcamera.camera_frame(cam)
        dirs = jcamera.pixel_directions(rotation, scene.width, scene.height,
                                        scene.aspect_ratio, scene.tan_half_fov)
        origin = jnp.broadcast_to(eye, dirs.shape)
        res = trace_and_shade(scene, origin, dirs, polish_iters)
        t = jnp.sum((res.point - origin) * dirs, axis=-1)
        sdir, max_t = shadow_ray_dirs(scene.light_p, scene.light_is_spherical, res.point)
        occ_t = intersect_all(scene.coefs, (res.point + SHADOW_BIAS * res.normal)[..., None, :],
                              sdir, polish_iters)
        in_shadow = jnp.any(occluder_mask(occ_t, max_t[..., None]), axis=-1)
        ld = sdir / jnp.linalg.norm(sdir, axis=-1, keepdims=True)
        lam = jnp.sum(res.normal[..., None, :] * ld, axis=-1)
        return res.hit, res.idx, t, in_shadow, lam

    return [np.asarray(a) for a in run(scene)]


@pytest.mark.parametrize("name", ["dingdong", "20spheres"])
def test_stage0_aux_matches_xla_pipeline(name):
    """The port's stage-0 aux against the XLA pipeline at 64x48: dingdong,
    and 20spheres for the occlusion bits (dingdong has no shadowed pixel
    at this pose; 20spheres has 19 lights and many).
    The two find roots with different solvers (the kernel's seeds, screen
    and sign classifier against ops/roots.py), so a few silhouette and
    penumbra pixels may differ. Hit masks and slots must agree on at least
    99.5% of the pixels.

    t must agree to 1e-4 relative (f32 Newton-polished roots of the same
    polynomial) on at least 99% of the pixels. On dingdong it misses on 20
    of the 3072, all on the cubic near its double roots, by up to 1.7e-3;
    there the port's t is mostly the closer root in f64 (a Newton step of
    1e-8 to 1e-6 of t, against 1e-4 to 1e-2 for the pipeline's t).

    The occlusion bits must equal in_shadow on at least 99.5% of the
    (pixel, light) pairs where both hit the same object and the Lambert
    factor exceeds 0.05. Below that, at the terminator, the shadow ray
    leaves nearly tangent to dingdong's cubic and the kernel's residual
    test accepts a near-double root: the port sets the bit on 158 of the
    2964 lit pairs (all with a factor below 0.04), the Pallas kernel on 116
    (measured once in interpret mode), the pipeline on none. Such a light
    adds at most 0.04/pi of its colour."""
    jscene = dataclasses.replace(trt.load_from_file(scene_path(name)), width=64,
                                 height=48)
    hit_x, idx_x, t_x, shadow_x, lam = _xla_stage0(jscene)

    tscene = to_torch(jscene)
    cam = camera_from_arrays(np.zeros(3, np.float32), np.float32(90.0), np.float32(0.0),
                             "cpu")
    tables, kw = kernel_backend.pack_frame(tscene, cam, 0, 48, shadow_iters=3)
    _image, aux_t, aux_slot, aux_occ = render_fwd(*tables, **kw, save_aux=True)
    assert aux_t.shape == (1, 48, 64) and aux_slot.dtype == torch.int32
    t, slot, occ = aux_t[0].numpy(), aux_slot[0].numpy(), aux_occ[0].numpy()
    perm = np.asarray(kernel_backend._statics_for(tscene.coefs)[0])

    hit = slot >= 0
    assert (t[~hit] == 0).all()
    both = hit & hit_x
    same_obj = np.where(both, perm[np.maximum(slot, 0)] == idx_x, True)
    t_close = np.where(both, np.abs(t - t_x) <= 1e-4 * np.abs(t_x), True)
    assert ((hit == hit_x) & same_obj).mean() >= 0.995
    assert t_close.mean() >= 0.99, t_close.mean()
    assert both.mean() > 0.1  # enough hits that the check is not vacuous

    # a light facing away has no defined bit (render_fwd docstring)
    bits = (occ[..., None] >> np.arange(jscene.n_lights)) & 1
    mask = (both & same_obj)[..., None] & (lam > 0.05)
    assert mask.sum() > 0
    if name == "20spheres":  # shadowed and lit pixels both present
        assert shadow_x[mask].mean() > 0.05 and not shadow_x[mask].all()
    assert (bits[mask] == shadow_x[mask]).mean() >= 0.995
